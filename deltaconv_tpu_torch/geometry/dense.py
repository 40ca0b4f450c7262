"""Dense form of the grad/div operators (counterpart of
``deltaconv_tpu/geometry/dense.py``, f32, bf16 or int8), batched or of
one cloud (every tensor without its batch axis: the applies and the
neighbour maxes take ``[N, ...]`` features, as a batch of one).

``W_grad [B, 2, N, N]``: plane d maps scalars to the d-component;
``W_div [B, 2, N, N]``: plane d maps the d-component to scalars. Built
once per forward by the densify kernel, in f32 or bf16, after which
every operator application in the conv stack is a batched matmul
(``torch.matmul``/``torch.bmm``, as the JAX package leaves it to XLA).
Masked edges carry zero coefficients, so the dense form needs no
masking.

Dtypes follow the JAX ``einsum(..., preferred_element_type=float32)``:
the input is cast to the operators' dtype, products accumulate in f32
with an f32 result, ``div`` adds its two component products in f32, and
the result is cast to the input's dtype. A bf16 product with an f32
result is ``torch.bmm(..., out_dtype=torch.float32)`` on the card (one
rounding, as XLA); on the CPU, where that overload does not exist, the
bf16 operands are widened to f32 first, which is the same arithmetic.

The bf16 applies are differentiable in the features with the JAX VJP's
rounding: the cotangent of the f32 product is the cotangent of the
cast, a bf16 value; it is contracted with the transposed bf16 operator,
f32 accumulation and result, and the result is cast to the bf16 input's
dtype.

The int8 serving form (``densify(..., torch.int8)``, eval only) keeps
one dequantization scale a cloud and operator (``op_scale_grad``,
``op_scale_div``): ``grad``/``div`` quantize their input per cloud
(``int8_quantize``, over every axis after the batch), take exact s8 x s8
-> s32 products (``torch._int_mm``, one a cloud and operator plane, the
width zero-padded to a multiple of 8; ``div`` adds its two component
products in int32), and scale by ``op_scale * s_x`` (that product first,
then the multiply), cast to the input's dtype. The neighbour maxes run
in the quantized domain: ``nbr_max`` through ``gather_max_int8``,
``nbr_matmul_max`` through ``int8_quantize``, ``gather_matmul_max_int8``
and the dequantization, without the epilogue.

Differentiated in their coefficients (gradients for positions and
normals; int8 has none), the f32 and bf16 applies are autograd Functions
of their input and the coefficients: :func:`densify` builds ``W``
without a graph and keeps the coefficients (``grad_coef``,
``div_coef``); the forward is the same product on ``W`` (f32:
``torch.matmul``; bf16: one ``[B, 2N, N]`` product or two ``[B, N,
N]`` ones, f32 accumulation), the input's cotangent
``W^T @ ct`` as the non-differentiated applies take it, and the
coefficients' cotangent ``ops.coef_cotangent`` of the input (bf16
widened to f32, exactly) and the cotangent, a sampled product that
forms only the edges' entries: no ``[B, 2, N, N]`` cotangent is formed,
added or copied. Every apply's ``[B, N, K, 2]`` cotangent reaches the
coefficients through autograd. On bf16 operators the coefficients the
applies see are cast to bf16, so each apply's cotangent is rounded to
bf16 and the applies' are added in bf16 before the cast widens them:
the JAX package's rounding points (its transpose of the bf16 product
rounds the operator's cotangent to bf16 in each cell, and its backward
adds the applies' bf16 cotangents in bf16, before ``_densify_bwd``
gathers them).

``scale`` (``[B]`` f32, or None) is the fused eval build's deferred
per-cloud normalization (its operators are unnormalized): ``grad`` and
``div`` multiply their input by the cloud's scale in f32 and cast it
back to the input's dtype before the product, since ``(s W) x = W (s
x)``. The neighbour maxes ignore it, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.gather_max import int8_quantize
from .grad_div import GradDiv
from .nbr_ops import NeighborAggregations, one_cloud

__all__ = ["DenseGradDiv", "densify"]


class _GradApply(torch.autograd.Function):
    """``grad`` on f32 operators differentiated in the coefficients:
    ``x [B, N, C] -> [B, N, 2, C]``; the backward gives ``x`` the
    products ``W[:, d]^T @ ct[:, :, d]`` summed over ``d`` and the
    coefficients ``ops.coef_cotangent(x, ct, idx)``."""

    @staticmethod
    def forward(ctx, x, coef, w, idx, ops):
        x = x.detach()
        ctx.save_for_backward(x, w, idx)
        ctx.ops = ops
        return torch.matmul(w, x[:, None]).transpose(1, 2)

    @staticmethod
    def backward(ctx, ct):
        x, w, idx = ctx.saved_tensors
        dx = dc = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(w.transpose(2, 3), ct.transpose(1, 2)).sum(1)
        if ctx.needs_input_grad[1]:
            dc = ctx.ops.coef_cotangent(x, ct, idx)
        return dx, dc, None, None, None


class _DivApply(torch.autograd.Function):
    """``div`` on f32 operators differentiated in the coefficients:
    ``v [B, N, 2, C] -> [B, N, C]``; the backward gives ``v`` the
    products ``W[:, d]^T @ ct`` and the coefficients
    ``ops.coef_cotangent(v, ct, idx)``."""

    @staticmethod
    def forward(ctx, v, coef, w, idx, ops):
        v = v.detach()
        ctx.save_for_backward(v, w, idx)
        ctx.ops = ops
        return torch.matmul(w[:, 0], v[:, :, 0]) + torch.matmul(w[:, 1],
                                                                v[:, :, 1])

    @staticmethod
    def backward(ctx, ct):
        v, w, idx = ctx.saved_tensors
        dv = dc = None
        if ctx.needs_input_grad[0]:
            dv = torch.matmul(w.transpose(2, 3), ct[:, None]).transpose(1, 2)
        if ctx.needs_input_grad[1]:
            dc = ctx.ops.coef_cotangent(v, ct, idx)
        return dv, dc, None, None, None


def _bmm_f32(a, b):
    """``a @ b`` of two bf16 batches, f32 accumulation and result."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _Bf16GradApply(torch.autograd.Function):
    """``grad`` on bf16 operators: ``x [B, N, C]`` bf16 -> ``[B, N, 2,
    C]`` f32, one product of the flattened ``[B, 2N, N]`` operator (f32
    accumulation and result, as XLA's ``preferred_element_type``). The
    backward gives ``x`` the product of ``W^T`` and the cotangent rounded
    to bf16 (exact for the cotangent of a cast from bf16), cast to bf16,
    and, when ``coef`` (the coefficients cast to bf16, see
    :func:`densify`, or None) is differentiated, ``ops.coef_cotangent``
    of ``x`` widened to f32 (exact) and the f32 cotangent, rounded to
    bf16."""

    @staticmethod
    def forward(ctx, x, coef, w, idx, ops):
        x = x.detach()
        ctx.save_for_backward(x, w, idx)
        ctx.ops = ops
        b, n = x.shape[:2]
        return _bmm_f32(w.flatten(1, 2), x).view(b, 2, n, -1).transpose(1, 2)

    @staticmethod
    def backward(ctx, ct):
        x, w, idx = ctx.saved_tensors
        dx = dc = None
        if ctx.needs_input_grad[0]:
            g = ct.transpose(1, 2).flatten(1, 2).to(w.dtype)  # [B, 2N, C]
            dx = _bmm_f32(w.flatten(1, 2).transpose(1, 2), g).to(w.dtype)
        if ctx.needs_input_grad[1]:
            dc = ctx.ops.coef_cotangent(x.float(), ct.float(), idx).to(
                w.dtype)
        return dx, dc, None, None, None


class _Bf16DivApply(torch.autograd.Function):
    """``div`` on bf16 operators: ``v [B, N, 2, C]`` bf16 -> ``[B, N,
    C]`` f32, the two component products added in f32. The backward gives
    each component of ``v`` what :class:`_Bf16GradApply` gives ``x``,
    and a differentiated ``coef`` ``ops.coef_cotangent`` of ``v``
    widened to f32 and the f32 cotangent, rounded to bf16."""

    @staticmethod
    def forward(ctx, v, coef, w, idx, ops):
        v = v.detach()
        ctx.save_for_backward(v, w, idx)
        ctx.ops = ops
        return _bmm_f32(w[:, 0], v[:, :, 0]) + _bmm_f32(w[:, 1], v[:, :, 1])

    @staticmethod
    def backward(ctx, ct):
        v, w, idx = ctx.saved_tensors
        dv = dc = None
        if ctx.needs_input_grad[0]:
            g = ct.to(w.dtype)
            dv = torch.stack([_bmm_f32(w[:, d].transpose(1, 2), g)
                              for d in range(2)], dim=2).to(w.dtype)
        if ctx.needs_input_grad[1]:
            dc = ctx.ops.coef_cotangent(v.float(), ct.float(), idx).to(
                w.dtype)
        return dv, dc, None, None, None


def _int8_products(w, xq):
    """``w [B, M, N] @ xq [B, N, C]`` of int8 batches, exact, int32
    ``[B, M, C]``: one ``torch._int_mm`` a cloud, ``C`` zero-padded to a
    multiple of 8 (as its CUDA form needs; zero columns are exact)."""
    c = xq.shape[-1]
    xq = torch.nn.functional.pad(xq, (0, -c % 8)).contiguous()
    out = torch.empty(w.shape[:2] + xq.shape[-1:], dtype=torch.int32,
                      device=w.device)
    for i in range(w.shape[0]):
        torch._int_mm(w[i], xq[i], out=out[i])
    return out[..., :c]


@dataclass(frozen=True)
class DenseGradDiv(NeighborAggregations):
    """Dense grad/div operators plus the neighbour lists (for the
    scalar-stream max aggregations and the train-mode edge sums, which
    stay gathers) and the ``ops`` (kernels or plain versions) they go
    through; on the int8 form also the per-cloud dequantization scales
    (``W ~= W_q * op_scale``), None otherwise; on a build differentiated
    in its coefficients (f32) the coefficients, None otherwise, whose
    cotangents the applies form without one of ``W``."""

    nbr_idx: torch.Tensor  # [B, N, K] int32
    nbr_mask: torch.Tensor  # [B, N, K] bool
    w_grad: torch.Tensor  # [B, 2, N, N] f32, bf16 or int8
    w_div: torch.Tensor  # [B, 2, N, N] f32, bf16 or int8
    ops: object  # ops.Ops
    op_scale_grad: torch.Tensor = None  # [B] f32 (int8 form) or None
    op_scale_div: torch.Tensor = None  # [B] f32 (int8 form) or None
    scale: torch.Tensor = None  # [B] f32 deferred normalization, or None
    # [B, N, K, 2] with a graph (f32; bf16 on bf16 operators), or None
    grad_coef: torch.Tensor = None
    div_coef: torch.Tensor = None

    def _scaled(self, x):
        """``x * scale`` per cloud, in f32, cast back to ``x``'s dtype."""
        if self.scale is None:
            return x
        s = self.scale.view((-1,) + (1,) * (x.dim() - 1))
        return (x.float() * s).to(x.dtype)

    @property
    def int8(self) -> bool:
        """True for the int8 serving form."""
        return self.w_grad.dtype == torch.int8

    @one_cloud("h")
    def nbr_max(self, h):
        """int8 form: the masked max in the quantized domain
        (``gather_max_int8``, rows with no valid neighbour 0); otherwise
        the shared protocol's."""
        if self.int8:
            return self.ops.gather_max_int8(h, self.nbr_idx, self.nbr_mask)
        return super().nbr_max(h)

    @one_cloud("x")
    def nbr_matmul_max(self, x, w, affine=None):
        """int8 form: ``x`` quantized per cloud, the masked max of
        ``(xq @ w)[nbr]`` (``gather_matmul_max_int8``), dequantized by the
        cloud's scale and cast to ``x``'s dtype; rows with no valid
        neighbour are the caller's to mask. The int8 form takes no
        ``affine``: its epilogue runs after the max, as the JAX
        package's."""
        if not self.int8:
            return super().nbr_matmul_max(x, w, affine)
        if affine is not None:
            raise ValueError("the int8 form keeps the epilogue outside the "
                             "kernel: pass no affine")
        xq, s = int8_quantize(x)
        out = self.ops.gather_matmul_max_int8(xq, w, self.nbr_idx,
                                              self.nbr_mask)
        return (out.float() * s[:, None, None]).to(x.dtype)

    @one_cloud("x")
    def grad(self, x):
        """``[B, N, C] -> [B, N, 2, C]`` via one batched matmul (``[N, C]
        -> [N, 2, C]`` on one cloud)."""
        x = self._scaled(x)
        if self.int8:
            b, n = x.shape[:2]
            xq, sx = int8_quantize(x)
            acc = _int8_products(self.w_grad.flatten(1, 2), xq)  # [B, 2N, C]
            s = self.op_scale_grad * sx
            out = acc.float() * s[:, None, None]
            return out.view(b, 2, n, -1).transpose(1, 2).to(x.dtype)
        if self.w_grad.dtype == torch.bfloat16:
            return _Bf16GradApply.apply(
                x.to(torch.bfloat16), self.grad_coef, self.w_grad,
                self.nbr_idx, self.ops).to(x.dtype)
        if _differentiated(self.grad_coef):
            return _GradApply.apply(x, self.grad_coef, self.w_grad,
                                    self.nbr_idx, self.ops)
        out = torch.matmul(self.w_grad, x[:, None].float())
        return out.transpose(1, 2).to(x.dtype)  # [B, N, 2, C]

    @one_cloud("v")
    def div(self, v):
        """``[B, N, 2, C] -> [B, N, C]`` as two component matmuls
        (``[N, 2, C] -> [N, C]`` on one cloud)."""
        v = self._scaled(v)
        w = self.w_div
        if self.int8:
            vq, sv = int8_quantize(v)
            vq = vq.transpose(1, 2)  # [B, 2, N, C]
            acc = (_int8_products(w[:, 0], vq[:, 0])
                   + _int8_products(w[:, 1], vq[:, 1]))
            s = self.op_scale_div * sv
            return (acc.float() * s[:, None, None]).to(v.dtype)
        if w.dtype == torch.bfloat16:
            return _Bf16DivApply.apply(v.to(torch.bfloat16), self.div_coef,
                                       w, self.nbr_idx, self.ops).to(v.dtype)
        if _differentiated(self.div_coef):
            return _DivApply.apply(v, self.div_coef, w, self.nbr_idx,
                                   self.ops)
        vf = v.float()
        out = (torch.matmul(w[:, 0], vf[:, :, 0])
               + torch.matmul(w[:, 1], vf[:, :, 1]))
        return out.to(v.dtype)


def densify(gd: GradDiv, ops, dtype=None) -> DenseGradDiv:
    """Materializes a batched :class:`GradDiv` into its dense form in
    ``dtype`` (f32 when None, bf16, or ``torch.int8``: the quantized
    serving form with its scales). ``ops`` (``ops.Ops``) selects the
    kernels or their plain versions, for the assembly and for every
    later aggregation. Unlike the JAX package (Pallas only at N >= 512
    on the TPU), the kernel runs at every N."""
    if dtype == torch.int8:
        w_grad, w_div, s_grad, s_div = ops.densify_coefs_int8(
            gd.nbr_idx, gd.grad_coef, gd.div_coef)
        return DenseGradDiv(nbr_idx=gd.nbr_idx, nbr_mask=gd.nbr_mask,
                            w_grad=w_grad, w_div=w_div, ops=ops,
                            op_scale_grad=s_grad, op_scale_div=s_div)
    if _differentiated(gd.grad_coef, gd.div_coef):
        # The applies differentiate the coefficients themselves (the
        # sampled product); W carries no graph. On bf16 operators they
        # differentiate the coefficients cast to bf16, as the JAX
        # package's transpose of the bf16 product rounds each apply's
        # operator cotangent to W's dtype and adds the applies' in bf16:
        # autograd rounds each apply's cotangent to the cast's dtype,
        # adds them in it, and the cast's backward widens the sum.
        w_grad, w_div = ops.densify_coefs(gd.nbr_idx, gd.grad_coef.detach(),
                                          gd.div_coef.detach(), dtype)
        coefs = (gd.grad_coef, gd.div_coef)
        if dtype == torch.bfloat16:
            coefs = tuple(c.to(dtype) for c in coefs)
        return DenseGradDiv(nbr_idx=gd.nbr_idx, nbr_mask=gd.nbr_mask,
                            w_grad=w_grad, w_div=w_div, ops=ops,
                            grad_coef=coefs[0], div_coef=coefs[1])
    w_grad, w_div = ops.densify_coefs(gd.nbr_idx, gd.grad_coef, gd.div_coef,
                                      dtype)
    return DenseGradDiv(nbr_idx=gd.nbr_idx, nbr_mask=gd.nbr_mask,
                        w_grad=w_grad, w_div=w_div, ops=ops)


def _differentiated(*coefs) -> bool:
    return torch.is_grad_enabled() and any(
        c is not None and c.requires_grad for c in coefs)
