"""Dense form of the grad/div operators (counterpart of
``deltaconv_tpu/geometry/dense.py``, f32 or bf16, ``scale=None``).

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

The bf16 applies are differentiable in the features (the operators take
no gradient), with the JAX VJP's rounding: the cotangent of the f32
product is the cotangent of the cast, a bf16 value; it is contracted
with the transposed bf16 operator, f32 accumulation and result, and the
result is cast to the bf16 input's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .grad_div import GradDiv
from .nbr_ops import NeighborAggregations

__all__ = ["DenseGradDiv", "densify"]


def _bmm_f32(a, b):
    """``a @ b`` of two bf16 batches, f32 accumulation and result."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _Bf16Apply(torch.autograd.Function):
    """``w @ x`` of a bf16 operator and bf16 features with an f32 result;
    the backward gives ``x`` the product of ``w^T`` and the cotangent
    rounded to bf16 (exact: it is the cotangent of a cast from bf16),
    cast to bf16."""

    @staticmethod
    def forward(ctx, w, x):
        ctx.save_for_backward(w)
        return _bmm_f32(w, x)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        dx = _bmm_f32(w.transpose(1, 2), g.to(w.dtype)).to(w.dtype)
        return None, dx


def _bf16_product(w, x):
    """``w [B, M, N] @ x [B, N, C]`` for bf16 ``w``: ``x`` rounded to
    bf16, f32 accumulation, f32 result; differentiable in ``x``."""
    return _Bf16Apply.apply(w, x.to(w.dtype))


@dataclass(frozen=True)
class DenseGradDiv(NeighborAggregations):
    """Dense grad/div operators plus the neighbour lists (for the
    scalar-stream max aggregations and the train-mode edge sums, which
    stay gathers) and the ``ops`` (kernels or plain versions) they go
    through."""

    nbr_idx: torch.Tensor  # [B, N, K] int32
    nbr_mask: torch.Tensor  # [B, N, K] bool
    w_grad: torch.Tensor  # [B, 2, N, N] f32 or bf16
    w_div: torch.Tensor  # [B, 2, N, N] f32 or bf16
    ops: object  # ops.Ops

    def grad(self, x):
        """``[B, N, C] -> [B, N, 2, C]`` via one batched matmul."""
        if self.w_grad.dtype == torch.float32:
            out = torch.matmul(self.w_grad, x[:, None].float())
            return out.transpose(1, 2).to(x.dtype)  # [B, N, 2, C]
        b, n = x.shape[:2]
        out = _bf16_product(self.w_grad.flatten(1, 2), x)  # [B, 2N, C]
        return out.view(b, 2, n, -1).transpose(1, 2).to(x.dtype)

    def div(self, v):
        """``[B, N, 2, C] -> [B, N, C]`` as two component matmuls."""
        w = self.w_div
        if w.dtype == torch.float32:
            vf = v.float()
            out = (torch.matmul(w[:, 0], vf[:, :, 0])
                   + torch.matmul(w[:, 1], vf[:, :, 1]))
        else:
            out = (_bf16_product(w[:, 0], v[:, :, 0])
                   + _bf16_product(w[:, 1], v[:, :, 1]))
        return out.to(v.dtype)


def densify(gd: GradDiv, ops, dtype=None) -> DenseGradDiv:
    """Materializes a batched :class:`GradDiv` into its dense form in
    ``dtype`` (f32 when None, or bf16). ``ops`` (``ops.Ops``) selects
    the kernels or their plain versions, for the assembly and for every
    later aggregation. Unlike the JAX package (Pallas only at N >= 512
    on the TPU), the kernel runs at every N."""
    w_grad, w_div = ops.densify_coefs(gd.nbr_idx, gd.grad_coef, gd.div_coef,
                                      dtype)
    return DenseGradDiv(nbr_idx=gd.nbr_idx, nbr_mask=gd.nbr_mask,
                        w_grad=w_grad, w_div=w_div, ops=ops)
