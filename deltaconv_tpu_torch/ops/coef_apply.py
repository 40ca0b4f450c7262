"""Coefficient-form operator applies, the large-cloud path (CUDA kernels +
plain versions).

``coef_apply_grad(x, coef, idx)``: ``[B, N, C], [B, N, K, 2], [B, N, K]
-> [B, N, 2, C]`` with ``y[n, d, c] = sum_k coef[n, k, d] *
x[idx[n, k], c]``; ``coef_apply_div(v, coef, idx)``: ``[B, N, 2, C] ->
[B, N, C]`` with ``y[n, c] = sum_k sum_d coef[n, k, d] * v[idx[n, k], d,
c]``. Features f32 or bf16, coefficients f32; the result in the
features' dtype. The products and sums are f32, each rounded on its own,
slot by slot in order (div: component 0's product, then component 1's),
cast once at the end, as the JAX TPU kernel computes them; kernel and
plain version are bit-equal. Masked edges carry zero coefficients, so
no mask is read. Counterpart of ``deltaconv_tpu/ops/coef_apply.py``; the
kernels are ``csrc/coef_apply.cu``.

Differentiated, each apply is an autograd Function with the JAX VJP:
the features' cotangent forms the f32 edge rows edge-major, channels
fastest (``einsum`` into ``[B, N, K, C]``; for div ``[B, N, K, 2, C]``,
viewed as ``[B, N, K, 2C]``, the flattened rows of ``v``), and hands
their ``[B, C, K, N]`` view to :func:`~.gather_rows.scatter_rows`, which
reads it through its strides (no layout copy), cast to the features'
dtype; the coefficients' cotangent (``gather_rows`` +
``einsum``, f32) is formed only when asked for. No backward kernel runs
for an input that does not require grad. :func:`coef_apply_grad` and
:func:`coef_apply_div` run the kernels (forward and backward),
``*_plain`` the plain versions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _lib
from .gather_rows import (gather_rows, gather_rows_plain, scatter_rows,
                          scatter_rows_plain)

__all__ = ["coef_apply_div", "coef_apply_div_plain", "coef_apply_grad",
           "coef_apply_grad_plain"]

_FEATURES = (torch.float32, torch.bfloat16)


def _slot_rows(t, idx, k):
    """Rows ``t[b, idx[b, n, k]]`` of ``t [B, N, ...]``, in f32."""
    b, n = idx.shape[:2]
    flat = t.reshape(b, n, -1).float()
    index = idx[:, :, k, None].long().expand(b, n, flat.shape[-1])
    return torch.gather(flat, 1, index).reshape(t.shape)


def _grad_plain(x, coef, idx):
    acc0 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    acc1 = torch.zeros_like(acc0)
    for k in range(idx.shape[-1]):
        xk = _slot_rows(x, idx, k)
        acc0 = acc0 + xk * coef[:, :, k, 0, None]
        acc1 = acc1 + xk * coef[:, :, k, 1, None]
    return torch.stack([acc0, acc1], dim=2).to(x.dtype)


def _div_plain(v, coef, idx):
    acc = torch.zeros(v[:, :, 0].shape, dtype=torch.float32, device=v.device)
    for k in range(idx.shape[-1]):
        vk = _slot_rows(v, idx, k)
        acc = acc + vk[:, :, 0] * coef[:, :, k, 0, None]
        acc = acc + vk[:, :, 1] * coef[:, :, k, 1, None]
    return acc.to(v.dtype)


def _launch_apply(name, feat, coef, idx, out_shape):
    b, n = feat.shape[:2]
    c = feat.shape[-1]
    k = idx.shape[-1]
    if feat.dtype not in _FEATURES:
        raise TypeError(f"{name}(features): dtype {feat.dtype}, expected "
                        "torch.float32 or torch.bfloat16")
    device = _lib.check_inputs(name, [
        ("features", feat, feat.dtype, tuple(feat.shape)),
        ("coef", coef, torch.float32, (b, n, k, 2)),
        ("idx", idx, torch.int32, (b, n, k)),
    ])
    out = torch.empty(out_shape, dtype=feat.dtype, device=device)
    _lib.launch(name, device, feat.data_ptr(), coef.data_ptr(),
                idx.data_ptr(), out.data_ptr(), b, n, c, k,
                int(feat.dtype == torch.bfloat16))
    return out


def _grad_kernel(x, coef, idx):
    if x.device.type == "cpu":
        return _grad_plain(x, coef, idx)
    b, n, c = x.shape
    return _launch_apply("coef_apply_grad", x, coef, idx, (b, n, 2, c))


def _div_kernel(v, coef, idx):
    if v.device.type == "cpu":
        return _div_plain(v, coef, idx)
    if v.dim() != 4 or v.shape[2] != 2:
        raise ValueError(f"coef_apply_div(v): shape {tuple(v.shape)}, "
                         "expected [B, N, 2, C]")
    b, n, _, c = v.shape
    return _launch_apply("coef_apply_div", v, coef, idx, (b, n, c))


class _Route(NamedTuple):
    grad: Callable
    div: Callable
    gather_rows: Callable
    scatter_rows: Callable


_KERNELS = _Route(_grad_kernel, _div_kernel, gather_rows, scatter_rows)
_PLAIN = _Route(_grad_plain, _div_plain, gather_rows_plain,
                scatter_rows_plain)


class _CoefApplyGrad(torch.autograd.Function):
    """``coef_apply_grad`` with the JAX VJP (``_cag_bwd``)."""

    @staticmethod
    def forward(ctx, x, coef, idx, route):
        x, coef = x.detach(), coef.detach()
        ctx.save_for_backward(x, coef, idx)
        ctx.route = route
        return route.grad(x, coef, idx)

    @staticmethod
    def backward(ctx, ct):
        x, coef, idx = ctx.saved_tensors
        ctf = ct.float()
        dx = dc = None
        if ctx.needs_input_grad[0]:
            # dx[m, c] = sum over edges (n, k) with idx == m of
            #            sum_d coef[n, k, d] * ct[n, d, c]
            edge = torch.einsum("bnkd,bndc->bnkc", coef, ctf)
            dx = ctx.route.scatter_rows(edge.permute(0, 3, 2, 1), idx,
                                        x.shape[1]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # dcoef[n, k, d] = sum_c x[idx[n, k], c] * ct[n, d, c]
            xg = ctx.route.gather_rows(x.float().contiguous(), idx)
            dc = torch.einsum("bckn,bndc->bnkd", xg, ctf)
        return dx, dc, None, None


class _CoefApplyDiv(torch.autograd.Function):
    """``coef_apply_div`` with the JAX VJP (``_cad_bwd``): the cotangent
    rows are the flattened ``[2C]`` rows of ``v``'s layout."""

    @staticmethod
    def forward(ctx, v, coef, idx, route):
        v, coef = v.detach(), coef.detach()
        ctx.save_for_backward(v, coef, idx)
        ctx.route = route
        return route.div(v, coef, idx)

    @staticmethod
    def backward(ctx, ct):
        v, coef, idx = ctx.saved_tensors
        b, n, _, c = v.shape
        k = idx.shape[-1]
        ctf = ct.float()
        dv = dc = None
        if ctx.needs_input_grad[0]:
            # dv[m, d, c] = sum over edges with idx == m of
            #               coef[n, k, d] * ct[n, c]
            edge = torch.einsum("bnkd,bnc->bnkdc", coef, ctf).view(
                b, n, k, 2 * c)
            dv = ctx.route.scatter_rows(edge.permute(0, 3, 2, 1), idx,
                                        n).view(b, n, 2, c).to(v.dtype)
        if ctx.needs_input_grad[1]:
            # dcoef[n, k, d] = sum_c v[idx[n, k], d, c] * ct[n, c]
            vg = ctx.route.gather_rows(
                v.reshape(b, n, 2 * c).float().contiguous(), idx)
            dc = torch.einsum("bdckn,bnc->bnkd", vg.reshape(b, 2, c, k, n),
                              ctf)
        return dv, dc, None, None


def _differentiated(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def coef_apply_grad(x: torch.Tensor, coef: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """The gradient apply through the kernels on CUDA tensors (the plain
    versions on CPU ones); differentiable in ``x`` and ``coef``."""
    if _differentiated(x, coef):
        return _CoefApplyGrad.apply(x, coef, idx, _KERNELS)
    return _grad_kernel(x, coef, idx)


def coef_apply_grad_plain(x: torch.Tensor, coef: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """:func:`coef_apply_grad` through the plain versions on any device."""
    if _differentiated(x, coef):
        return _CoefApplyGrad.apply(x, coef, idx, _PLAIN)
    return _grad_plain(x, coef, idx)


def coef_apply_div(v: torch.Tensor, coef: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """The divergence apply through the kernels on CUDA tensors (the
    plain versions on CPU ones); differentiable in ``v`` and ``coef``."""
    if _differentiated(v, coef):
        return _CoefApplyDiv.apply(v, coef, idx, _KERNELS)
    return _div_kernel(v, coef, idx)


def coef_apply_div_plain(v: torch.Tensor, coef: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """:func:`coef_apply_div` through the plain versions on any device."""
    if _differentiated(v, coef):
        return _CoefApplyDiv.apply(v, coef, idx, _PLAIN)
    return _div_plain(v, coef, idx)
