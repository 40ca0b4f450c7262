"""Fused centralized edge MLP of the depth-2 train branch, forward and
backward (CUDA kernels + plain versions).

``edge_delta_mlp(y, a0, b0, w1, z0, idx)``: ``y [B, N, C0]`` (read as
bf16), ``a0, b0 [C0]`` f32, ``w1 [C0, C1]``, ``z0 [C1]``, ``idx [B, N,
K]`` -> ``y1 [B, K, N, C1]`` bf16, K-major. For every slot ``k >= 1``

    y0 = f32(y[idx_k]) - f32(y[n])
    h  = bf16(LeakyReLU(y0 * a0 + b0))          (each operation rounded)
    y1 = bf16(h @ bf16(w1))                     (f32 sums)

and slot 0 (the kNN self loop, the zero edge) is ``bf16(z0)``, which the
caller computes as ``bf16(LeakyReLU(b0)) @ w1``. The layer before it
(``y = x @ W0`` per point) commutes through the edge difference, and the
BatchNorm of that layer is the affine ``(a0, b0)``, so only ``y1``
exists per edge. Indices outside ``[0, N)`` are read as JAX's indexing
reads them: a negative one counts from the end, and what is still
outside is clamped.

Differentiable in ``y``, ``a0``, ``b0``, ``w1`` and ``z0`` (an autograd
Function, the JAX ``custom_vjp``), with the JAX VJP's rounding points:
the cotangent of slots ``k >= 1`` is bf16 (``g1``), ``dh = g1 @
bf16(w1)^T`` in f32, ``dpre = dh * LeakyReLU'(pre)``, ``dy0 = dpre *
a0``; ``dy`` gathers ``bf16(dy0)`` into the neighbour rows and subtracts
the unrounded sum of ``dy0`` over the slots from each point's own row,
and is returned in ``y``'s dtype; ``dw1 = h^T g1`` with f32 sums;
``da0 = sum dpre * y0`` and ``db0 = sum dpre`` in f32; ``dz0`` is the f32
sum of slot 0's cotangent.

Counterpart of ``deltaconv_tpu/ops/edge_mlp.py`` (``_reference`` and
``_reference_bwd`` are the plain versions' models); the kernels are
``csrc/edge_mlp.cu``. The TPU forward also writes the f32 ``y0`` of
every edge (the stash) so that its backward needs no second one-hot
gather; here the backward gathers the bf16 rows of ``y`` again and
recomputes ``y0`` bit for bit, which measured faster on the card than a
stash (PERF.md, section 6). The backward's ``dy`` is the exact sum of
its addends (``bf16(dy0)`` at the neighbour rows, ``-dy0`` at the point's
own) rounded once to f32: the kernel adds them in f64 (atomics into a
scratch accumulator, which it rounds at the end) and the plain version
sums in f64 too, so two calls give the same bits, and so do the kernel
and the plain version where their ``dy0`` agree (the f32 sums of ``dh``
run in another order); ``dw1`` and the affine's sums come from per-block
partials added in a fixed order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _lib
from .gather_max import _bwd_buffers, _pad_last

__all__ = ["edge_delta_mlp", "edge_delta_mlp_plain", "edge_mlp_bwd",
           "edge_mlp_bwd_plain", "edge_mlp_fwd", "edge_mlp_fwd_plain"]

# Backward grid: blocks that walk the 16-point tiles, two an SM of the
# H100's 132. A fixed count keeps the partial sums of dw1 and the affine
# (one row a block) in a fixed order whatever the card.
_BWD_BLOCKS = 264
# Widths the kernels' shared memory holds (the backward's eight warps
# keep four 16-row tiles each beside W1): padded C0 and C1 up to 128.
_MAX_WIDTH = 128


def _leaky(x):
    return torch.where(x >= 0, x, 0.2 * x)


def _rows(idx, n):
    """``idx`` as JAX's indexing reads it: negative counts from the end,
    then clamped to ``[0, n)``; int64."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _edges(y, a0, b0, idx):
    """``y0`` and ``pre = y0 * a0 + b0`` of every slot, ``[B, N, K,
    C0]`` f32."""
    b, n, c = y.shape
    k = idx.shape[-1]
    yb = y.to(torch.bfloat16)
    flat = _rows(idx, n).reshape(b, n * k, 1).expand(b, n * k, c)
    yj = torch.gather(yb, 1, flat).reshape(b, n, k, c)
    y0 = yj.float() - yb.float()[:, :, None, :]
    return y0, y0 * a0.float() + b0.float()


def edge_mlp_fwd_plain(y, a0, b0, w1, z0, idx):
    """Plain forward: the ``[B, N, K, C0]`` edges, their LeakyReLU
    rounded to bf16, an f32 matmul with the bf16 weight (exact products),
    rounded to bf16; slot 0 set to ``bf16(z0)``; K-major."""
    _, pre = _edges(y, a0, b0, idx)
    h = _leaky(pre[:, :, 1:]).to(torch.bfloat16).float()
    y1 = torch.matmul(h, w1.to(torch.bfloat16).float()).to(torch.bfloat16)
    b, n = y.shape[:2]
    slot0 = z0.to(torch.bfloat16).expand(b, n, 1, -1)
    return torch.cat([slot0, y1], dim=2).permute(0, 2, 1, 3).contiguous()


def edge_mlp_bwd_plain(y, a0, b0, w1, idx, g):
    """Plain backward of slots ``k >= 1``: ``(dy [B, N, C0] f32, dw1 [C0,
    C1] f32, dab [2, C0] f32)`` with ``dab = (da0, db0)``; ``dy`` summed
    in f64 and rounded once, as the kernel does."""
    b, n, c0 = y.shape
    k = idx.shape[-1]
    y0, pre = _edges(y, a0, b0, idx)
    y0, pre = y0[:, :, 1:], pre[:, :, 1:]
    h = _leaky(pre).to(torch.bfloat16).float()
    g1 = g[:, 1:].to(torch.bfloat16).float().permute(0, 2, 1, 3)
    dh = torch.matmul(g1, w1.to(torch.bfloat16).float().t())
    dpre = dh * torch.where(pre >= 0, 1.0, 0.2)
    dy0f = dpre * a0.float()
    dy0 = dy0f.to(torch.bfloat16).float()
    flat = _rows(idx[:, :, 1:], n).reshape(b, n * (k - 1), 1).expand(
        b, n * (k - 1), c0)
    acc = torch.zeros((b, n, c0), dtype=torch.float64, device=y.device)
    acc.scatter_add_(1, flat, dy0.double().reshape(b, n * (k - 1), c0))
    dy = (acc - dy0f.double().sum(dim=2)).float()
    dw1 = torch.matmul(h.reshape(-1, c0).t(), g1.reshape(-1, g1.shape[-1]))
    dab = torch.stack([(dpre * y0).sum(dim=(0, 1, 2)),
                       dpre.sum(dim=(0, 1, 2))])
    return dy, dw1, dab


def _check(name, y, ab, w1, idx, extra):
    b, n, c0 = y.shape
    k = idx.shape[-1]
    c1 = w1.shape[-1]
    if k < 1:
        raise ValueError(f"{name}: K={k}, the self slot needs K >= 1")
    if max(c0, c1) > _MAX_WIDTH:
        raise ValueError(f"{name}: widths {c0} -> {c1}; the kernel holds "
                         f"at most {_MAX_WIDTH} channels in shared memory")
    return _lib.check_inputs(name, [
        ("y", y, torch.bfloat16, (b, n, c0)),
        ("ab", ab, torch.float32, (2, c0)),
        ("w1", w1, torch.bfloat16, (c0, c1)),
        ("idx", idx, torch.int32, (b, n, k)),
        *extra,
    ])


def _operands(y, a0, b0, w1):
    """``y``, ``[a0, b0]`` and ``w1`` as the kernels take them: bf16 and
    f32, every width zero-padded to a multiple of 16 (a zero channel has
    ``y0 = 0``, ``pre = 0`` and ``h = 0``, and a zero column of ``w1``
    adds nothing)."""
    yp = _pad_last(y.to(torch.bfloat16), 16).contiguous()
    ab = _pad_last(torch.stack([a0, b0]).float(), 16).contiguous()
    w = _pad_last(w1.to(torch.bfloat16), 16)
    wp = _pad_last(w.t(), 16).t().contiguous()
    return yp, ab, wp


def edge_mlp_fwd(y, a0, b0, w1, z0, idx):
    """``y1 [B, K, N, C1]`` bf16: plain version for CPU tensors, the
    ``edge_delta_mlp`` kernel for CUDA tensors."""
    if y.device.type == "cpu":
        return edge_mlp_fwd_plain(y, a0, b0, w1, z0, idx)
    b, n, _ = y.shape
    k = idx.shape[-1]
    c1 = w1.shape[-1]
    yp, ab, wp = _operands(y, a0, b0, w1)
    z0p = _pad_last(z0.float(), 16).contiguous()
    c1p = wp.shape[1]
    device = _check("edge_delta_mlp", yp, ab, wp, idx,
                    [("z0", z0p, torch.float32, (c1p,))])
    out = torch.empty((b, k, n, c1p), dtype=torch.bfloat16, device=device)
    _lib.launch("edge_delta_mlp", device, yp.data_ptr(), idx.data_ptr(),
                ab.data_ptr(), wp.data_ptr(), z0p.data_ptr(),
                out.data_ptr(), b, n, k, wp.shape[0], c1p)
    if c1p != c1:
        out = out[..., :c1].contiguous()
    return out


def edge_mlp_bwd(y, a0, b0, w1, idx, g):
    """``(dy [B, N, C0] f32, dw1 [C0, C1] f32, dab [2, C0] f32)`` from the
    bf16 cotangent ``g [B, K, N, C1]`` (slot 0 is not read): plain version
    for CPU tensors, the ``edge_delta_mlp_bwd`` kernel for CUDA tensors,
    which gathers the rows of ``y`` again."""
    if y.device.type == "cpu":
        return edge_mlp_bwd_plain(y, a0, b0, w1, idx, g)
    b, n, c0 = y.shape
    k = idx.shape[-1]
    c1 = w1.shape[-1]
    yp, ab, wp = _operands(y, a0, b0, w1)
    c0p, c1p = wp.shape
    gp = _pad_last(g.to(torch.bfloat16), 16).contiguous()
    device = _check("edge_delta_mlp_bwd", yp, ab, wp, idx,
                    [("g", gp, torch.bfloat16, (b, k, n, c1p))])
    blocks = min(_BWD_BLOCKS, b * -(-n // 16))
    dy, acc = _bwd_buffers(b, n, c0p, device)
    dw1_part = torch.empty((blocks, c0p, c1p), dtype=torch.float32,
                           device=device)
    dab_part = torch.empty((blocks, 2, c0p), dtype=torch.float32,
                           device=device)
    _lib.launch("edge_delta_mlp_bwd", device, yp.data_ptr(), idx.data_ptr(),
                ab.data_ptr(), wp.data_ptr(), gp.data_ptr(), dy.data_ptr(),
                acc.data_ptr(), dw1_part.data_ptr(), dab_part.data_ptr(), b,
                n, k, c0p, c1p, blocks)
    dw1 = dw1_part.sum(dim=0)[:c0, :c1]
    dab = dab_part.sum(dim=0)[:, :c0]
    return dy[..., :c0], dw1, dab


class _Route(NamedTuple):
    fwd: Callable
    bwd: Callable


_KERNELS = _Route(edge_mlp_fwd, edge_mlp_bwd)
_PLAIN = _Route(edge_mlp_fwd_plain, edge_mlp_bwd_plain)


class _EdgeDeltaMlp(torch.autograd.Function):
    """The edge MLP with the JAX VJP (module docstring); the raw
    functions get detached tensors."""

    @staticmethod
    def forward(ctx, y, a0, b0, w1, z0, idx, route):
        y, a0, b0, w1 = (t.detach() for t in (y, a0, b0, w1))
        ctx.save_for_backward(y, a0, b0, w1, idx)
        ctx.route, ctx.dtypes = route, (y.dtype, w1.dtype)
        return route.fwd(y, a0, b0, w1, z0.detach(), idx)

    @staticmethod
    def backward(ctx, g):
        y, a0, b0, w1, idx = ctx.saved_tensors
        dy, dw1, dab = ctx.route.bwd(y, a0, b0, w1, idx,
                                     g.to(torch.bfloat16).contiguous())
        dz0 = g[:, 0].float().sum(dim=(0, 1))
        return (dy.to(ctx.dtypes[0]), dab[0], dab[1], dw1.to(ctx.dtypes[1]),
                dz0, None, None)


def edge_delta_mlp(y, a0, b0, w1, z0, idx):
    """The differentiable edge MLP through the kernels on CUDA tensors
    (the plain versions on CPU ones)."""
    return _EdgeDeltaMlp.apply(y, a0, b0, w1, z0, idx, _KERNELS)


def edge_delta_mlp_plain(y, a0, b0, w1, z0, idx):
    """:func:`edge_delta_mlp` through the plain versions on any device."""
    return _EdgeDeltaMlp.apply(y, a0, b0, w1, z0, idx, _PLAIN)
