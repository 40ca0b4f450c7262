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
stash (PERF.md, section 6).

On the card both directions are streams of bytes (the forward writes
``y1``, 126 MB at the segmentation shape; the backward reads ``g`` as
large), so the kernels keep gathers in flight by ``cp.async`` rings and
do every product on the tensor cores (``mma.sync``) with the operands
built in registers. The backward runs in two phases and no float
atomics:

- :func:`edge_mlp_bwd_edges` (kernel ``edge_delta_mlp_bwd``): source-major,
  a tile of 16 points and one slot at a time. It writes ``bf16(dy0)`` of
  every edge into the K-major edge tensor ``e [B, K, N, C0]`` (slot 0
  unused), each point's self term ``sum_k dy0`` as an f64 sum in slot
  order into ``self [B, N, C0]`` f64, and ``dw1`` and ``(da0, db0)`` as
  per-block partials that the wrapper adds in a fixed order.
- :func:`edge_mlp_bwd_sum` (kernel ``edge_delta_mlp_bwd_sum``):
  destination-major over the inverse adjacency of the clamped indices
  (``inverse_adjacency(idx, N, clamp=True)``: each row's edges ``n K +
  k``, ascending): a row starts from ``0 - self`` and adds, in f64, the
  ``e`` rows of its edges with ``k != 0`` in list order, then rounds once
  to f32.

``dy`` is so the exact sum of its addends (``bf16(dy0)`` at the neighbour
rows, ``-dy0`` at the point's own) rounded once to f32 (f64 holds the sum
of one row's addends exactly unless they span more than ~29 binary
orders): two calls give the same bits, and so do the kernels and the plain
versions where their ``dy0`` agree (the f32 sums of ``dh`` run in another
order). The two plain phases compose to :func:`edge_mlp_bwd_plain`, the
backward's model, bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _lib
from .gather_rows import inverse_adjacency, inverse_adjacency_plain

__all__ = ["edge_delta_mlp", "edge_delta_mlp_plain", "edge_mlp_bwd",
           "edge_mlp_bwd_edges", "edge_mlp_bwd_edges_plain",
           "edge_mlp_bwd_plain", "edge_mlp_bwd_sum", "edge_mlp_bwd_sum_plain",
           "edge_mlp_fwd", "edge_mlp_fwd_plain"]

# Backward phase 1's grid: blocks of groups of warps that walk the 16-point
# tiles (4 groups a block at C0 = C1 = 64: 512 walks of 4 tiles each at the
# segmentation shape's 2048 tiles), one block an SM. A fixed count keeps
# the partial sums of dw1 and the affine (one row a block) in a fixed order
# whatever the card.
_BWD_BLOCKS = 128
# The kernels' widths: C0 and C1 are zero-padded to the next of these (a
# zero channel has y0 = 0, pre = 0 and h = 0, and a zero column of w1 adds
# nothing).
_WIDTHS = (16, 32, 64, 128)
_MAX_WIDTH = _WIDTHS[-1]


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


def _bwd_terms(y, a0, b0, w1, idx, g):
    """``y0``, ``dpre`` and the unrounded ``dy0`` of slots ``k >= 1``
    (``[B, N, K - 1, C0]`` f32), their ``h`` and the bf16 cotangent ``g1``
    (``[B, N, K - 1, C1]``, as f32)."""
    y0, pre = _edges(y, a0, b0, idx)
    y0, pre = y0[:, :, 1:], pre[:, :, 1:]
    h = _leaky(pre).to(torch.bfloat16).float()
    g1 = g[:, 1:].to(torch.bfloat16).float().permute(0, 2, 1, 3)
    dh = torch.matmul(g1, w1.to(torch.bfloat16).float().t())
    dpre = dh * torch.where(pre >= 0, 1.0, 0.2)
    return y0, dpre, dpre * a0.float(), h, g1


def _weight_grads(y0, dpre, h, g1):
    """``dw1 = h^T g1`` and ``(da0, db0)``, f32 sums."""
    dw1 = torch.matmul(h.reshape(-1, h.shape[-1]).t(),
                       g1.reshape(-1, g1.shape[-1]))
    dab = torch.stack([(dpre * y0).sum(dim=(0, 1, 2)),
                       dpre.sum(dim=(0, 1, 2))])
    return dw1, dab


def edge_mlp_bwd_plain(y, a0, b0, w1, idx, g):
    """Plain backward of slots ``k >= 1``: ``(dy [B, N, C0] f32, dw1 [C0,
    C1] f32, dab [2, C0] f32)`` with ``dab = (da0, db0)``; ``dy`` summed
    in f64 and rounded once, as the kernels do."""
    b, n, c0 = y.shape
    k = idx.shape[-1]
    y0, dpre, dy0f, h, g1 = _bwd_terms(y, a0, b0, w1, idx, g)
    dy0 = dy0f.to(torch.bfloat16).float()
    flat = _rows(idx[:, :, 1:], n).reshape(b, n * (k - 1), 1).expand(
        b, n * (k - 1), c0)
    acc = torch.zeros((b, n, c0), dtype=torch.float64, device=y.device)
    acc.scatter_add_(1, flat, dy0.double().reshape(b, n * (k - 1), c0))
    dy = (acc - dy0f.double().sum(dim=2)).float()
    return (dy, *_weight_grads(y0, dpre, h, g1))


def edge_mlp_bwd_edges_plain(y, a0, b0, w1, idx, g):
    """Plain phase 1 of the backward: ``(e [B, K, N, C0] bf16, self [B,
    N, C0] f64, dw1, dab)``: ``e[:, k]`` the ``bf16(dy0)`` of slot ``k >=
    1`` (slot 0 zero, unused), ``self`` each point's ``sum_k dy0``."""
    b, n, c0 = y.shape
    y0, dpre, dy0f, h, g1 = _bwd_terms(y, a0, b0, w1, idx, g)
    e = torch.zeros((b, idx.shape[-1], n, c0), dtype=torch.bfloat16,
                    device=y.device)
    e[:, 1:] = dy0f.to(torch.bfloat16).permute(0, 2, 1, 3)
    return (e, dy0f.double().sum(dim=2), *_weight_grads(y0, dpre, h, g1))


def edge_mlp_bwd_sum_plain(e, self_sum, idx):
    """Plain phase 2: ``dy [B, N, C0]`` f32, each row ``0 - self`` plus
    the ``e`` rows of the edges that :func:`inverse_adjacency_plain` lists
    under it (the clamped indices), slot 0 skipped, in f64, rounded
    once."""
    b, k, n, c0 = e.shape
    offsets, edges = inverse_adjacency_plain(idx, n, clamp=True)
    edges = edges.long()
    pos = torch.arange(n * k, device=e.device).expand(b, -1).contiguous()
    row = torch.searchsorted(offsets[:, 1:].contiguous(), pos.int(),
                             right=True)
    keep = (edges >= 0) & (edges % k != 0)
    rows = e.permute(0, 2, 1, 3).reshape(b, n * k, c0)
    vals = torch.gather(rows, 1, edges.clamp(min=0)[..., None].expand(
        -1, -1, c0)).double()
    acc = torch.zeros((b, n, c0), dtype=torch.float64,
                      device=e.device) - self_sum
    acc.scatter_add_(1, torch.where(keep, row, 0)[..., None].expand(
        -1, -1, c0), torch.where(keep[..., None], vals, 0.0))
    return acc.float()


def _check(name, y, ab, w1, idx, extra):
    b, n, c0 = y.shape
    k = idx.shape[-1]
    c1 = w1.shape[-1]
    if k < 1:
        raise ValueError(f"{name}: K={k}, the self slot needs K >= 1")
    if max(c0, c1) > _MAX_WIDTH:
        raise ValueError(f"{name}: widths {c0} -> {c1}; the kernel holds "
                         f"at most {_MAX_WIDTH} channels")
    return _lib.check_inputs(name, [
        ("y", y, torch.bfloat16, (b, n, c0)),
        ("ab", ab, torch.float32, (2, c0)),
        ("w1", w1, torch.bfloat16, (c0, c1)),
        ("idx", idx, torch.int32, (b, n, k)),
        *extra,
    ])


def _width(c):
    """The kernels' width for ``c`` channels (``_WIDTHS``; above them
    ``c`` itself, which :func:`_check` refuses)."""
    return next((w for w in _WIDTHS if w >= c), c)


def _pad_to(t, width):
    pad = width - t.shape[-1]
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _operands(y, a0, b0, w1):
    """``y``, ``[a0, b0]`` and ``w1`` as the kernels take them: bf16 and
    f32, every width zero-padded to one of ``_WIDTHS``."""
    c0, c1 = _width(y.shape[-1]), _width(w1.shape[-1])
    yp = _pad_to(y.to(torch.bfloat16), c0).contiguous()
    ab = _pad_to(torch.stack([a0, b0]).float(), c0).contiguous()
    w = _pad_to(w1.to(torch.bfloat16), c1)
    wp = _pad_to(w.t(), c0).t().contiguous()
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
    c1p = wp.shape[1]
    z0p = _pad_to(z0.float(), c1p).contiguous()
    device = _check("edge_delta_mlp", yp, ab, wp, idx,
                    [("z0", z0p, torch.float32, (c1p,))])
    out = torch.empty((b, k, n, c1p), dtype=torch.bfloat16, device=device)
    _lib.launch("edge_delta_mlp", device, yp.data_ptr(), idx.data_ptr(),
                ab.data_ptr(), wp.data_ptr(), z0p.data_ptr(),
                out.data_ptr(), b, n, k, wp.shape[0], c1p)
    if c1p != c1:
        out = out[..., :c1].contiguous()
    return out


def _bwd_edges_kernel(y, a0, b0, w1, idx, g):
    """Phase 1 on CUDA tensors: ``e`` and ``self`` at the kernels' width
    of C0, ``dw1`` and ``dab`` at the caller's widths."""
    b, n, c0 = y.shape
    k = idx.shape[-1]
    c1 = w1.shape[-1]
    yp, ab, wp = _operands(y, a0, b0, w1)
    c0p, c1p = wp.shape
    gp = _pad_to(g.to(torch.bfloat16), c1p).contiguous()
    device = _check("edge_delta_mlp_bwd", yp, ab, wp, idx,
                    [("g", gp, torch.bfloat16, (b, k, n, c1p))])
    blocks = max(1, min(_BWD_BLOCKS, b * -(-n // 16)))
    e = torch.empty((b, k, n, c0p), dtype=torch.bfloat16, device=device)
    self_sum = torch.empty((b, n, c0p), dtype=torch.float64, device=device)
    dw1_part = torch.empty((blocks, c0p, c1p), dtype=torch.float32,
                           device=device)
    dab_part = torch.empty((blocks, 2, c0p), dtype=torch.float32,
                           device=device)
    _lib.launch("edge_delta_mlp_bwd", device, yp.data_ptr(), idx.data_ptr(),
                ab.data_ptr(), wp.data_ptr(), gp.data_ptr(), e.data_ptr(),
                self_sum.data_ptr(), dw1_part.data_ptr(), dab_part.data_ptr(),
                b, n, k, c0p, c1p, blocks)
    return (e, self_sum, dw1_part.sum(dim=0)[:c0, :c1],
            dab_part.sum(dim=0)[:, :c0])


def _bwd_sum_kernel(e, self_sum, idx):
    """Phase 2 on CUDA tensors at the kernels' width: the inverse
    adjacency of the clamped indices, then ``edge_delta_mlp_bwd_sum``."""
    b, k, n, c0 = e.shape
    device = _lib.check_inputs("edge_delta_mlp_bwd_sum", [
        ("e", e, torch.bfloat16, (b, k, n, c0)),
        ("self_sum", self_sum, torch.float64, (b, n, c0)),
        ("idx", idx, torch.int32, (b, n, k)),
    ])
    offsets, edges = inverse_adjacency(idx, n, clamp=True)
    dy = torch.empty((b, n, c0), dtype=torch.float32, device=device)
    _lib.launch("edge_delta_mlp_bwd_sum", device, e.data_ptr(),
                self_sum.data_ptr(), offsets.data_ptr(), edges.data_ptr(),
                dy.data_ptr(), b, n, k, c0)
    return dy


def edge_mlp_bwd_edges(y, a0, b0, w1, idx, g):
    """Phase 1, ``(e, self, dw1, dab)`` as :func:`edge_mlp_bwd_edges_plain`
    (``e``'s slot 0 is not written): plain version for CPU tensors, the
    ``edge_delta_mlp_bwd`` kernel for CUDA tensors."""
    if y.device.type == "cpu":
        return edge_mlp_bwd_edges_plain(y, a0, b0, w1, idx, g)
    e, self_sum, dw1, dab = _bwd_edges_kernel(y, a0, b0, w1, idx, g)
    c0 = y.shape[-1]
    return e[..., :c0], self_sum[..., :c0], dw1, dab


def edge_mlp_bwd_sum(e, self_sum, idx):
    """Phase 2, ``dy [B, N, C0]`` f32: plain version for CPU tensors; for
    CUDA tensors the inverse adjacency (clamp mode) and the
    ``edge_delta_mlp_bwd_sum`` kernel."""
    if e.device.type == "cpu":
        return edge_mlp_bwd_sum_plain(e, self_sum, idx)
    c0 = e.shape[-1]
    dy = _bwd_sum_kernel(_pad_to(e, _width(c0)).contiguous(),
                         _pad_to(self_sum, _width(c0)).contiguous(), idx)
    return dy[..., :c0]


def edge_mlp_bwd(y, a0, b0, w1, idx, g):
    """``(dy [B, N, C0] f32, dw1 [C0, C1] f32, dab [2, C0] f32)`` from the
    bf16 cotangent ``g [B, K, N, C1]`` (slot 0 is not read): plain version
    for CPU tensors; for CUDA tensors phase 1 (``edge_delta_mlp_bwd``,
    which gathers the rows of ``y`` again), the inverse adjacency and
    phase 2 (``edge_delta_mlp_bwd_sum``)."""
    if y.device.type == "cpu":
        return edge_mlp_bwd_plain(y, a0, b0, w1, idx, g)
    e, self_sum, dw1, dab = _bwd_edges_kernel(y, a0, b0, w1, idx, g)
    dy = _bwd_sum_kernel(e, self_sum, idx)
    return dy[..., :y.shape[-1]], dw1, dab


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
