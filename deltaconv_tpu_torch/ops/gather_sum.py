"""Masked neighbour sum, differentiable in ``h`` (CUDA kernels + plain
versions).

``gather_sum(h, idx, mask)``: ``[B, N, C], [B, N, K], [B, N, K] ->
[B, N, C]`` with ``out[b, n] = sum over valid k of h[b, idx[b, n, k]]``.
The train-mode EdgeMaxMLP takes its BatchNorm edge moments from it.
Counterpart of ``deltaconv_tpu/ops/gather_sum.py``; the kernels are in
``csrc/gather_sum.cu``.

The routes are the JAX package's:

- differentiated, with ``B * N * N * 2 <= _DENSE_ADJ_MAX_BYTES`` (the
  JAX byte rule, kept although the adjacency is f32 here): the
  ``adjacency`` kernel builds the ``[B, N, N]`` neighbour counts ``A``
  once, a warp a row, zeros and counts stored straight from registers
  (bit-equal to the plain ``scatter_add_``: the counts are exact); the
  forward is ``A @ h`` and the backward ``A^T @ g`` on the same saved
  ``A`` (``torch.bmm``, the plain large products that the JAX package
  also leaves outside Pallas);
- differentiated above that budget: the streaming forward, with the
  ``gather_sum_bwd`` kernel as its backward (each row's cotangents summed
  destination-major over the inverse adjacency, in f64, rounded once);
- not differentiated: always the streaming forward.

The streaming forward has two routes on CUDA tensors, chosen by shape
(:func:`sum_slice`), the same bits: route S, ``gather_sum`` (a block
stages a cloud's channel slice of ``h`` in shared memory and sums each
point's slots out of it: the neighbour max's staged kernel in its sum
mode), where a slice fits a block (up to 14,526 points); route D,
``gather_sum_direct`` (every slot's row from L2), above that or at K=0.

:func:`gather_sum` runs the kernels, :func:`gather_sum_plain` the plain
versions, on the same routes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _lib
from .gather_max import _sm_count, max_slice
from .gather_rows import inverse_adjacency

__all__ = ["adjacency", "adjacency_plain", "gather_sum", "gather_sum_bwd",
           "gather_sum_bwd_plain", "gather_sum_fwd", "gather_sum_fwd_plain",
           "gather_sum_plain", "sum_slice"]

# Budget of the saved adjacency, in the JAX package's bytes (bf16
# counts): B=32 x N=1024 (64 MB) and B=16 x N=2048 (128 MB) stay dense.
# A test may patch it to 0 to run the streaming kernels at a small size.
_DENSE_ADJ_MAX_BYTES = 256 * 1024 * 1024


def _dense_path_ok(b: int, n: int) -> bool:
    return b * n * n * 2 <= _DENSE_ADJ_MAX_BYTES


def adjacency_plain(idx, mask):
    """Plain counts: ``scatter_add_`` of the mask on zeros."""
    b, n, _ = idx.shape
    adj = torch.zeros((b, n, n), dtype=torch.float32, device=idx.device)
    return adj.scatter_add_(2, idx.long(), mask.to(torch.float32))


def gather_sum_fwd_plain(h, idx, mask):
    """Plain streaming forward: gather, mask, and sum over the slots in
    slot order, the kernel's order, so that the two agree bit for bit
    (a reordered sum would move the edge statistics by an ulp, and a
    neighbour-max winner downstream with them)."""
    b, n, c = h.shape
    k = idx.shape[-1]
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    g = torch.where(mask[..., None],
                    torch.gather(h, 1, flat).reshape(b, n, k, c), 0.0)
    out = torch.zeros((b, n, c), dtype=h.dtype, device=h.device)
    for slot in range(k):
        out = out + g[:, :, slot]
    return out


def gather_sum_bwd_plain(idx, mask, g):
    """Plain backward: ``scatter_add_`` of the masked cotangent into the
    neighbour rows, summed in f64 and rounded once to f32, as the kernel
    does (a row's sum is exact in f64 unless its addends span more than
    29 binary orders, so the result is the same in any order)."""
    b, n, c = g.shape
    k = idx.shape[-1]
    src = torch.where(mask[..., None], g[:, :, None, :].double(), 0.0)
    index = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    dh = torch.zeros((b, n, c), dtype=torch.float64, device=g.device)
    return dh.scatter_add_(1, index, src.reshape(b, n * k, c)).float()


def _check_graph(name, idx, mask, extra=()):
    b, n, k = idx.shape
    return _lib.check_inputs(name, [
        ("idx", idx, torch.int32, (b, n, k)),
        ("mask", mask, torch.bool, (b, n, k)),
        *extra,
    ])


def adjacency(idx, mask):
    """``[B, N, N]`` f32 counts: plain version for CPU tensors, the
    ``adjacency`` kernel for CUDA tensors (a warp a row, written from
    registers: any N)."""
    if idx.device.type == "cpu":
        return adjacency_plain(idx, mask)
    device = _check_graph("adjacency", idx, mask)
    b, n, k = idx.shape
    adj = torch.empty((b, n, n), dtype=torch.float32, device=device)
    _lib.launch("adjacency", device, idx.data_ptr(), mask.data_ptr(),
                adj.data_ptr(), b, n, k)
    return adj


def sum_slice(b: int, n: int, c: int, k: int, sms: int) -> tuple[int, int]:
    """The route of the streaming forward for ``[b, n, c]`` f32 features
    and ``k`` slots on a card of ``sms`` SMs, by the neighbour max's rules
    (:func:`~.gather_max.max_slice` at 4 bytes an element, no winners):
    ``(cs, splits)`` for route S, or ``(0, 0)`` for route D (above 14,526
    points, or ``k`` 0). At B=4, N=8192, C=128: 4 channels a slice (8,194
    rows of 16 bytes, 131 KB), 128 tasks, one block each."""
    return max_slice(b, n, c, 4, k, sms)


def gather_sum_fwd(h, idx, mask):
    """Streaming forward: plain version for CPU tensors; for CUDA
    tensors ``gather_sum`` (route S) or ``gather_sum_direct`` (route D),
    by :func:`sum_slice`."""
    if h.device.type == "cpu":
        return gather_sum_fwd_plain(h, idx, mask)
    return _gather_sum_fwd(h, idx, mask)


def _gather_sum_fwd(h, idx, mask, route=None):
    """:func:`gather_sum_fwd` on CUDA tensors through ``route`` (``(cs,
    splits)``; ``(0, 0)`` route D; None: by shape)."""
    b, n, c = h.shape
    k = idx.shape[-1]
    device = _check_graph("gather_sum", idx, mask,
                          [("h", h, torch.float32, (b, n, c))])
    if route is None:
        route = sum_slice(b, n, c, k, _sm_count(device.index or 0))
    cs, splits = route
    out = torch.empty_like(h)
    args = (h.data_ptr(), idx.data_ptr(), mask.data_ptr(), out.data_ptr(), b,
            n, c, k)
    if cs:
        _lib.launch("gather_sum", device, *args, cs, splits)
    else:
        _lib.launch("gather_sum_direct", device, *args)
    return out


def gather_sum_bwd(idx, mask, g):
    """Streaming backward ``dh [B, N, C]`` f32, each row's sum in f64
    rounded once (the plain version's bits): plain version for CPU
    tensors; for CUDA tensors the inverse adjacency of ``idx``
    (``inverse_adjacency``) and the destination-major ``gather_sum_bwd``
    kernel over it."""
    if g.device.type == "cpu":
        return gather_sum_bwd_plain(idx, mask, g)
    b, n, c = g.shape
    device = _check_graph("gather_sum_bwd", idx, mask,
                          [("g", g, torch.float32, (b, n, c))])
    offsets, edges = inverse_adjacency(idx, n)
    dh = torch.empty((b, n, c), dtype=torch.float32, device=device)
    _lib.launch("gather_sum_bwd", device, offsets.data_ptr(),
                edges.data_ptr(), mask.data_ptr(), g.data_ptr(),
                dh.data_ptr(), b, n, c, idx.shape[-1])
    return dh


class _Route(NamedTuple):
    adjacency: Callable
    fwd: Callable
    bwd: Callable


_KERNELS = _Route(adjacency, gather_sum_fwd, gather_sum_bwd)
_PLAIN = _Route(adjacency_plain, gather_sum_fwd_plain, gather_sum_bwd_plain)


class _GatherSum(torch.autograd.Function):
    """Neighbour sum with its VJP, gradient for ``h`` only. The raw
    functions get detached tensors: inside ``forward`` the inputs still
    carry ``requires_grad``."""

    @staticmethod
    def forward(ctx, h, idx, mask, route):
        h = h.detach()
        b, n, _ = h.shape
        ctx.dense = _dense_path_ok(b, n)
        if ctx.dense:
            adj = route.adjacency(idx, mask)
            ctx.save_for_backward(adj)
            return torch.bmm(adj, h)
        ctx.save_for_backward(idx, mask)
        ctx.route = route
        return route.fwd(h, idx, mask)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.dense:
            (adj,) = ctx.saved_tensors
            return torch.bmm(adj.transpose(1, 2), g), None, None, None
        idx, mask = ctx.saved_tensors
        return ctx.route.bwd(idx, mask, g), None, None, None


def _differentiated(h) -> bool:
    return h.requires_grad and torch.is_grad_enabled()


def gather_sum(h: torch.Tensor, idx: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Neighbour sum through the kernels on CUDA tensors (the plain
    versions on CPU ones); differentiable in ``h``."""
    if _differentiated(h):
        return _GatherSum.apply(h, idx, mask, _KERNELS)
    return gather_sum_fwd(h, idx, mask)


def gather_sum_plain(h: torch.Tensor, idx: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """:func:`gather_sum` through the plain versions on any device."""
    if _differentiated(h):
        return _GatherSum.apply(h, idx, mask, _PLAIN)
    return gather_sum_fwd_plain(h, idx, mask)
