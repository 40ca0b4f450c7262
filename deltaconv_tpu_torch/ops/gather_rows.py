"""Component-major neighbour-table gather and its transpose, the edge-row
scatter (CUDA kernels + plain versions).

``gather_rows(table, idx)``: ``[B, Nt, C], [B, N, K] -> [B, C, K, N]``
with ``out[b, c, k, n] = table[b, idx[b, n, k], c]``, the layout the
edge-plane math of the operator build (:mod:`.wls_fused`) works on. The
table may be longer than the query rows (``Nt != N``): the point-sharded
build gathers a shard's neighbours from the whole cloud's table.
Differentiable in ``table`` (f32), as the JAX ``custom_vjp`` is: the
backward is :func:`scatter_rows`.

``scatter_rows(g, idx, n_out)``: ``[B, C, K, N] f32, [B, N, K] -> [B,
n_out, C] f32`` with ``out[b, m, c] = sum over (n, k) with idx[b, n, k]
== m of g[b, c, k, n]``: the gather's backward, and the feature
cotangent of the coefficient-form applies (:mod:`.coef_apply`), which
hand it edge-major views (``[B, N, K, C]`` rows permuted to ``[B, C, K,
N]``, channels contiguous). ``g`` may have any strides: the kernel reads
it through them. It works destination-major: :func:`inverse_adjacency`
lists each row's edges in ascending edge order, and the kernel sums them
in that order with no float atomics, so two calls give the same bits. An
index outside ``[0, n_out)`` adds nothing.

``inverse_adjacency(idx, n_out, clamp=False)``: ``[B, N, K] -> offsets
[B, n_out + 1] i32, edges [B, N * K] i32``, the CSR of the transposed
neighbour lists: row ``m`` of cloud ``b`` takes the edges ``e = n * K +
k`` listed in ``edges[b, offsets[b, m]:offsets[b, m + 1]]``, ascending;
an edge whose index lies outside ``[0, n_out)`` is listed nowhere, and
the cloud's tail past ``offsets[b, n_out]`` holds one -1 for each. With
``clamp`` an index is read as JAX's indexing reads it (a negative one
counts from the end, then it is clamped to ``[0, n_out)``), so every
edge is listed: the edge MLP's backward (:mod:`.edge_mlp`).

Counterpart of ``deltaconv_tpu/ops/gather_rows.py``; the kernels are
``csrc/gather_rows.cu``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _lib

__all__ = ["gather_rows", "gather_rows_plain", "inverse_adjacency",
           "inverse_adjacency_plain", "scatter_rows", "scatter_rows_plain"]


def _gather_plain(table, idx):
    b, _, c = table.shape
    n, k = idx.shape[1:]
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    rows = torch.gather(table, 1, flat).reshape(b, n, k, c)
    return rows.permute(0, 3, 2, 1).contiguous()


def _gather_kernel(table, idx):
    if table.device.type == "cpu":
        return _gather_plain(table, idx)
    b, n_t, c = table.shape
    n, k = idx.shape[1:]
    device = _lib.check_inputs("gather_rows", [
        ("table", table, torch.float32, (b, n_t, c)),
        ("idx", idx, torch.int32, (b, n, k)),
    ])
    out = torch.empty((b, c, k, n), dtype=torch.float32, device=device)
    _lib.launch("gather_rows", device, table.data_ptr(), idx.data_ptr(),
                out.data_ptr(), b, n, n_t, c, k)
    return out


def scatter_rows_plain(g: torch.Tensor, idx: torch.Tensor,
                       n_out: int) -> torch.Tensor:
    """The plain PyTorch version: ``scatter_add_`` of the flattened edge
    rows (indices outside ``[0, n_out)`` add zero to row 0)."""
    b, c, k, n = g.shape
    rows = g.permute(0, 3, 2, 1).reshape(b, n * k, c)
    flat = idx.reshape(b, n * k, 1).long()
    inside = (flat >= 0) & (flat < n_out)
    rows = torch.where(inside, rows, 0.0)
    flat = torch.where(inside, flat, 0).expand(b, n * k, c)
    out = torch.zeros((b, n_out, c), dtype=torch.float32, device=g.device)
    return out.scatter_add_(1, flat, rows)


def inverse_adjacency_plain(idx: torch.Tensor, n_out: int,
                            clamp: bool = False):
    """The plain PyTorch version: a stable ``argsort`` of each cloud's
    destination keys (``n_out`` for an index outside ``[0, n_out)``,
    which sorts last and is listed as -1; with ``clamp`` the index as JAX
    reads it)."""
    b, n, k = idx.shape
    key = idx.reshape(b, n * k).long()
    if clamp:
        key = torch.where(key < 0, key + n_out, key).clamp(0, n_out - 1)
    key = torch.where((key >= 0) & (key < n_out), key, n_out)
    order = torch.argsort(key, dim=1, stable=True)
    counts = torch.zeros((b, n_out + 1), dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    offsets = torch.zeros((b, n_out + 1), dtype=torch.int32,
                          device=idx.device)
    offsets[:, 1:] = torch.cumsum(counts[:, :n_out], dim=1)
    edges = torch.where(torch.gather(key, 1, order) < n_out, order, -1)
    return offsets, edges.to(torch.int32)


def _launch_inverse_adjacency(idx, n_out, device, clamp=False):
    b, n, k = idx.shape
    offsets = torch.empty((b, n_out + 1), dtype=torch.int32, device=device)
    scratch, edges = torch.empty((2, b, n * k), dtype=torch.int32,
                                 device=device)
    _lib.launch("inverse_adjacency", device, idx.data_ptr(),
                offsets.data_ptr(), scratch.data_ptr(), edges.data_ptr(), b,
                n, k, int(n_out), int(clamp))
    return offsets, edges


def inverse_adjacency(idx: torch.Tensor, n_out: int, clamp: bool = False):
    """Plain version for CPU tensors; the ``inverse_adjacency`` kernel
    (a block a 256-row tile of a cloud: count, scan, fill, sort) for CUDA
    tensors."""
    if idx.device.type == "cpu":
        return inverse_adjacency_plain(idx, n_out, clamp)
    b, n, k = idx.shape
    device = _lib.check_inputs("inverse_adjacency", [
        ("idx", idx, torch.int32, (b, n, k))])
    return _launch_inverse_adjacency(idx, n_out, device, clamp)


def scatter_rows(g: torch.Tensor, idx: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """Plain version for CPU tensors; for CUDA tensors the inverse
    adjacency and the destination-major ``scatter_rows`` kernel, which
    reads ``g`` through its strides."""
    if g.device.type == "cpu":
        return scatter_rows_plain(g, idx, n_out)
    b, c, k, n = g.shape
    device = _lib.check_inputs("scatter_rows", [
        ("g", g, torch.float32, (b, c, k, n)),
        ("idx", idx, torch.int32, (b, n, k)),
    ], strided=("g",))
    offsets, edges = _launch_inverse_adjacency(idx, n_out, device)
    out = torch.empty((b, n_out, c), dtype=torch.float32, device=device)
    _lib.launch("scatter_rows", device, g.data_ptr(), offsets.data_ptr(),
                edges.data_ptr(), out.data_ptr(), b, n, c, k, int(n_out),
                *g.stride())
    return out


class _Route(NamedTuple):
    gather: Callable
    scatter: Callable


_KERNELS = _Route(_gather_kernel, scatter_rows)
_PLAIN = _Route(_gather_plain, scatter_rows_plain)


class _GatherRows(torch.autograd.Function):
    """The gather with its VJP, gradient for ``table`` only."""

    @staticmethod
    def forward(ctx, table, idx, route):
        ctx.save_for_backward(idx)
        ctx.n, ctx.route = table.shape[1], route
        return route.gather(table.detach(), idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return ctx.route.scatter(g, idx, ctx.n), None, None


def _differentiated(t) -> bool:
    return t.requires_grad and torch.is_grad_enabled()


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather through the kernels on CUDA tensors (the plain versions
    on CPU ones); differentiable in ``table``."""
    if _differentiated(table):
        return _GatherRows.apply(table, idx, _KERNELS)
    return _gather_kernel(table, idx)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """:func:`gather_rows` through the plain versions (``torch.gather`` +
    a permute; ``scatter_add_``) on any device."""
    if _differentiated(table):
        return _GatherRows.apply(table, idx, _PLAIN)
    return _gather_plain(table, idx)
