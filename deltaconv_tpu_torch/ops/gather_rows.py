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
cotangent of the coefficient-form applies (:mod:`.coef_apply`). The
kernel adds with atomics, so the last bits of a sum can change from run
to run; an index outside ``[0, n_out)`` adds nothing.

Counterpart of ``deltaconv_tpu/ops/gather_rows.py``; the kernels are
``csrc/gather_rows.cu``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _lib

__all__ = ["gather_rows", "gather_rows_plain", "scatter_rows",
           "scatter_rows_plain"]


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


def scatter_rows(g: torch.Tensor, idx: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if g.device.type == "cpu":
        return scatter_rows_plain(g, idx, n_out)
    b, c, k, n = g.shape
    device = _lib.check_inputs("scatter_rows", [
        ("g", g, torch.float32, (b, c, k, n)),
        ("idx", idx, torch.int32, (b, n, k)),
    ])
    out = torch.zeros((b, n_out, c), dtype=torch.float32, device=device)
    _lib.launch("scatter_rows", device, g.data_ptr(), idx.data_ptr(),
                out.data_ptr(), b, n, c, k, int(n_out))
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
        return ctx.route.scatter(g.contiguous(), idx, ctx.n), None, None


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
