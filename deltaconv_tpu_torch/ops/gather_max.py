"""Masked neighbour max with single-winner gradients (CUDA kernels +
plain versions).

``gather_max(h, idx, mask)``: ``[B, N, C], [B, N, K], [B, N, K] ->
[B, N, C]``, the max over valid slots of the gathered neighbour rows;
rows with no valid neighbour give ``-3e38``. :func:`masked_nbr_max`
turns those into 0, as the scalar-stream aggregation of every DeltaConv
needs. Counterpart of ``deltaconv_tpu/ops/gather_max.py``
(``gather_max`` and its custom VJP, ``masked_nbr_max``); the kernels are
in ``csrc/gather_max.cu``.

Differentiated (``h.requires_grad`` under grad mode), the max is an
autograd Function: its forward also records, per output element, the
FIRST slot that holds the maximum, and its backward routes the whole
cotangent to that one neighbour row. This is the JAX package's VJP;
torch's own ``amax`` backward splits ties evenly and would differ on
every tie. Otherwise the forward runs without winner tracking, as JAX's
primal path does. :func:`gather_max` runs the kernels,
:func:`gather_max_plain` the plain versions, with the same routing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _lib

__all__ = ["NEG", "gather_max", "gather_max_bwd", "gather_max_bwd_plain",
           "gather_max_plain", "gather_max_win", "gather_max_win_plain",
           "masked_nbr_max"]

NEG = -3.0e38  # ~ -inf in f32, safe to negate and compare


def _masked_rows(h, idx, mask):
    """``[B, N, K, C]`` gathered neighbour rows, ``NEG`` where masked."""
    b, n, c = h.shape
    k = idx.shape[-1]
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    g = torch.gather(h, 1, flat).reshape(b, n, k, c)
    return torch.where(mask[..., None], g, NEG)


def _max_plain(h, idx, mask):
    """Plain forward without winners: gather, then a masked ``amax``."""
    return _masked_rows(h, idx, mask).amax(dim=2)


def gather_max_win_plain(h, idx, mask):
    """Plain forward with winners: the masked ``amax``, then the first
    slot equal to it (``argmax`` returns the first maximal index)."""
    vals = _masked_rows(h, idx, mask)
    out = vals.amax(dim=2)
    first = (vals == out[:, :, None]).to(torch.uint8).argmax(dim=2)
    return out, first.to(torch.int32)


def gather_max_bwd_plain(idx, winner, g, n_out: int):
    """Plain backward: resolve each winner slot to its neighbour with
    ``idx.gather``, then ``scatter_add_`` the cotangent there."""
    b, _, c = g.shape
    src = torch.gather(idx.long(), 2, winner.long())  # [B, N, C]
    dh = torch.zeros((b, n_out, c), dtype=torch.float32, device=g.device)
    return dh.scatter_add_(1, src, g.float())


def _check_fwd(name, h, idx, mask):
    b, n, c = h.shape
    k = idx.shape[-1]
    return _lib.check_inputs(name, [
        ("h", h, torch.float32, (b, n, c)),
        ("idx", idx, torch.int32, (b, n, k)),
        ("mask", mask, torch.bool, (b, n, k)),
    ])


def _max(h, idx, mask):
    """The forward without winners: plain version for CPU tensors, the
    ``gather_max`` kernel for CUDA tensors."""
    if h.device.type == "cpu":
        return _max_plain(h, idx, mask)
    device = _check_fwd("gather_max", h, idx, mask)
    b, n, c = h.shape
    out = torch.empty_like(h)
    _lib.launch("gather_max", device, h.data_ptr(), idx.data_ptr(),
                mask.data_ptr(), out.data_ptr(), b, n, c, idx.shape[-1])
    return out


def gather_max_win(h, idx, mask):
    """The forward with winners ``(out, winner [B, N, C] int32)``: plain
    version for CPU tensors, the ``gather_max_win`` kernel for CUDA
    tensors."""
    if h.device.type == "cpu":
        return gather_max_win_plain(h, idx, mask)
    device = _check_fwd("gather_max_win", h, idx, mask)
    b, n, c = h.shape
    out = torch.empty_like(h)
    winner = torch.empty((b, n, c), dtype=torch.int32, device=device)
    _lib.launch("gather_max_win", device, h.data_ptr(), idx.data_ptr(),
                mask.data_ptr(), out.data_ptr(), winner.data_ptr(), b, n, c,
                idx.shape[-1])
    return out, winner


def gather_max_bwd(idx, winner, g, n_out: int):
    """The winner-routed backward ``dh [B, n_out, C]``: plain version for
    CPU tensors, the ``gather_max_bwd`` kernel for CUDA tensors."""
    if g.device.type == "cpu":
        return gather_max_bwd_plain(idx, winner, g, n_out)
    b, n, c = g.shape
    k = idx.shape[-1]
    device = _lib.check_inputs("gather_max_bwd", [
        ("idx", idx, torch.int32, (b, n, k)),
        ("winner", winner, torch.int32, (b, n, c)),
        ("g", g, torch.float32, (b, n, c)),
    ])
    dh = torch.zeros((b, n_out, c), dtype=torch.float32, device=device)
    _lib.launch("gather_max_bwd", device, idx.data_ptr(), winner.data_ptr(),
                g.data_ptr(), dh.data_ptr(), b, n, c, k, n_out)
    return dh


class _Route(NamedTuple):
    win: Callable
    bwd: Callable


_KERNELS = _Route(gather_max_win, gather_max_bwd)
_PLAIN = _Route(gather_max_win_plain, gather_max_bwd_plain)


class _GatherMax(torch.autograd.Function):
    """Neighbour max with the single-winner VJP, gradient for ``h``
    only. The raw functions get detached tensors: inside ``forward``
    the inputs still carry ``requires_grad``."""

    @staticmethod
    def forward(ctx, h, idx, mask, route):
        out, winner = route.win(h.detach(), idx, mask)
        ctx.save_for_backward(idx, winner)
        ctx.route, ctx.n_out = route, h.shape[1]
        return out

    @staticmethod
    def backward(ctx, g):
        idx, winner = ctx.saved_tensors
        dh = ctx.route.bwd(idx, winner, g.contiguous(), ctx.n_out)
        return dh, None, None, None


def _differentiated(h) -> bool:
    return h.requires_grad and torch.is_grad_enabled()


def gather_max(h: torch.Tensor, idx: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Neighbour max through the kernels on CUDA tensors (the plain
    versions on CPU ones); differentiable in ``h``."""
    if _differentiated(h):
        return _GatherMax.apply(h, idx, mask, _KERNELS)
    return _max(h, idx, mask)


def gather_max_plain(h: torch.Tensor, idx: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """:func:`gather_max` through the plain versions on any device."""
    if _differentiated(h):
        return _GatherMax.apply(h, idx, mask, _PLAIN)
    return _max_plain(h, idx, mask)


def masked_nbr_max(h, nbr_idx, nbr_mask, gather_max_fn=gather_max):
    """:func:`gather_max` with all-masked rows (padded points) set to 0,
    whose cotangent is then 0. ``gather_max_fn`` selects the kernels or
    the plain versions."""
    out = gather_max_fn(h, nbr_idx, nbr_mask)
    return torch.where(nbr_mask.any(dim=-1, keepdim=True), out, 0.0)
