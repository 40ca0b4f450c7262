"""The collectives of the point-sharded path over a ``torch.distributed``
process group, in place of the JAX package's ``lax`` collectives over a
mesh axis: ``all_gather`` (tiled along dim 0), ``psum`` and ``pmax``.

With ``group=None``, or a group of one rank, each returns its input and
nothing needs initialising: a cloud served on one card runs the same
code. Across ranks, ``psum`` and ``pmax`` reduce the gathered values in
rank order, so every rank holds the same bits; bf16 and bool tensors
travel as their bytes (the ``gloo`` backend of the CPU tests takes
neither).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "pmax", "psum", "rank_and_size"]

_AS_BYTES = (torch.bfloat16, torch.bool)


def rank_and_size(group=None) -> tuple[int, int]:
    """This process's rank in ``group`` and the group's size; ``(0, 1)``
    for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    _, size = rank_and_size(group)
    if size == 1:
        return x
    as_bytes = x.dtype in _AS_BYTES
    send = x.contiguous()
    if as_bytes:  # the last dim doubles for bf16
        send = send.view(torch.uint8)
    parts = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts, dim=0)
    return out.view(x.dtype) if as_bytes else out


def _stacked(x, group):
    return all_gather(x[None], group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``."""
    if rank_and_size(group)[1] == 1:
        return x
    return _stacked(x, group).sum(dim=0)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x``."""
    if rank_and_size(group)[1] == 1:
        return x
    return _stacked(x, group).amax(dim=0)
