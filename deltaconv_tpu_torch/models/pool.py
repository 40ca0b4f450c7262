"""Masked global pooling over the point axis (counterpart of
``deltaconv_tpu/models/pool.py``). ``group``: the process group a
point-sharded cloud's rows are spread over; the pools then complete
across its ranks (None: one rank), differentiably: the max through
``all_gather`` and a max (its gradient split among tied ranks, as JAX's
``_cross_shard_max``), the mean through ``psum``
(``parallel.collectives``)."""

from __future__ import annotations

import torch

from ..parallel.collectives import pmax, psum, rank_and_size

__all__ = ["global_max_pool", "global_mean_pool"]


def global_max_pool(x, point_mask=None, group=None):
    """``[B, N, C] -> [B, C]`` masked max over points (0 for a cloud
    with no valid point)."""
    if point_mask is None:
        return pmax(x.amax(dim=-2), group)
    out = torch.where(point_mask[..., None], x, -torch.inf).amax(dim=-2)
    any_valid = point_mask.any(dim=-1, keepdim=True)
    out = pmax(out, group)
    any_valid = pmax(any_valid.to(torch.uint8), group).bool()
    return torch.where(any_valid, out, 0.0)


def global_mean_pool(x, point_mask=None, group=None):
    """``[B, N, C] -> [B, C]`` masked mean over points, in ``x``'s
    dtype. As in the JAX package, a bf16 ``x`` divides by a bf16 count
    (the sum of a bf16 mask), which rounds counts above 256 to 8
    significant bits (1001 points count as 1000); unmasked across ranks
    it divides by the f32 count, and the mean is f32."""
    if point_mask is None:
        if rank_and_size(group)[1] == 1:
            return x.mean(dim=-2)
        count = psum(torch.tensor(float(x.shape[-2]), device=x.device),
                     group)
        return psum(x.sum(dim=-2), group).float() / count
    m = point_mask[..., None].to(x.dtype)
    total, count = psum((x * m).sum(dim=-2), group), psum(m.sum(dim=-2),
                                                          group)
    return total / torch.clamp(count, min=1.0)
