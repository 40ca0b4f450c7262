"""Masked global pooling over the point axis (counterpart of
``deltaconv_tpu/models/pool.py``, single device)."""

from __future__ import annotations

import torch

__all__ = ["global_max_pool", "global_mean_pool"]


def global_max_pool(x, point_mask=None):
    """``[B, N, C] -> [B, C]`` masked max over points (0 for a cloud
    with no valid point)."""
    if point_mask is None:
        return x.amax(dim=-2)
    out = torch.where(point_mask[..., None], x, -torch.inf).amax(dim=-2)
    return torch.where(point_mask.any(dim=-1, keepdim=True), out, 0.0)


def global_mean_pool(x, point_mask=None):
    """``[B, N, C] -> [B, C]`` masked mean over points."""
    if point_mask is None:
        return x.mean(dim=-2)
    m = point_mask[..., None].to(x.dtype)
    return (x * m).sum(dim=-2) / torch.clamp(m.sum(dim=-2), min=1.0)
