"""Pointwise vector-field operators in the ``[..., N, 2, C]`` layout
(counterpart of ``deltaconv_tpu/geometry/operators.py``): a C-channel
tangent vector field on N points keeps its two components on axis -2."""

from __future__ import annotations

import torch

from .utils import safe_norm

__all__ = ["I_J", "J", "norm"]


def norm(v):
    """Channelwise vector norms: ``[..., N, 2, C] -> [..., N, C]``."""
    return safe_norm(v, dim=-2)


def J(v):
    """90-degree counter-clockwise rotation of a tangent vector field."""
    return torch.stack([-v[..., 1, :], v[..., 0, :]], dim=-2)


def I_J(v):
    """Concatenate a vector field with its rotated copy along channels."""
    return torch.cat([v, J(v)], dim=-1)
