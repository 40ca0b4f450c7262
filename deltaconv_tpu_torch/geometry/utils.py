"""Small geometry helpers shared across the package
(counterpart of ``deltaconv_tpu/geometry/utils.py``)."""

from __future__ import annotations

import torch

EPS = 1e-5

__all__ = ["EPS", "batch_dot", "normalize", "safe_norm"]


def safe_norm(v, dim=-1, keepdim=False):
    """L2 norm that is exactly 0 at ``v = 0`` (and whose gradient there
    would be 0, the PyTorch convention the JAX package reproduces)."""
    sq = (v * v).sum(dim=dim, keepdim=keepdim)
    positive = sq > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, sq, 1.0)),
                       0.0)


def batch_dot(a, b):
    """Row-wise dot product over the last axis, keepdim:
    ``[..., 3] x [..., 3] -> [..., 1]``."""
    return (a * b).sum(dim=-1, keepdim=True)


def normalize(v, eps: float = EPS):
    """Normalize vectors over the last axis with a clamped norm."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)
