"""Per-point tangent frames (counterpart of
``deltaconv_tpu/geometry/frames.py``). Only the frame from given normals
is ported; estimating normals (``estimate_basis``, closed-form 3x3
eigh) is still to come (ROADMAP)."""

from __future__ import annotations

import torch

from .utils import EPS, batch_dot, normalize

__all__ = ["build_tangent_basis"]


def build_tangent_basis(normal):
    """Orthonormal tangent basis from unit normals ``[..., 3]``.

    Test vector [1, 0, 0], or [0, 1, 0] where ``|n . x| > 0.9``; then
    ``x = testvec x n`` and ``y = n x x``, both normalized.

    Returns ``(x_basis, y_basis)``, each ``[..., 3]``.
    """
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=normal.dtype,
                      device=normal.device).expand_as(normal)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=normal.dtype,
                      device=normal.device).expand_as(normal)
    testvec = torch.where(batch_dot(normal, e0).abs() > 0.9, e1, e0)
    x_basis = normalize(torch.linalg.cross(testvec, normal), EPS)
    y_basis = normalize(torch.linalg.cross(normal, x_basis), EPS)
    return x_basis, y_basis
