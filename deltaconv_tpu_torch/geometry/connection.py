"""Parallel transport (the Levi-Civita connection) between tangent frames
(counterpart of ``deltaconv_tpu/geometry/connection.py``): for each pair
of points, the 2x2 rotation (composed with a reflection on unoriented
surfaces) that expresses a source frame's x axis in the target frame
after transporting it along the rotation that aligns the two normals.

Every function broadcasts over leading axes; vectors are ``[..., 3]``.
"""

from __future__ import annotations

import torch

from .utils import batch_dot, normalize

__all__ = ["angle_in_plane", "build_transport", "rotate_around"]


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def rotate_around(v, axis, angle):
    """Rotates the vectors ``v`` around the unit ``axis`` by ``angle``
    (radians, ``[...]`` or ``[..., 1]``) through an in-plane orthonormal
    basis."""
    if angle.dim() == v.dim() - 1:
        angle = angle[..., None]
    parallel = axis * batch_dot(v, axis)
    tangent = v - parallel
    t_norm = torch.clamp(torch.linalg.vector_norm(tangent, dim=-1,
                                                  keepdim=True), min=1e-8)
    bx = tangent / t_norm
    by = _cross(axis, bx)
    rotated = t_norm * (torch.cos(angle) * bx + torch.sin(angle) * by) \
        + parallel
    return torch.where(t_norm > 0, rotated, parallel)


def angle_in_plane(u, v, normal):
    """The signed angle from ``u`` to ``v`` in the plane orthogonal to
    ``normal``."""
    u_plane = normalize(u - batch_dot(u, normal) * normal, 1e-8)
    basis_y = normalize(_cross(normal, u_plane), 1e-8)
    return torch.atan2(batch_dot(v, basis_y)[..., 0],
                       batch_dot(v, u_plane)[..., 0])


def build_transport(target_n, target_x, target_y, source_n, source_x,
                    non_oriented: bool = True):
    """The 2x2 connection coefficients that transport source frames to
    target frames, as ``[..., 4]`` rows ``(a, -b, b * conj, a * conj)``.
    On unoriented surfaces (``non_oriented=True``) the target frame is
    flipped where the normals disagree and a reflection is appended.

    Args:
      target_n, target_x, target_y: ``[..., 3]`` target frames.
      source_n, source_x: ``[..., 3]`` source frames.
    """
    inverted = batch_dot(source_n, target_n) < 0
    target_n = torch.where(inverted, -target_n, target_n)
    target_y = torch.where(inverted, -target_y, target_y)

    axis = _cross(target_n, source_n)
    axis_norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    axis = torch.where(axis_norm > 1e-6,
                       axis / torch.clamp(axis_norm, min=1e-20), source_x)

    angle = angle_in_plane(source_n, target_n, axis)
    sx_3d = rotate_around(source_x, axis, angle)
    sx = torch.cat([batch_dot(sx_3d, target_x), batch_dot(sx_3d, target_y)],
                   dim=-1)
    sx_norm = torch.linalg.vector_norm(sx, dim=-1, keepdim=True)
    identity = torch.zeros_like(sx)
    identity[..., 0] = 1.0
    sx = torch.where(sx_norm > 1e-6, sx / torch.clamp(sx_norm, min=1e-20),
                     identity)

    conj = torch.ones(sx.shape[:-1], dtype=sx.dtype, device=sx.device)
    if non_oriented:
        conj = torch.where(inverted[..., 0], -conj, conj)
    return torch.stack([sx[..., 0], -sx[..., 1], sx[..., 1] * conj,
                        sx[..., 0] * conj], dim=-1)
