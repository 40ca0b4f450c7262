"""Per-point tangent frames (counterpart of
``deltaconv_tpu/geometry/frames.py``): the frame of a given normal
(:func:`build_tangent_basis`), and the frame estimated from a
neighbourhood (:func:`estimate_basis`, the covariance's closed-form 3x3
eigendecomposition). Both are plain torch ops, as JAX's are XLA, and
stay f32 whatever the model's compute dtype."""

from __future__ import annotations

import torch

from .linalg import eigh3x3
from .utils import EPS, batch_dot, normalize

__all__ = ["build_tangent_basis", "estimate_basis"]


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


def _rows(table, idx):
    """``table [B, M, 3]`` rows at ``idx [B, N, K]`` -> ``[B, N, K, 3]``."""
    b = torch.arange(table.shape[0], device=table.device)[:, None, None]
    return table[b, idx.long()]


def estimate_basis(pos, nbr_idx, nbr_mask=None, orientation=None,
                   table=None):
    """Per-point tangent frames from k-nearest neighbourhoods.

    The normal is the eigenvector of the smallest eigenvalue of the
    neighbourhood's un-centered offset covariance, the x axis that of the
    largest (the left singular vectors of the offset matrix).

    Args:
      pos: ``[B, N, 3]`` positions.
      nbr_idx: ``[B, N, K]`` neighbour rows; the self loop contributes a
        zero offset.
      nbr_mask: optional ``[B, N, K]`` validity (True: a real edge).
      orientation: optional ``[B, N, 3]`` rough normal direction; a normal
        pointing away from it is flipped (the models pass ``pos``).
      table: optional ``[B, M, 3]`` rows that ``nbr_idx`` indexes in place
        of ``pos`` (the point-sharded build: this rank's centre rows
        against the whole cloud).

    Returns:
      ``(normal, x_basis, y_basis)``, each ``[B, N, 3]``, orthonormal and
      right-handed (``y = n x x``). One cloud (``pos [N, 3]``, every
      argument without its batch axis) is a batch of one, returned
      ``[N, 3]``.
    """
    if pos.dim() == 2:
        return tuple(t[0] for t in estimate_basis(*(
            None if t is None else t[None]
            for t in (pos, nbr_idx, nbr_mask, orientation, table))))
    tab = pos if table is None else table
    offsets = _rows(tab, nbr_idx) - pos[:, :, None, :]  # [B, N, K, 3]
    if nbr_mask is not None:
        offsets = offsets * nbr_mask[..., None].to(offsets.dtype)
    # The un-centered covariance as products summed over K: a matmul on
    # the card could take TF32 (JAX asks Precision.HIGHEST).
    o = offsets.unbind(dim=-1)
    c = [[None] * 3 for _ in range(3)]
    for d in range(3):
        for e in range(d, 3):
            c[d][e] = c[e][d] = (o[d] * o[e]).sum(dim=-1)
    cov = torch.stack([torch.stack(row, dim=-1) for row in c], dim=-2)

    _, vecs = eigh3x3(cov)
    normal = normalize(vecs[..., 0], EPS)  # smallest eigenvalue
    x_basis = vecs[..., 2]  # largest eigenvalue
    if orientation is not None:
        normal = torch.where(batch_dot(normal, orientation) < 0, -normal,
                             normal)
    # x re-orthonormalized against the (possibly flipped) normal; y by the
    # cross product, for a right-handed frame.
    x_basis = normalize(x_basis - batch_dot(x_basis, normal) * normal, EPS)
    y_basis = normalize(torch.linalg.cross(normal, x_basis), EPS)
    return normal, x_basis, y_basis
