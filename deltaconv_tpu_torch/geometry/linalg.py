"""Batched small-matrix linear algebra in closed form (counterpart of
``deltaconv_tpu/geometry/linalg.py``).

Symmetric 3x3 eigendecompositions (the covariance of a neighbourhood in
``estimate_basis``) and SPD Cholesky solves of a static size, written as
elementwise torch ops over the batch with the JAX package's formulas in
the JAX package's order, so that both pick the same eigenvector where a
choice exists (the cross product with the largest norm, ``>=`` first).
:func:`eigh3x3` adds one Gram-Schmidt step (its V is orthonormal where
the JAX function's is not: a scalar or a zero matrix); ``estimate_basis``
makes the same projection after it, so its frames are unchanged.
"""

from __future__ import annotations

import torch

__all__ = ["chol_solve", "eigh3x3"]

_TWO_PI_3 = 2.0943951023931953
_TINY = 1e-20


def _safe_sqrt(x):
    """``sqrt(max(x, 0))`` whose gradient is 0 where ``x <= 0`` (JAX's is
    infinite there: a padded point's all-zero covariance)."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)),
                       0.0)


def _eigvals3x3_sym(A):
    """Analytic eigenvalues of symmetric 3x3 matrices ``[..., 3, 3]``,
    ascending (trigonometric method, Smith 1961): ``(w0, w1, w2)``, each
    ``[...]``."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = _safe_sqrt(p2 / 6.0)
    # p == 0 (a scalar matrix): the eigenvalues are all q.
    safe_p = torch.where(p > 0, p, 1.0)

    b00, b11, b22 = (a00 - q) / safe_p, (a11 - q) / safe_p, (a22 - q) / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    # det(B) / 2 where B = (A - q I) / p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    w2 = q + 2.0 * p * torch.cos(phi)
    w0 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    w1 = 3.0 * q - w2 - w0
    return w0, w1, w2


def _eigvec_for(A, lam):
    """Unit eigenvector of symmetric 3x3 ``A`` for eigenvalue ``lam``: the
    cross product of two rows of ``A - lam I`` with the largest norm (the
    first of 01, 02, 12 on ties), or the x axis where all three vanish
    (a degenerate eigenvalue: any unit vector is an eigenvector)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    r0 = A[..., 0, :] - lam[..., None] * eye[0]
    r1 = A[..., 1, :] - lam[..., None] * eye[1]
    r2 = A[..., 2, :] - lam[..., None] * eye[2]

    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)

    n01 = (c01 * c01).sum(dim=-1)
    n02 = (c02 * c02).sum(dim=-1)
    n12 = (c12 * c12).sum(dim=-1)

    best01 = (n01 >= n02) & (n01 >= n12)
    best02 = ~best01 & (n02 >= n12)
    v = torch.where(best01[..., None], c01,
                    torch.where(best02[..., None], c02, c12))
    vnorm2 = (v * v).sum(dim=-1, keepdim=True)

    ok = vnorm2 > _TINY
    v = torch.where(ok, v, eye[0].expand_as(v))
    vnorm2 = torch.where(ok, vnorm2, 1.0)
    return v / torch.sqrt(vnorm2)


def _orthonormal_to(v, u):
    """``v`` minus its component along the unit ``u``, normalized; where
    that vanishes (``v`` parallel to ``u``), the axis least aligned with
    ``u`` in its place."""
    w = v - (v * u).sum(dim=-1, keepdim=True) * u
    axis = torch.eye(3, dtype=u.dtype, device=u.device)[u.abs().argmin(dim=-1)]
    alt = axis - (axis * u).sum(dim=-1, keepdim=True) * u
    w = torch.where((w * w).sum(dim=-1, keepdim=True) > 1e-12, w, alt)
    return w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)


def eigh3x3(A):
    """Closed-form symmetric 3x3 eigendecomposition, batched.

    Args:
      A: ``[..., 3, 3]`` symmetric matrices.

    Returns:
      ``(w, V)``: eigenvalues ``[..., 3]`` ascending and eigenvectors
      ``[..., 3, 3]``, ``V[..., :, i]`` the unit eigenvector of ``w[..., i]``;
      the middle one is the cross product of the other two. V is
      orthonormal for every input, scalar and rank-1 matrices included.
    """
    w0, w1, w2 = _eigvals3x3_sym(A)
    v0 = _eigvec_for(A, w0)
    v2 = _eigvec_for(A, w2)
    # One step more than the JAX package: v2 is made orthogonal to v0,
    # so that a degenerate spectrum (where both may be the fallback axis)
    # still gives an orthonormal V. Elsewhere this moves v2 by rounding.
    v2 = _orthonormal_to(v2, v0)
    v1 = torch.linalg.cross(v2, v0)
    n1 = torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    v1 = v1 / torch.clamp(n1, min=_TINY)
    return torch.stack([w0, w1, w2], dim=-1), torch.stack([v0, v1, v2],
                                                          dim=-1)


def chol_solve(A, rhs):
    """Solves ``A x = rhs`` for SPD ``A [..., n, n]`` (a static n) and
    ``rhs [..., n, m]`` by an unrolled Cholesky factorization (diagonal
    clamped at 1e-20) and two triangular substitutions; returns
    ``x [..., n, m]``."""
    n = A.shape[-1]
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    for j in range(n):
        s = a[j][j]
        for t in range(j):
            s = s - L[j][t] * L[j][t]
        L[j][j] = torch.sqrt(torch.clamp(s, min=_TINY))
        inv_diag[j] = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = a[i][j]
            for t in range(j):
                s = s - L[i][t] * L[j][t]
            L[i][j] = s * inv_diag[j]

    y = [None] * n  # L y = rhs
    for i in range(n):
        t = rhs[..., i, :]
        for kk in range(i):
            t = t - L[i][kk][..., None] * y[kk]
        y[i] = t * inv_diag[i][..., None]

    x = [None] * n  # L^T x = y
    for i in reversed(range(n)):
        t = y[i]
        for kk in range(i + 1, n):
            t = t - L[kk][i][..., None] * x[kk]
        x[i] = t * inv_diag[i][..., None]
    return torch.stack(x, dim=-2)
