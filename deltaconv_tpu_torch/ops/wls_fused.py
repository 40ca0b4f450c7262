"""Fused MLS operator construction (CUDA kernel + plain version).

Counterpart of ``deltaconv_tpu/ops/wls_fused.py``. The per-neighbourhood
pipeline of the grad/div build -- Gaussian weights, the quadratic-basis
normal equations, the unrolled 6x6 Cholesky solve, the height-field
partials, the inverse metric, the tangent-vector map and the div row --
runs as ONE kernel (``csrc/wls.cu``) over twelve ``[B, K, N]`` edge
planes. The planes come from one gathered ``[B, N, 9]`` neighbour table
(:func:`~.gather_rows.gather_rows`) and plain elementwise math; the
per-cloud infinity-norm normalization is a plain epilogue that scales
grad and div by the same scalar.
"""

from __future__ import annotations

import torch

from ..geometry.grad_div import GradDiv
from . import _lib
from .gather_rows import gather_rows

__all__ = ["build_grad_div_fused", "edge_planes", "wls", "wls_plain"]

_EPS = 1e-5


def _wls_math(planes, kernel_width, regularizer):
    """``_wls_math`` of the JAX package on ``[B, 12, K, N]`` planes,
    reducing over K (dim 1 of each ``[B, K, N]`` plane). Returns
    ``(g, d)``, each ``[B, 2, K, N]``."""
    (u, v, dist, patch, mask, d_xx, d_xy, d_yx, d_yy, d_nx, d_ny,
     avg) = planes.unbind(1)

    # 1. Normalized Gaussian weights.
    denom = torch.clamp((kernel_width * avg) ** 2, min=1e-20)
    w = torch.exp(-(dist * dist) / denom) * mask
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=_EPS)

    # 2. Quadratic patch basis.
    basis = [torch.ones_like(u), u, v, u * u, u * v, v * v]
    nb = 6

    # 3. Normal equations A = B^T W B + lam I (21 unique entries).
    A = [[None] * nb for _ in range(nb)]
    for i in range(nb):
        for j in range(i, nb):
            acc = (w * basis[i] * basis[j]).sum(dim=1, keepdim=True)
            if i == j:
                acc = acc + regularizer
            A[i][j] = acc

    # 4. Unrolled Cholesky.
    L = [[None] * nb for _ in range(nb)]
    inv_d = [None] * nb
    for j in range(nb):
        sdiag = A[j][j]
        for t in range(j):
            sdiag = sdiag - L[j][t] * L[j][t]
        L[j][j] = torch.sqrt(torch.clamp(sdiag, min=1e-20))
        inv_d[j] = 1.0 / L[j][j]
        for i in range(j + 1, nb):
            soff = A[j][i]
            for t in range(j):
                soff = soff - L[i][t] * L[j][t]
            L[i][j] = soff * inv_d[j]

    # 5. Solve A Z = (W B)^T: Z rows are per-edge wls coefficients.
    rhs = [w * bb for bb in basis]
    y = [None] * nb
    for i in range(nb):
        t = rhs[i]
        for kk in range(i):
            t = t - L[i][kk] * y[kk]
        y[i] = t * inv_d[i]
    z = [None] * nb
    for i in reversed(range(nb)):
        t = y[i]
        for kk in range(i + 1, nb):
            t = t - L[kk][i] * z[kk]
        z[i] = t * inv_d[i]

    g1, g2 = z[1], z[2]

    # 6. Height-field coefficients c_i = sum_k z_i patch.
    c = [(z[i] * patch).sum(dim=1, keepdim=True) for i in range(nb)]
    h_x = c[1] + 2.0 * c[3] * u + c[4] * v
    h_y = c[2] + c[4] * u + 2.0 * c[5] * v

    # 7. Inverse first fundamental form.
    det = 1.0 + h_x * h_x + h_y * h_y
    m11 = (1.0 + h_y * h_y) / det
    m12 = -(h_x * h_y) / det
    m22 = (1.0 + h_x * h_x) / det

    # 8. Basis transformation, linear in h.
    bt11 = d_xx + h_x * d_nx
    bt12 = d_xy + h_x * d_ny
    bt21 = d_yx + h_y * d_nx
    bt22 = d_yy + h_y * d_ny

    # 9. Vector mapping M = inv_metric @ bt; div row = grad row @ M.
    M11 = m11 * bt11 + m12 * bt21
    M12 = m11 * bt12 + m12 * bt22
    M21 = m12 * bt11 + m22 * bt21
    M22 = m12 * bt12 + m22 * bt22

    d1 = g1 * M11 + g2 * M21
    d2 = g1 * M12 + g2 * M22
    return torch.stack([g1, g2], dim=1), torch.stack([d1, d2], dim=1)


def wls_plain(edges, kernel_width: float, regularizer: float):
    """The plain PyTorch version: ``_wls_math`` on tensors."""
    return _wls_math(edges, float(kernel_width), float(regularizer))


def wls(edges, kernel_width: float, regularizer: float):
    """``edges [B, 12, K, N] -> (g, d)`` per-edge grad/div coefficients,
    each ``[B, 2, K, N]``. Plain version for CPU tensors; the CUDA kernel
    for CUDA tensors."""
    if edges.device.type == "cpu":
        return wls_plain(edges, kernel_width, regularizer)
    b, _, k, n = edges.shape
    device = _lib.check_inputs("wls", [
        ("edges", edges, torch.float32, (b, 12, k, n)),
    ])
    g = torch.empty((b, 2, k, n), dtype=torch.float32, device=device)
    d = torch.empty_like(g)
    _lib.launch("wls", device, edges.data_ptr(), g.data_ptr(), d.data_ptr(),
                b, k, n, float(kernel_width), float(regularizer))
    return g, d


def edge_planes(pos, normal, x_basis, y_basis, nbr_idx, nbr_mask, pm,
                gather_rows_fn=gather_rows):
    """The twelve ``[B, K, N]`` edge planes of the WLS kernel, stacked
    ``[B, 12, K, N]``: one gather of the ``[B, N, 9]`` neighbour table
    (positions and frames), then elementwise math."""
    b, n, _ = pos.shape
    k = nbr_idx.shape[-1]
    table = torch.cat([pos, x_basis, y_basis], dim=-1)
    comp = gather_rows_fn(table, nbr_idx)  # [B, 9, K, N]
    gx, gy, gz = comp[:, 0], comp[:, 1], comp[:, 2]  # neighbour pos
    xgx, xgy, xgz = comp[:, 3], comp[:, 4], comp[:, 5]  # neighbour xb
    ygx, ygy, ygz = comp[:, 6], comp[:, 7], comp[:, 8]  # neighbour yb

    def ctr(a):  # centre-point components, broadcast over K
        return a[..., 0][:, None], a[..., 1][:, None], a[..., 2][:, None]

    px, py, pz = ctr(pos)
    nx, ny, nz = ctr(normal)
    xbx, xby, xbz = ctr(x_basis)
    ybx, yby, ybz = ctr(y_basis)

    ox, oy, oz = gx - px, gy - py, gz - pz  # edge offsets [B, K, N]
    sq = ox * ox + oy * oy + oz * oz
    dist = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, 1.0)),
                       0.0)
    patch = ox * nx + oy * ny + oz * nz
    u = ox * xbx + oy * xby + oz * xbz
    v = ox * ybx + oy * yby + oz * ybz

    emk = nbr_mask.to(torch.float32).transpose(1, 2)  # [B, K, N]
    # Per-cloud mean of per-point mean edge lengths.
    cnt = torch.clamp(emk.sum(dim=1), min=1.0)
    point_mean = (dist * emk).sum(dim=1) / cnt  # [B, N]
    avg = (point_mean * pm).sum(dim=1) / torch.clamp(pm.sum(dim=1), min=1.0)

    return torch.stack([
        u, v, dist, patch, emk,
        xbx * xgx + xby * xgy + xbz * xgz,  # xb_i . xb_j
        xbx * ygx + xby * ygy + xbz * ygz,  # xb_i . yb_j
        ybx * xgx + yby * xgy + ybz * xgz,  # yb_i . xb_j
        ybx * ygx + yby * ygy + ybz * ygz,  # yb_i . yb_j
        nx * xgx + ny * xgy + nz * xgz,     # n_i . xb_j
        nx * ygx + ny * ygy + nz * ygz,     # n_i . yb_j
        avg[:, None, None].expand(b, k, n),
    ], dim=1)


def build_grad_div_fused(pos, normal, x_basis, y_basis, nbr_idx, nbr_mask,
                         kernel_width: float = 1.0,
                         regularizer: float = 0.001,
                         gather_rows_fn=gather_rows,
                         wls_fn=wls) -> GradDiv:
    """Batched operator build: ``pos [B, N, 3]`` etc. -> :class:`GradDiv`
    with normalized ``[B, N, K, 2]`` coefficients. ``gather_rows_fn`` and
    ``wls_fn`` select the kernels or their plain versions."""
    pm = nbr_mask.any(dim=2).to(torch.float32)
    edges = edge_planes(pos, normal, x_basis, y_basis, nbr_idx, nbr_mask,
                        pm, gather_rows_fn)
    g, d = wls_fn(edges, kernel_width, regularizer)
    # [B, 2, K, N] -> [B, N, K, 2]
    g = g.permute(0, 3, 2, 1)
    d = d.permute(0, 3, 2, 1)

    # Per-cloud infinity norm of grad; div scales identically (it is
    # linear in the grad row).
    row_norm = torch.linalg.vector_norm(g.abs().sum(dim=2), dim=-1) * pm
    inf_norm = row_norm.amax(dim=1)  # [B]
    scale = torch.where(inf_norm > 1e-5, 1.0 / inf_norm, 1.0)
    scale = scale[:, None, None, None]
    return GradDiv(nbr_idx=nbr_idx, nbr_mask=nbr_mask,
                   grad_coef=(g * scale).contiguous(),
                   div_coef=(d * scale).contiguous())
