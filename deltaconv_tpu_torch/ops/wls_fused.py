"""Fused MLS operator construction (CUDA kernel + plain version).

Counterpart of ``deltaconv_tpu/ops/wls_fused.py``. The per-neighbourhood
pipeline of the grad/div build -- Gaussian weights, the quadratic-basis
normal equations, the unrolled 6x6 Cholesky solve, the height-field
partials, the inverse metric, the tangent-vector map and the div row --
runs as ONE kernel (``csrc/wls.cu``) over twelve ``[B, K, N]`` edge
planes. Its route by shape (:func:`wls_split`): up to ``WLS_MAX_SLICES x
WLS_EDGES`` = 40 edges a point a block takes 32 points x S warps, each
warp E of a point's edges in registers, the sums over K across the warps
in a fixed order (``wls``, ``wls_bwd``); above, the direct kernels, a
thread a point over all its edges (``wls_direct``, ``wls_bwd_direct``).
The planes come from one gathered ``[B, N, 9]`` neighbour table
(:func:`~.gather_rows.gather_rows`) and plain elementwise math; the
per-cloud infinity-norm normalization is a plain epilogue that scales
grad and div by the same scalar. :func:`build_grad_div_tables` is the
table form (JAX's ``build_grad_div_tables``): the centre rows of one
shard against the whole cloud's table, with hooks that complete the
mean edge length and the infinity norm across the ranks of a
point-sharded cloud.

The build is differentiable in the positions and frames, as the JAX
``custom_vjp``s are: the gather through ``scatter_rows``, :func:`wls`
through :func:`wls_bwd` (the VJP of ``_wls_math`` with respect to the
twelve planes, one kernel, counterpart of ``_wls_bwd_pallas``), the
planes and the normalization through autograd.
"""

from __future__ import annotations

import functools

import torch

from ..geometry.grad_div import GradDiv
from . import _lib
from .gather_rows import gather_rows

__all__ = ["WLS_EDGES", "WLS_MAX_SLICES", "WLS_POINTS", "WLS_SMEM_MAX",
           "build_grad_div_fused", "build_grad_div_tables", "edge_planes",
           "edge_planes_tables", "wls", "wls_bwd", "wls_bwd_plain",
           "wls_plain", "wls_smem", "wls_split"]

_EPS = 1e-5

# The split route of the WLS kernels (csrc/wls.cu, its constants of the
# same meaning): a block takes WLS_POINTS consecutive points of one cloud
# (a lane each) x S warps; warp s holds edges s, s + S, ... of its
# lane's point, E = ceil(K / S) of them, at most WLS_EDGES, in
# registers; S at most WLS_MAX_SLICES. The forward and the backward take
# the same route. The sums over K pass through wls_smem(S) bytes of
# dynamic shared memory, under the 48 KB a block gets without opting in.
WLS_POINTS = 32
WLS_MAX_SLICES = 8
WLS_EDGES = 5
WLS_SMEM_MAX = 48 * 1024
_WLS_SUMS = 21  # the most sums over K taken at once (a symmetric 6x6)


@functools.lru_cache(maxsize=256)
def wls_split(k: int) -> tuple[int, int]:
    """The route of the WLS forward and backward for ``k`` edges a point:
    ``(S, E)``, the split route's warps a block and slots a warp, S the
    fewest warps whose slots (at most WLS_EDGES) hold ``k`` edges and E
    the fewest slots for that S (4 x 5 at K=20, 6 x 5 at K=30: on the
    H100 the fewest warps were the fastest at both, PERF.md section 6); or
    ``(0, 0)``, the direct route (a route by shape, not a fallback) above
    ``WLS_MAX_SLICES`` x WLS_EDGES. Cached: the wrappers ask at every
    call."""
    s = max(1, -(-k // WLS_EDGES))
    if s > WLS_MAX_SLICES:
        return 0, 0
    return s, max(1, -(-k // s))


def wls_smem(s: int) -> int:
    """Dynamic shared memory of a split-route block of ``s`` warps: each
    warp's partial sums, up to _WLS_SUMS a point, as ``split_smem`` in
    the CUDA source counts them."""
    return s * _WLS_SUMS * WLS_POINTS * 4


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


def _wls_kernel(edges, kernel_width, regularizer, slices=None):
    """The forward for CUDA tensors on the split route with ``slices``
    warps a block, or with 0 on the direct route; None: :func:`wls_split`
    (plain version for CPU tensors)."""
    if edges.device.type == "cpu":
        return wls_plain(edges, kernel_width, regularizer)
    b, _, k, n = edges.shape
    device = _lib.check_inputs("wls", [
        ("edges", edges, torch.float32, (b, 12, k, n)),
    ])
    if slices is None:
        slices = wls_split(k)[0]
    g = edges.new_empty((b, 2, k, n))
    d = torch.empty_like(g)
    args = (edges.data_ptr(), g.data_ptr(), d.data_ptr(), b, k, n)
    tail = (float(kernel_width), float(regularizer))
    if slices:
        _lib.launch("wls", device, *args, slices, *tail)
    else:
        _lib.launch("wls_direct", device, *args, *tail)
    return g, d


def wls_bwd_plain(edges, ctg, ctd, kernel_width: float, regularizer: float):
    """The plain PyTorch version of the VJP: ``torch.autograd.grad``
    through ``_wls_math``."""
    with torch.enable_grad():
        e = edges.detach().requires_grad_()
        g, d = _wls_math(e, float(kernel_width), float(regularizer))
        (de,) = torch.autograd.grad((g, d), e, (ctg, ctd))
    return de


def wls_bwd(edges, ctg, ctd, kernel_width: float, regularizer: float):
    """The VJP of :func:`wls` with respect to its planes: ``edges [B, 12,
    K, N]`` and the cotangents ``ctg, ctd [B, 2, K, N]`` -> ``[B, 12, K,
    N]`` f32. Plain version for CPU tensors; for CUDA tensors the
    ``wls_bwd`` kernel, or ``wls_bwd_direct`` above the split route's
    edges (:func:`wls_split`)."""
    return _wls_bwd(edges, ctg, ctd, kernel_width, regularizer)


def _wls_bwd(edges, ctg, ctd, kernel_width, regularizer, slices=None):
    """:func:`wls_bwd` on the split route with ``slices`` warps a block,
    or with 0 on the direct route; None: :func:`wls_split`."""
    if edges.device.type == "cpu":
        return wls_bwd_plain(edges, ctg, ctd, kernel_width, regularizer)
    b, _, k, n = edges.shape
    device = _lib.check_inputs("wls_bwd", [
        ("edges", edges, torch.float32, (b, 12, k, n)),
        ("ctg", ctg, torch.float32, (b, 2, k, n)),
        ("ctd", ctd, torch.float32, (b, 2, k, n)),
    ])
    if slices is None:
        slices = wls_split(k)[0]
    de = torch.empty_like(edges)
    args = (edges.data_ptr(), ctg.data_ptr(), ctd.data_ptr(), de.data_ptr(),
            b, k, n)
    tail = (float(kernel_width), float(regularizer))
    if slices:
        _lib.launch("wls_bwd", device, *args, slices, *tail)
    else:
        _lib.launch("wls_bwd_direct", device, *args, *tail)
    return de


class _Wls(torch.autograd.Function):
    """:func:`wls` with its VJP (:func:`wls_bwd`)."""

    @staticmethod
    def forward(ctx, edges, kernel_width, regularizer):
        edges = edges.detach()
        ctx.save_for_backward(edges)
        ctx.params = (kernel_width, regularizer)
        return _wls_kernel(edges, kernel_width, regularizer)

    @staticmethod
    def backward(ctx, ctg, ctd):
        (edges,) = ctx.saved_tensors
        de = wls_bwd(edges, ctg.float().contiguous(),
                     ctd.float().contiguous(), *ctx.params)
        return de, None, None


def wls(edges, kernel_width: float, regularizer: float):
    """``edges [B, 12, K, N] -> (g, d)`` per-edge grad/div coefficients,
    each ``[B, 2, K, N]``. Plain version for CPU tensors; for CUDA tensors
    the ``wls`` kernel, or ``wls_direct`` above the split route's edges
    (:func:`wls_split`). Differentiable in ``edges`` (its backward is
    :func:`wls_bwd`)."""
    if edges.requires_grad and torch.is_grad_enabled():
        return _Wls.apply(edges, float(kernel_width), float(regularizer))
    return _wls_kernel(edges, kernel_width, regularizer)


def edge_planes_tables(table, pc, nc, xc, yc, nbr_idx, nbr_mask, pm,
                       gather_rows_fn=gather_rows, avg_reduce=None):
    """The twelve ``[B, K, N]`` edge planes of the WLS kernel, stacked
    ``[B, 12, K, N]``, from a neighbour table ``[B, Nt, 9]`` (positions
    and frames; ``nbr_idx [B, N, K]`` indexes it) and the centre rows
    ``pc, nc, xc, yc [B, N, 3]``: one gather, then elementwise math.
    ``pm [B, N]`` f32 marks the valid centres; ``avg_reduce(sum, count)``
    completes the per-cloud mean edge length (default: ``sum / count``,
    the point-sharded build sums both over the ranks first)."""
    b, n, _ = pc.shape
    k = nbr_idx.shape[-1]
    comp = gather_rows_fn(table, nbr_idx)  # [B, 9, K, N]
    gx, gy, gz = comp[:, 0], comp[:, 1], comp[:, 2]  # neighbour pos
    xgx, xgy, xgz = comp[:, 3], comp[:, 4], comp[:, 5]  # neighbour xb
    ygx, ygy, ygz = comp[:, 6], comp[:, 7], comp[:, 8]  # neighbour yb

    def ctr(a):  # centre-point components, broadcast over K
        return a[..., 0][:, None], a[..., 1][:, None], a[..., 2][:, None]

    px, py, pz = ctr(pc)
    nx, ny, nz = ctr(nc)
    xbx, xby, xbz = ctr(xc)
    ybx, yby, ybz = ctr(yc)

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
    total, count = (point_mean * pm).sum(dim=1), pm.sum(dim=1)
    avg = (total / torch.clamp(count, min=1.0) if avg_reduce is None
           else avg_reduce(total, count))

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


def edge_planes(pos, normal, x_basis, y_basis, nbr_idx, nbr_mask, pm,
                gather_rows_fn=gather_rows):
    """:func:`edge_planes_tables` of one batch of clouds, whose points are
    both the table and the centres."""
    table = torch.cat([pos, x_basis, y_basis], dim=-1)
    return edge_planes_tables(table, pos, normal, x_basis, y_basis, nbr_idx,
                              nbr_mask, pm, gather_rows_fn)


def build_grad_div_tables(table, pc, nc, xc, yc, nbr_idx, nbr_mask,
                          point_mask=None, kernel_width: float = 1.0,
                          regularizer: float = 0.001, avg_reduce=None,
                          max_reduce=None, ops=None,
                          normalized: bool = True) -> GradDiv:
    """The operators of the centre rows ``pc, nc, xc, yc [B, N, 3]`` whose
    neighbours ``nbr_idx [B, N, K]`` index ``table [B, Nt, 9]`` (the
    positions and frames of the whole cloud): the counterpart of JAX's
    ``build_grad_div_tables``, on the port's kernels. ``point_mask [B,
    N]`` marks the valid centres; ``avg_reduce(sum, count)`` completes
    the mean edge length and ``max_reduce`` the infinity norm across the
    ranks of a point-sharded cloud; ``normalized=False`` leaves out the
    infinity-norm normalization. The returned :class:`GradDiv` keeps
    index 0 on its masked slots (JAX's convention), so filler columns
    beyond the table never reach a gather."""
    if ops is None:
        from . import KERNEL_OPS as ops
    if point_mask is not None:
        nbr_mask = nbr_mask & point_mask[:, :, None]
    nbr_idx = torch.where(nbr_mask, nbr_idx, 0).to(torch.int32)
    pm = nbr_mask.any(dim=2).to(torch.float32)
    edges = edge_planes_tables(table, pc, nc, xc, yc, nbr_idx, nbr_mask, pm,
                               ops.gather_rows, avg_reduce)
    g, d = ops.wls(edges, kernel_width, regularizer)
    return _normalized(g, d, nbr_idx, nbr_mask, pm, max_reduce, ops,
                       normalized)


def _normalized(g, d, nbr_idx, nbr_mask, pm, max_reduce, ops,
                normalized: bool = True) -> GradDiv:
    """``[B, 2, K, N]`` coefficients -> :class:`GradDiv` ``[B, N, K, 2]``,
    divided by the per-cloud infinity norm of grad (div scales with it:
    it is linear in the grad row) unless ``normalized`` is False."""
    g = g.permute(0, 3, 2, 1)
    d = d.permute(0, 3, 2, 1)
    scale = 1.0
    if normalized:
        row_norm = torch.linalg.vector_norm(g.abs().sum(dim=2), dim=-1) * pm
        inf_norm = row_norm.amax(dim=1)  # [B]
        if max_reduce is not None:
            inf_norm = max_reduce(inf_norm)
        scale = torch.where(inf_norm > 1e-5, 1.0 / inf_norm, 1.0)
        scale = scale[:, None, None, None]
    return GradDiv(nbr_idx=nbr_idx, nbr_mask=nbr_mask,
                   grad_coef=(g * scale).contiguous(),
                   div_coef=(d * scale).contiguous(), ops=ops)


def build_grad_div_fused(pos, normal, x_basis, y_basis, nbr_idx, nbr_mask,
                         kernel_width: float = 1.0,
                         regularizer: float = 0.001, ops=None) -> GradDiv:
    """Batched operator build: ``pos [B, N, 3]`` etc. -> :class:`GradDiv`
    with normalized ``[B, N, K, 2]`` coefficients. ``ops`` (``ops.Ops``;
    None: the kernels) selects the kernels or their plain versions, for
    the build's gather and WLS solve and for every later apply and
    aggregation of the returned operators."""
    if ops is None:
        from . import KERNEL_OPS as ops
    pm = nbr_mask.any(dim=2).to(torch.float32)
    edges = edge_planes(pos, normal, x_basis, y_basis, nbr_idx, nbr_mask,
                        pm, ops.gather_rows)
    g, d = ops.wls(edges, kernel_width, regularizer)
    return _normalized(g, d, nbr_idx, nbr_mask, pm, None, ops)
