"""Coefficient-form grad/div operators (counterpart of
``deltaconv_tpu/geometry/grad_div.py``) and their single-cloud build functions.

The batched operators of the models are built by
:func:`~deltaconv_tpu_torch.ops.wls_fused.build_grad_div_fused`; the
backbone densifies them (:mod:`.dense`) unless the model is built with
``dense_operators=False``, the large-cloud path, where the convs apply
them as they are: ``grad`` and ``div`` gather the ``K`` neighbour rows
and weight them by the coefficients (``ops.coef_apply_grad``,
``ops.coef_apply_div``), ``O(N K)`` where the dense form is ``O(N^2)``.

The build functions of one cloud (``[N, 3]`` positions and frames, ``[N, K]``
neighbour lists) keep the JAX names and signatures: the projected
coordinates, the Gaussian weights, the regularized quadratic WLS fit by
an unrolled Cholesky solve, the vector mapping of the fitted height
field, and :func:`build_grad_div` / :func:`build_grad_div_tables` on top.
Their torch math follows JAX's XLA functions term for term and runs for
CPU tensors, and on the card when ``shape_regularizer`` is set (the JAX
kernel has no such form either). On CUDA tensors without
``shape_regularizer`` the two builds run on the kernels of the models'
build (``gather_rows`` and ``wls``) as a batch of one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .linalg import chol_solve
from .nbr_ops import NeighborAggregations, one_cloud
from .utils import EPS, safe_norm

__all__ = ["GradDiv", "build_grad_div", "build_grad_div_tables",
           "coords_projected", "fit_vector_mapping", "gaussian_weights",
           "mean_edge_length", "weighted_least_squares"]


@dataclass(frozen=True)
class GradDiv(NeighborAggregations):
    """Gradient + divergence operators of a batch of clouds, or of one
    cloud (every tensor without its batch axis), and the ``ops``
    (kernels or plain versions) they and the neighbour aggregations go
    through.

    Attributes:
      nbr_idx: ``[B, N, K]`` int32 neighbour indices (self in slot 0).
      nbr_mask: ``[B, N, K]`` bool edge validity.
      grad_coef: ``[B, N, K, 2]`` f32: ``(grad x)[n, d] = sum_k
        grad_coef[n, k, d] * x[nbr_idx[n, k]]``.
      div_coef: ``[B, N, K, 2]`` f32: ``(div v)[n] = sum_k sum_d
        div_coef[n, k, d] * v[nbr_idx[n, k], d]``.
      ops: ``ops.Ops``.
      plan: the gather plan of ``nbr_idx`` (``ops.CoefPlan``), or None;
        ``build_operators`` fills it, and the applies of wide rows take
        it (the same results, fewer row reads).
    """

    nbr_idx: torch.Tensor
    nbr_mask: torch.Tensor
    grad_coef: torch.Tensor
    div_coef: torch.Tensor
    ops: object
    plan: object = None

    int8 = False  # no quantized form (the int8 serving mode is dense)

    @one_cloud("x")
    def grad(self, x):
        """``[B, N, C] -> [B, N, 2, C]`` in ``x``'s dtype (``[N, C] ->
        [N, 2, C]`` on one cloud); ``x`` may be a strided view (the
        kernels read contiguous rows, so a view is copied first)."""
        return self.ops.coef_apply_grad(x.contiguous(), self.grad_coef,
                                        self.nbr_idx, self.plan)

    @one_cloud("v")
    def div(self, v):
        """``[B, N, 2, C] -> [B, N, C]`` in ``v``'s dtype (``[N, 2, C] ->
        [N, C]`` on one cloud)."""
        return self.ops.coef_apply_div(v.contiguous(), self.div_coef,
                                       self.nbr_idx, self.plan)


def _coords_projected_tables(pos_tab, pc, nc, xc, yc, nbr_idx):
    """Tangent coordinates with a separate neighbour table and centre
    rows (the math of :func:`coords_projected`)."""
    offsets = pos_tab[nbr_idx.long()] - pc[:, None, :]  # [N, K, 3]
    planar = offsets - nc[:, None, :] * (
        offsets * nc[:, None, :]).sum(dim=-1, keepdim=True)
    u = (planar * xc[:, None, :]).sum(dim=-1)
    v = (planar * yc[:, None, :]).sum(dim=-1)
    return torch.stack([u, v], dim=-1)


def coords_projected(pos, normal, x_basis, y_basis, nbr_idx):
    """Tangent-plane ``(u, v)`` coordinates of each neighbour offset,
    ``[N, K, 2]``."""
    return _coords_projected_tables(pos, pos, normal, x_basis, y_basis,
                                    nbr_idx)


def gaussian_weights(dist, nbr_mask=None, point_mask=None,
                     kernel_width: float = 1.0, avg=None):
    """Per-edge Gaussian weights ``exp(-d^2 / (kernel_width * avg)^2)``
    of the edge lengths ``dist [N, K]``, normalized to sum to one over
    each neighbourhood. ``avg`` (default: the cloud's mean of per-point
    mean edge lengths over ``point_mask``) may be given, as the
    point-sharded build passes a global one. Masked edges weigh zero
    before the averaging and the normalization."""
    if nbr_mask is None:
        nbr_mask = torch.ones_like(dist, dtype=torch.bool)
    em = nbr_mask.to(dist.dtype)
    if avg is None:
        total, count = mean_edge_length(dist, nbr_mask, point_mask)
        avg = total / torch.clamp(count, min=1.0)
    w = torch.exp(-(dist * dist) / torch.clamp(
        torch.as_tensor((kernel_width * avg) ** 2, dtype=dist.dtype),
        min=1e-20)) * em
    return w / torch.clamp(w.sum(dim=1, keepdim=True), min=EPS)


def mean_edge_length(dist, nbr_mask=None, point_mask=None):
    """The cloud's mean of per-point mean edge lengths as a ``(sum,
    count)`` pair of 0-d tensors: the two partial reductions a
    point-sharded build completes across its ranks before dividing."""
    if nbr_mask is None:
        nbr_mask = torch.ones_like(dist, dtype=torch.bool)
    em = nbr_mask.to(dist.dtype)
    cnt = torch.clamp(em.sum(dim=1), min=1.0)
    point_mean = (dist * em).sum(dim=1) / cnt  # [N]
    if point_mask is None:
        return point_mean.sum(), torch.tensor(float(dist.shape[0]),
                                              device=dist.device)
    pm = point_mask.to(dist.dtype)
    return (point_mean * pm).sum(), pm.sum()


def _poly_basis(coords):
    """The quadratic patch basis ``[1, u, v, u^2, uv, v^2]``,
    ``[N, K, 6]``."""
    u, v = coords[..., 0], coords[..., 1]
    return torch.stack([torch.ones_like(u), u, v, u * u, u * v, v * v],
                       dim=-1)


def weighted_least_squares(coords, weights, regularizer: float,
                           shape_regularizer: Optional[float] = None):
    """The regularized WLS solve of each neighbourhood's quadratic patch:
    ``(B^T W B + lam I) c = B^T W f`` for the linear map from the samples
    ``f`` to the coefficients ``c``, as ``wls [N, K, 6]`` with ``c[n] =
    sum_k wls[n, k, :] f[n, k]``, by the unrolled Cholesky solve
    (``linalg.chol_solve``). With ``shape_regularizer``, also the solve at
    that lambda: ``(wls, wls_shape)``."""
    basis = _poly_basis(coords)  # [N, K, 6]
    wb = weights[..., None] * basis  # [N, K, 6]
    a = torch.einsum("nki,nkj->nij", wb, basis)  # [N, 6, 6]
    eye = torch.eye(6, dtype=a.dtype, device=a.device)

    def solve(lam):
        return chol_solve(a + lam * eye, wb.transpose(-1, -2)).transpose(
            -1, -2)

    wls = solve(regularizer)
    if shape_regularizer is not None:
        return wls, solve(shape_regularizer)
    return wls


def fit_vector_mapping(pos, normal, x_basis, y_basis, nbr_idx, wls, coords,
                       center_idx=None):
    """The per-edge 2x2 map from a neighbour's tangent basis into its
    centre's, ``[N, K, 2, 2]``: the height field fitted by ``wls`` to the
    normal offsets, the centre frame pushed forward to each neighbour,
    contracted with the inverse first fundamental form. ``center_idx``
    (``[N]``, optional) selects the centres out of ``pos`` (default:
    every point)."""
    if center_idx is None:
        pc, nc, xc, yc = pos, normal, x_basis, y_basis
    else:
        ci = center_idx.long()
        pc, nc, xc, yc = pos[ci], normal[ci], x_basis[ci], y_basis[ci]
    return _fit_vector_mapping_tables(pos, x_basis, y_basis, pc, nc, xc, yc,
                                      nbr_idx, wls, coords)


def _fit_vector_mapping_tables(pos_tab, xb_tab, yb_tab, pc, nc, xc, yc,
                               nbr_idx, wls, coords):
    """:func:`fit_vector_mapping` with explicit neighbour tables and
    centre rows."""
    idx = nbr_idx.long()
    offsets = pos_tab[idx] - pc[:, None, :]  # [N, K, 3]
    patch_f = (offsets * nc[:, None, :]).sum(dim=-1)  # [N, K]
    coeff = torch.einsum("nkc,nk->nc", wls, patch_f)  # [N, 6]

    u, v = coords[..., 0], coords[..., 1]
    h_x = coeff[:, 1, None] + 2.0 * coeff[:, 3, None] * u + coeff[:, 4,
                                                                  None] * v
    h_y = coeff[:, 2, None] + coeff[:, 4, None] * u + 2.0 * coeff[:, 5,
                                                                  None] * v

    # The centre frame pushed forward to the neighbour's parameter point.
    gamma_x = xc[:, None, :] + nc[:, None, :] * h_x[..., None]
    gamma_y = yc[:, None, :] + nc[:, None, :] * h_y[..., None]

    # The inverse first fundamental form.
    det = 1.0 + h_x * h_x + h_y * h_y
    e = 1.0 + h_x * h_x
    f = h_x * h_y
    g = 1.0 + h_y * h_y
    inv_metric = torch.stack([torch.stack([g, -f], dim=-1),
                              torch.stack([-f, e], dim=-1)],
                             dim=-2) / det[..., None, None]  # [N, K, 2, 2]

    xb_j, yb_j = xb_tab[idx], yb_tab[idx]  # [N, K, 3]
    bt = torch.stack([
        torch.stack([(gamma_x * xb_j).sum(-1), (gamma_x * yb_j).sum(-1)],
                    dim=-1),
        torch.stack([(gamma_y * xb_j).sum(-1), (gamma_y * yb_j).sum(-1)],
                    dim=-1),
    ], dim=-2)  # [N, K, 2, 2]
    return torch.einsum("nkab,nkbc->nkac", inv_metric, bt)


def build_grad_div(pos, normal, x_basis, y_basis, nbr_idx, nbr_mask=None,
                   point_mask=None, kernel_width: float = 1.0,
                   regularizer: float = 0.001, normalized: bool = True,
                   shape_regularizer: Optional[float] = None,
                   ops=None) -> GradDiv:
    """The grad/div operators of one cloud.

    Args:
      pos, normal, x_basis, y_basis: ``[N, 3]``.
      nbr_idx: ``[N, K]`` int32, self in slot 0.
      nbr_mask: optional ``[N, K]`` bool edge validity.
      point_mask: optional ``[N]`` bool point validity.
      kernel_width: Gaussian kernel width relative to the mean edge
        length.
      regularizer: the WLS Tikhonov lambda of the signal fit.
      normalized: divide grad (and div, its composition) by the cloud's
        infinity norm of grad.
      shape_regularizer: optional separate lambda of the surface fit
        that the vector mapping uses.
      ops: the ``ops.Ops`` of the returned operators (and of the build on
        the card); None: the kernels.

    Returns a single-cloud :class:`GradDiv` (``[N, K]`` lists, ``[N, K,
    2]`` coefficients); see the module docstring for the route.
    """
    return build_grad_div_tables(
        pos, x_basis, y_basis, pos, normal, x_basis, y_basis, nbr_idx,
        nbr_mask=nbr_mask, point_mask=point_mask, kernel_width=kernel_width,
        regularizer=regularizer, normalized=normalized,
        shape_regularizer=shape_regularizer, ops=ops)


def build_grad_div_tables(pos_tab, xb_tab, yb_tab, pc, nc, xc, yc, nbr_idx,
                          nbr_mask=None, point_mask=None,
                          kernel_width: float = 1.0,
                          regularizer: float = 0.001,
                          normalized: bool = True,
                          shape_regularizer: Optional[float] = None,
                          avg_reduce=None, max_reduce=None,
                          ops=None) -> GradDiv:
    """:func:`build_grad_div` on explicit neighbour tables ``pos_tab,
    xb_tab, yb_tab [N_total, 3]`` (``nbr_idx`` indexes them) and centre
    rows ``pc, nc, xc, yc [N, 3]``. ``avg_reduce(sum, count)`` (0-d
    tensors) completes the mean edge length and ``max_reduce(m)`` the
    infinity norm, as a point-sharded build passes collectives (default:
    ``sum / count`` and the identity)."""
    if ops is None:
        from ..ops import KERNEL_OPS as ops
    if shape_regularizer is None and pc.device.type == "cuda":
        return _tables_on_kernels(
            pos_tab, xb_tab, yb_tab, pc, nc, xc, yc, nbr_idx, nbr_mask,
            point_mask, kernel_width, regularizer, normalized, avg_reduce,
            max_reduce, ops)
    return _tables_math(pos_tab, xb_tab, yb_tab, pc, nc, xc, yc, nbr_idx,
                        nbr_mask, point_mask, kernel_width, regularizer,
                        normalized, shape_regularizer, avg_reduce,
                        max_reduce, ops)


def _tables_math(pos_tab, xb_tab, yb_tab, pc, nc, xc, yc, nbr_idx,
                 nbr_mask=None, point_mask=None, kernel_width: float = 1.0,
                 regularizer: float = 0.001, normalized: bool = True,
                 shape_regularizer: Optional[float] = None, avg_reduce=None,
                 max_reduce=None, ops=None) -> GradDiv:
    """The torch math of :func:`build_grad_div_tables` (JAX's XLA build,
    term for term) on any device."""
    if ops is None:
        from ..ops import KERNEL_OPS as ops
    if nbr_mask is None:
        nbr_mask = torch.ones(nbr_idx.shape, dtype=torch.bool,
                              device=nbr_idx.device)
    if point_mask is not None:
        nbr_mask = nbr_mask & point_mask[:, None]
    # Keep the gather indices in bounds on masked slots.
    nbr_idx = torch.where(nbr_mask, nbr_idx, 0).to(torch.int32)

    coords = _coords_projected_tables(pos_tab, pc, nc, xc, yc, nbr_idx)
    dist = safe_norm(pos_tab[nbr_idx.long()] - pc[:, None, :], dim=-1)
    avg = None
    if avg_reduce is not None:
        avg = avg_reduce(*mean_edge_length(dist, nbr_mask, point_mask))
    weights = gaussian_weights(dist, nbr_mask, point_mask, kernel_width,
                               avg=avg)

    if shape_regularizer is None:
        wls = wls_shape = weighted_least_squares(coords, weights,
                                                 regularizer)
    else:
        wls, wls_shape = weighted_least_squares(coords, weights, regularizer,
                                                shape_regularizer)

    # The gradient at the patch's origin: the rows of c1 (d/du), c2 (d/dv).
    grad_coef = wls[..., 1:3]  # [N, K, 2]
    if normalized:
        # The cloud's infinity norm of grad: the row sums of |coef| per
        # point and component, their L2 norm, the max over valid points.
        row_norm = torch.linalg.vector_norm(grad_coef.abs().sum(dim=1),
                                            dim=-1)  # [N]
        if point_mask is not None:
            row_norm = torch.where(point_mask, row_norm, 0.0)
        inf_norm = row_norm.amax()
        if max_reduce is not None:
            inf_norm = max_reduce(inf_norm)
        grad_coef = torch.where(inf_norm > 1e-5, grad_coef / inf_norm,
                                grad_coef)

    vec_map = _fit_vector_mapping_tables(pos_tab, xb_tab, yb_tab, pc, nc, xc,
                                         yc, nbr_idx, wls_shape, coords)
    # The div row: the grad row composed with the per-edge vector mapping.
    div_coef = torch.einsum("nkd,nkde->nke", grad_coef, vec_map)
    # Contiguous: the applies' kernels read whole coefficient rows.
    return GradDiv(nbr_idx=nbr_idx, nbr_mask=nbr_mask,
                   grad_coef=grad_coef.contiguous(),
                   div_coef=div_coef.contiguous(), ops=ops)


def _tables_on_kernels(pos_tab, xb_tab, yb_tab, pc, nc, xc, yc, nbr_idx,
                       nbr_mask=None, point_mask=None,
                       kernel_width: float = 1.0, regularizer: float = 0.001,
                       normalized: bool = True, avg_reduce=None,
                       max_reduce=None, ops=None) -> GradDiv:
    """:func:`build_grad_div_tables` without a shape regularizer on the
    build's kernels (``ops.gather_rows``, ``ops.wls``), the cloud a batch
    of one; the reduction hooks see 0-d tensors, as the torch math's."""
    from ..ops import wls_fused

    if nbr_mask is None:
        nbr_mask = torch.ones(nbr_idx.shape, dtype=torch.bool,
                              device=nbr_idx.device)
    avg = mx = None
    if avg_reduce is not None:
        def avg(total, count):
            return torch.as_tensor(avg_reduce(total[0], count[0])).reshape(1)
    if max_reduce is not None:
        def mx(m):
            return torch.as_tensor(max_reduce(m[0])).reshape(1)
    table = torch.cat([pos_tab, xb_tab, yb_tab], dim=-1)[None]
    gd = wls_fused.build_grad_div_tables(
        table, pc[None], nc[None], xc[None], yc[None], nbr_idx[None],
        nbr_mask[None], None if point_mask is None else point_mask[None],
        kernel_width, regularizer, avg, mx, ops, normalized=normalized)
    return gd.unbatched()
