"""The port's geometry against the JAX package's on the CPU: the
single-cloud grad/div build functions, the vector-field operators, parallel
transport, the tiled kNN, the single-cloud operator objects, hooks and
DeltaConv, and the property tests of ``tests/geometry`` and
``tests/nn/test_deltaconv.py`` run on the port.

Tolerances, each stated where it is used:

- the builds' coefficients within 1e-4 x max|coef| (f32 math in another
  order: XLA contracts products into FMAs and sums in its own order);
- the operators' outputs within 1e-4 x max|output|;
- ``build_transport``, ``rotate_around`` and ``angle_in_plane`` within
  1e-5;
- ``knn_tiled``'s ids equal to JAX's (on a tie grid too);
- single-cloud hooks and ``DeltaConv`` bit-equal to the port's batch of
  one, and within 1e-5 x max of JAX's unbatched call (f32; the JAX side
  on the same coefficients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.geometry as jgeo
from deltaconv_tpu.geometry import connection as jconn
from deltaconv_tpu.geometry import grad_div as jgd
from deltaconv_tpu.geometry import operators as jops
from deltaconv_tpu.geometry.grad_div import GradDiv as JaxGradDiv
from deltaconv_tpu.models.deltanet_base import \
    build_operators as jax_build_operators
from deltaconv_tpu.nn.deltaconv import DeltaConv as JaxDeltaConv
import deltaconv_tpu_torch.geometry as geo
from deltaconv_tpu_torch import KERNEL_OPS, state_dict_from_flax
from deltaconv_tpu_torch.geometry import connection as conn
from deltaconv_tpu_torch.geometry import grad_div as gdm
from deltaconv_tpu_torch.geometry.knn import top_k
from deltaconv_tpu_torch.geometry import operators as tops
from deltaconv_tpu_torch.models import build_operators
from deltaconv_tpu_torch.nn import DeltaConv

torch.set_num_threads(1)

COEF_REL = 1e-4  # x max|coef|: the builds' coefficients against JAX
OP_REL = 1e-4  # x max|out|: curl, laplacian, hodge_laplacian against JAX
CONN_ATOL = 1e-5  # build_transport, rotate_around, angle_in_plane
LAYER_REL = 1e-5  # x max|out|: DeltaConv and hooks against JAX


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _poly_basis_np(coords):
    u, v = coords[..., 0], coords[..., 1]
    return np.stack([np.ones_like(u), u, v, u * u, u * v, v * v], axis=-1)


def _surface(rng, n=1000):
    """A random quadratic height field with its analytic frames (the
    JAX package's ``tests/geometry/test_grad_div.py`` fixture)."""
    coords = (rng.random((n, 2)) * 2 - 1).astype(np.float32)
    c = rng.random(6).astype(np.float32)
    f = (_poly_basis_np(coords) * c[None, :]).sum(-1, keepdims=True)
    pos = np.concatenate([coords, f], axis=1).astype(np.float32)
    x, y = coords[:, 0], coords[:, 1]
    dfdx = np.stack([np.ones_like(x), np.zeros_like(x),
                     c[1] + 2 * c[3] * x + c[4] * y], axis=1)
    dfdy = np.stack([np.zeros_like(x), np.ones_like(x),
                     c[2] + c[4] * x + 2 * c[5] * y], axis=1)
    normal = np.cross(dfdx, dfdy)
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True), 1e-8)
    x_basis = dfdx / np.maximum(np.linalg.norm(dfdx, axis=1, keepdims=True),
                                1e-8)
    y_basis = np.cross(normal, x_basis)
    return (pos, normal.astype(np.float32), x_basis.astype(np.float32),
            y_basis.astype(np.float32), f.astype(np.float32))


def _graph(pos, k, masked=False, seed=0):
    """JAX's kNN graph of one cloud (shared by both packages), and with
    ``masked`` a point mask (a fifth of the points padded) and a few
    more masked edges."""
    idx, mask = jgeo.knn(jnp.asarray(pos), k)
    idx, mask = np.asarray(idx), np.asarray(mask)
    pm = None
    if masked:
        r = np.random.default_rng(seed)
        pm = r.random(len(pos)) > 0.2
        mask = mask & (r.random(mask.shape) > 0.1)
        mask[:, 0] = True
    return idx, mask, pm


def _cloud(rng, n=300, k=16, masked=False):
    pos, normal, xb, yb, f = _surface(rng, n)
    idx, mask, pm = _graph(pos, k, masked)
    return pos, normal, xb, yb, f, idx, mask, pm


def test_geometry_exports_cover_jax():
    assert set(jgeo.__all__) <= set(geo.__all__)
    for name in jgeo.__all__:
        assert callable(getattr(geo, name)), name


@pytest.mark.parametrize("masked", [False, True])
def test_coords_weights_and_mean_edge_length_match_jax(masked):
    """``coords_projected``, ``mean_edge_length`` and ``gaussian_weights``
    (their own average, a given one, a kernel width) within 1e-5 x max."""
    rng = np.random.default_rng(1)
    pos, normal, xb, yb, _, idx, mask, pm = _cloud(rng, masked=masked)
    got = gdm.coords_projected(*map(_t, (pos, normal, xb, yb, idx)))
    want = jgd.coords_projected(*map(jnp.asarray, (pos, normal, xb, yb,
                                                   idx)))
    _close(got, want, 1e-5, "coords")
    dist = np.linalg.norm(pos[idx] - pos[:, None], axis=-1).astype(
        np.float32)
    jm = None if not masked else jnp.asarray(mask)
    tm = None if not masked else _t(mask)
    jpm = None if pm is None else jnp.asarray(pm)
    tpm = None if pm is None else _t(pm)
    for a, b in zip(gdm.mean_edge_length(_t(dist), tm, tpm),
                    jgd.mean_edge_length(jnp.asarray(dist), jm, jpm)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    for kw in ({}, {"kernel_width": 0.7}, {"avg": 0.3}):
        got = gdm.gaussian_weights(_t(dist), tm, tpm, **kw)
        want = jgd.gaussian_weights(jnp.asarray(dist), jm, jpm, **kw)
        _close(got, want, 1e-5, f"weights {kw}")


@pytest.mark.parametrize("shape_reg", [None, 1e-2])
@pytest.mark.parametrize("reg", [1e-3, 1e-8])
def test_weighted_least_squares_matches_jax(reg, shape_reg):
    """The WLS rows within 1e-4 x max|row| (COEF_REL), with the shape
    regularizer's second solve."""
    rng = np.random.default_rng(2)
    coords = (rng.random((200, 16, 2)) * 2 - 1).astype(np.float32)
    coords[:, 0] = 0
    w = np.asarray(jgd.gaussian_weights(jnp.asarray(
        np.linalg.norm(coords, axis=-1))))
    got = gdm.weighted_least_squares(_t(coords), _t(w), reg, shape_reg)
    want = jgd.weighted_least_squares(jnp.asarray(coords), jnp.asarray(w),
                                      reg, shape_reg)
    if shape_reg is None:
        got, want = (got,), (want,)
    for g, w_ in zip(got, want):
        _close(g, w_, COEF_REL, "wls")


@pytest.mark.parametrize("centers", [False, True])
def test_fit_vector_mapping_matches_jax(centers):
    """The per-edge 2x2 maps within 1e-4 x max (COEF_REL), every point a
    centre or a selection of them (``center_idx``)."""
    rng = np.random.default_rng(3)
    pos, normal, xb, yb, _, idx, mask, _ = _cloud(rng)
    ci = np.arange(0, len(pos), 3).astype(np.int32) if centers else None
    if ci is None:
        coords = jgd.coords_projected(*map(jnp.asarray, (pos, normal, xb, yb,
                                                         idx)))
    else:
        coords = jgd._coords_projected_tables(*map(jnp.asarray, (
            pos, pos[ci], normal[ci], xb[ci], yb[ci], idx[ci])))
    coords = np.asarray(coords)
    dist = np.linalg.norm(coords, axis=-1)
    wls = np.asarray(jgd.weighted_least_squares(
        jnp.asarray(coords), jgd.gaussian_weights(jnp.asarray(dist)), 1e-3))
    nbr = idx if ci is None else idx[ci]
    got = gdm.fit_vector_mapping(*map(_t, (pos, normal, xb, yb, nbr, wls,
                                           coords)),
                                 center_idx=None if ci is None else _t(ci))
    want = jgd.fit_vector_mapping(*map(jnp.asarray, (pos, normal, xb, yb, nbr,
                                                     wls, coords)),
                                  center_idx=None if ci is None
                                  else jnp.asarray(ci))
    _close(got, want, COEF_REL, "vector mapping")


def _jax_build(pos, normal, xb, yb, idx, mask, pm, **kw):
    return jgd.build_grad_div(
        *map(jnp.asarray, (pos, normal, xb, yb, idx, mask)),
        None if pm is None else jnp.asarray(pm), **kw)


def _port_build(pos, normal, xb, yb, idx, mask, pm, **kw):
    return gdm.build_grad_div(*map(_t, (pos, normal, xb, yb, idx, mask)),
                              None if pm is None else _t(pm), **kw)


def _same_coefs(got, want, what=""):
    assert got.single and got.grad_coef.shape == want.grad_coef.shape
    np.testing.assert_array_equal(_np(got.nbr_idx), np.asarray(want.nbr_idx))
    np.testing.assert_array_equal(_np(got.nbr_mask),
                                  np.asarray(want.nbr_mask))
    _close(got.grad_coef, want.grad_coef, COEF_REL, what + " grad")
    _close(got.div_coef, want.div_coef, COEF_REL, what + " div")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape_reg", [None, 1e-2])
@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("reg", [1e-3, 1e-8])
def test_build_grad_div_matches_jax(reg, normalized, shape_reg, masked):
    """``build_grad_div`` of one cloud (the torch math, the CPU route):
    indices and masks equal to JAX's, coefficients within 1e-4 x
    max|coef| (COEF_REL)."""
    rng = np.random.default_rng(4)
    pos, normal, xb, yb, _, idx, mask, pm = _cloud(rng, masked=masked)
    kw = dict(regularizer=reg, normalized=normalized,
              shape_regularizer=shape_reg)
    _same_coefs(_port_build(pos, normal, xb, yb, idx, mask, pm, **kw),
                _jax_build(pos, normal, xb, yb, idx, mask, pm, **kw))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("normalized", [True, False])
def test_build_grad_div_kernel_route_matches_the_math(normalized, masked):
    """The card's route (``gather_rows`` + ``wls`` on a batch of one; the
    wrappers' plain versions on these CPU tensors) against the torch math
    and JAX: the same indices, coefficients within 1e-4 x max|coef|."""
    rng = np.random.default_rng(5)
    pos, normal, xb, yb, _, idx, mask, pm = _cloud(rng, masked=masked)
    args = [_t(a) for a in (pos, xb, yb, pos, normal, xb, yb, idx, mask)]
    tpm = None if pm is None else _t(pm)
    got = gdm._tables_on_kernels(*args, tpm, 1.0, 1e-3, normalized,
                                 ops=KERNEL_OPS)
    want = gdm._tables_math(*args, tpm, 1.0, 1e-3, normalized)
    for a, b in ((got, want), (got, _jax_build(
            pos, normal, xb, yb, idx, mask, pm, normalized=normalized))):
        _same_coefs(a, b, "kernel route")


@pytest.mark.parametrize("route", ["math", "kernels"])
def test_build_grad_div_tables_hooks_match_jax(route):
    """The table form: a third of the points as centres against the whole
    cloud, with reduction hooks that move the mean edge length and the
    infinity norm (as a point-sharded build's collectives would); the
    hooks see 0-d tensors on both routes."""
    rng = np.random.default_rng(6)
    pos, normal, xb, yb, _, idx, mask, _ = _cloud(rng)
    c = np.arange(0, len(pos), 3)
    seen = []

    def avg_reduce(total, count):
        seen.append((tuple(np.shape(total)), tuple(np.shape(count))))
        return 1.25 * total / count

    def max_reduce(m):
        seen.append(tuple(np.shape(m)))
        return 0.5 * m

    tabs = (pos, xb, yb, pos[c], normal[c], xb[c], yb[c], idx[c], mask[c])
    want = jgd.build_grad_div_tables(*map(jnp.asarray, tabs),
                                     avg_reduce=avg_reduce,
                                     max_reduce=max_reduce)
    fn = gdm._tables_math if route == "math" else gdm._tables_on_kernels
    got = fn(*map(_t, tabs), None, 1.0, 1e-3, True, avg_reduce=avg_reduce,
             max_reduce=max_reduce, ops=KERNEL_OPS)
    _same_coefs(got, want, route)
    assert seen[-2:] == [((), ()), ()]


def _jax_gd(gd):
    return JaxGradDiv(*(jnp.asarray(_np(t)) for t in (
        gd.nbr_idx, gd.nbr_mask, gd.grad_coef, gd.div_coef)))


def test_operators_match_jax():
    """``curl``, ``laplacian``, ``hodge_laplacian`` (and ``grad``/``div``)
    of one cloud on the port's coefficient form and on its dense form
    (``build_operators`` on ``[N, 3]``) against JAX's on the same
    coefficients, within 1e-4 x max (OP_REL)."""
    rng = np.random.default_rng(7)
    pos, normal, xb, yb, _, idx, mask, _ = _cloud(rng)
    gd = build_operators(_t(pos), 16, _t(normal), dense_operators=False,
                         ops=KERNEL_OPS)
    dense = build_operators(_t(pos), 16, _t(normal))
    assert gd.single and dense.single
    jgd_ = _jax_gd(gd)
    x = rng.standard_normal((len(pos), 5)).astype(np.float32)
    v = rng.standard_normal((len(pos), 2, 5)).astype(np.float32)
    for port in (gd, dense):
        for got, want in (
                (port.grad(_t(x)), jgd_.grad(jnp.asarray(x))),
                (port.div(_t(v)), jgd_.div(jnp.asarray(v))),
                (tops.curl(_t(v), port), jops.curl(jnp.asarray(v), jgd_)),
                (tops.laplacian(_t(x), port),
                 jops.laplacian(jnp.asarray(x), jgd_)),
                (tops.hodge_laplacian(_t(v), port),
                 jops.hodge_laplacian(jnp.asarray(v), jgd_))):
            _close(got, want, OP_REL, type(port).__name__)


def _polar(rng, n, c):
    r = rng.random((n, c)).astype(np.float32)
    theta = (rng.random((n, c)) * 2 * np.pi).astype(np.float32)
    return np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1), r


def test_norm_J_I_J():
    """``tests/geometry/test_operators.py`` on the port."""
    rng = np.random.default_rng(42)
    v, r = _polar(rng, 100, 4)
    np.testing.assert_allclose(_np(geo.norm(_t(v))), r, atol=1e-5)
    jv = _np(geo.J(_t(v)))
    np.testing.assert_allclose(np.linalg.norm(jv, axis=1), r, atol=1e-5)
    np.testing.assert_allclose((jv * v).sum(axis=1), 0.0, atol=1e-5)
    np.testing.assert_allclose(_np(geo.J(geo.J(_t(v)))), -v, atol=1e-6)
    ij = _np(geo.I_J(_t(v[:50, :, :3])))
    assert ij.shape == (50, 2, 6)
    np.testing.assert_allclose(ij[..., :3], v[:50, :, :3], atol=1e-7)
    np.testing.assert_allclose(ij[..., 3:], jv[:50, :, :3], atol=1e-7)


def _unit(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_rotate_around_and_angle_in_plane_match_jax():
    """Broadcast over two leading axes, angles ``[...]`` and ``[..., 1]``;
    within 1e-5 (CONN_ATOL)."""
    rng = np.random.default_rng(8)
    v = rng.standard_normal((3, 40, 3)).astype(np.float32)
    axis = _unit(rng, (3, 40, 3))
    v[0, 0] = 2.0 * axis[0, 0]  # parallel to its axis: no tangent part
    angle = (rng.random((3, 40)) * 7 - 3.5).astype(np.float32)
    for a in (angle, angle[..., None]):
        np.testing.assert_allclose(
            _np(conn.rotate_around(_t(v), _t(axis), _t(a))),
            np.asarray(jconn.rotate_around(jnp.asarray(v), jnp.asarray(axis),
                                           jnp.asarray(a))),
            rtol=0, atol=CONN_ATOL)
    u = rng.standard_normal((3, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(conn.angle_in_plane(_t(u), _t(v), _t(axis))),
        np.asarray(jconn.angle_in_plane(jnp.asarray(u), jnp.asarray(v),
                                        jnp.asarray(axis))),
        rtol=0, atol=CONN_ATOL)


@pytest.mark.parametrize("non_oriented", [True, False])
def test_build_transport_matches_jax(non_oriented):
    """Random frames (some normals opposed, one pair aligned, so both the
    flip and the fallback axis run), two leading axes; within 1e-5."""
    rng = np.random.default_rng(9)
    tn, sn = _unit(rng, (2, 60, 3)), _unit(rng, (2, 60, 3))
    sn[0, :5] = tn[0, :5]  # aligned normals: the fallback axis
    tx, ty = (_np(a) for a in geo.build_tangent_basis(_t(tn)))
    sx = _np(geo.build_tangent_basis(_t(sn))[0])
    got = conn.build_transport(*map(_t, (tn, tx, ty, sn, sx)), non_oriented)
    want = jconn.build_transport(*map(jnp.asarray, (tn, tx, ty, sn, sx)),
                                 non_oriented)
    assert got.shape == (2, 60, 4)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=CONN_ATOL)


def test_connection_properties():
    """``tests/geometry/test_connection.py`` on the port: quarter, half
    and full turns; in-plane angles; transport preserves norms and
    carries x to the construction angle."""
    rng = np.random.default_rng(42)
    n = 1000
    v = _unit(rng, (n, 3))
    axis = _np(geo.build_tangent_basis(_t(v))[0])
    for angle, want in ((np.pi / 2, np.cross(axis, v)), (np.pi, -v),
                        (2 * np.pi, v)):
        out = conn.rotate_around(_t(v), _t(axis),
                                 torch.full((n,), angle))
        np.testing.assert_allclose(_np(out), want, atol=1e-4)

    angle = (rng.random(n) * np.pi).astype(np.float32)
    u = np.zeros((n, 3), np.float32)
    u[:, 0] = 1
    w = np.stack([np.cos(angle), np.sin(angle), np.zeros_like(angle)], 1)
    normal = _unit(rng, (n, 3))
    xb, yb = (_np(a) for a in geo.build_tangent_basis(_t(normal)))
    frame = np.stack([xb, yb, normal], axis=2)
    u = np.einsum("nij,nj->ni", frame, u).astype(np.float32)
    w = np.einsum("nij,nj->ni", frame, w).astype(np.float32)
    out = _np(conn.angle_in_plane(_t(u), _t(w), _t(normal)))
    np.testing.assert_allclose(out, angle, atol=1e-3)

    n = 200
    tn = _unit(rng, (n, 3))
    tx, ty = (_np(a) for a in geo.build_tangent_basis(_t(tn)))
    rot = (rng.random(n) * 2 * np.pi).astype(np.float32)
    sx = _np(conn.rotate_around(_t(tx), _t(tn), _t(rot)))
    tilt_axis = _np(conn.rotate_around(_t(tx), _t(tn), _t(
        rng.random(n).astype(np.float32))))
    tilt_axis /= np.linalg.norm(tilt_axis, axis=1, keepdims=True)
    tilt = _t((rng.random(n) * 0.5 * np.pi).astype(np.float32))
    sn = _np(conn.rotate_around(_t(tn), _t(tilt_axis), tilt))
    sx = _np(conn.rotate_around(_t(sx), _t(tilt_axis), tilt))
    r = _np(conn.build_transport(*map(_t, (tn, tx, ty, sn, sx)),
                                 non_oriented=False)).reshape(n, 2, 2)
    q = rng.random((n, 2)).astype(np.float32)
    np.testing.assert_allclose(np.linalg.norm(np.einsum("nij,nj->ni", r, q),
                                              axis=1),
                               np.linalg.norm(q, axis=1), atol=1e-4)
    np.testing.assert_allclose(r[:, 0, 0], np.cos(rot), atol=1e-3)
    np.testing.assert_allclose(r[:, 1, 0], np.sin(rot), atol=1e-3)


def _grid(n_side):
    """A planar grid with steps of 2/31: most distances tie exactly."""
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 2, indexing="ij"),
                 -1).reshape(-1, 2) * (2.0 / 31)
    return np.concatenate([g, np.zeros((len(g), 1))], 1).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "grid", "small"])
def test_knn_tiled_matches_jax(case):
    """Ids and masks equal to JAX's ``knn_tiled`` (jitted): a random
    cloud whose last tile is partial, a tie-heavy grid, and a cloud of
    fewer points than ``k`` (padded slots clamped to self, unmasked
    slots first)."""
    rng = np.random.default_rng(10)
    pos, k, tile = {
        "random": (rng.random((500, 3)).astype(np.float32), 16, 128),
        "grid": (_grid(20), 12, 96),
        "small": (rng.random((5, 3)).astype(np.float32), 8, 16)}[case]
    got = geo.knn_tiled(_t(pos), k, tile=tile)
    want = jgeo.knn_tiled(jnp.asarray(pos), k, tile=tile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


@pytest.mark.parametrize("m", [40, 3000])
def test_top_k_select_matches_xla(m):
    """``top_k(..., select=True)`` (``knn_tiled``'s selection: unique
    int64 keys through ``torch.topk``) against ``lax.top_k`` and the
    stable sort, on rows of exact ties, signed zeros and infinities:
    the same values, -0.0 below +0.0, and the same ids, equal scores
    lowest column first."""
    rng = np.random.default_rng(11)
    s = rng.integers(-3, 4, (16, m)).astype(np.float32)
    s[:, ::7] = -0.0
    s[:, 3] = np.inf
    s[1::2, 5] = -np.inf
    for k in (1, 8, 40):
        values, idx = top_k(_t(s), k, select=True)
        want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
        np.testing.assert_array_equal(_np(idx), np.asarray(want_i))
        np.testing.assert_array_equal(np.signbit(_np(values)),
                                      np.signbit(np.asarray(want_v)))
        np.testing.assert_array_equal(_np(values), np.asarray(want_v))
        np.testing.assert_array_equal(_np(idx),
                                      _np(top_k(_t(s), k)[1]))


def test_knn_tiled_matches_knn():
    """``tests/geometry/test_knn.py::test_knn_tiled_matches_knn`` on the
    port, and its ids equal to the untiled exact route's."""
    rng = np.random.default_rng(42)
    pos = rng.random((500, 3)).astype(np.float32)
    idx_a, _ = geo.knn(_t(pos), 16)
    idx_b, mask_b = geo.knn_tiled(_t(pos), 16, tile=128)
    assert bool(mask_b.all())
    d_a, d_b = (np.sort(np.linalg.norm(pos[_np(i)] - pos[:, None], axis=-1),
                        axis=1) for i in (idx_a, idx_b))
    np.testing.assert_allclose(d_a, d_b, atol=1e-5)
    np.testing.assert_array_equal(np.sort(_np(idx_a), 1),
                                  np.sort(_np(idx_b), 1))


def test_de_rham_identities():
    """``tests/geometry/test_grad_div.py::test_build_grad_div`` on the
    port's build: grad of a constant, the Laplacian of a constant, curl
    grad and div J grad near 0, the analytic gradient of the height
    field, the mean-curvature normal."""
    rng = np.random.default_rng(42)
    n, k = 1000, 20
    pos, normal, xb, yb, f = _surface(rng, n)
    idx, mask = geo.knn(_t(pos), k)
    gd = gdm.build_grad_div(_t(pos), _t(normal), _t(xb), _t(yb), idx, mask,
                            regularizer=1e-8, normalized=False)
    assert gd.grad_coef.shape == (n, k, 2) == gd.div_coef.shape
    rand_x = _t(rng.random((n, 1)).astype(np.float32))
    rand_v = _t(rng.random((n, 2, 1)).astype(np.float32))
    assert torch.isfinite(gd.grad(rand_x)).all()
    assert torch.isfinite(gd.div(rand_v)).all()
    ones = torch.ones((n, 1))
    np.testing.assert_allclose(_np(gd.grad(ones)), 0.0, atol=1e-2)
    assert float(tops.laplacian(ones, gd).abs().mean()) < 1e-2
    assert float(tops.laplacian(rand_x, gd).abs().sum()) > 0
    gx = gd.grad(_t(pos[:, :1]))
    cg = _np(tops.curl(gx, gd)) ** 2
    assert cg.mean() < 1e-2 and np.median(cg) < 1e-2
    dj = _np(gd.div(tops.J(gx))) ** 2
    assert dj.mean() < 1e-2 and np.median(dj) < 1e-2
    gf = _np(gd.grad(_t(f)))
    np.testing.assert_allclose(gf[:, 0, 0], xb[:, 2], atol=1e-2)
    np.testing.assert_allclose(gf[:, 1, 0], yb[:, 2], atol=1e-2)
    mc = _np(tops.laplacian(_t(pos), gd))
    np.testing.assert_allclose(-np.sum(mc * normal, axis=1),
                               np.linalg.norm(mc, axis=1), atol=1e-2)


def test_build_grad_div_coordinate_equivariance():
    """``tests/geometry/test_grad_div.py``'s basis-rotation equivariance
    on the port: gradients agree in ambient space and div grad does not
    move, under a random in-plane rotation of every frame."""
    rng = np.random.default_rng(42)
    n, k = 1000, 20
    pos, normal, xb, yb, _ = _surface(rng, n)
    idx, mask = geo.knn(_t(pos), k)
    angles = _t((rng.random(n) * 2 * np.pi).astype(np.float32))
    x_rot = conn.rotate_around(_t(xb), _t(normal), angles)
    y_rot = torch.linalg.cross(_t(normal), x_rot)
    x = _t(rng.random((n, 1)).astype(np.float32))
    for normalized, rel_tol in ((False, 5e-3), (True, 0.15)):
        gd = gdm.build_grad_div(_t(pos), _t(normal), _t(xb), _t(yb), idx,
                                mask, regularizer=1e-8,
                                normalized=normalized)
        gd_rot = gdm.build_grad_div(_t(pos), _t(normal), x_rot, y_rot, idx,
                                    mask, regularizer=1e-8,
                                    normalized=normalized)
        g = _np(gd.grad(x))[:, :, 0]
        g_rot = _np(gd_rot.grad(x))[:, :, 0]
        amb = g[:, :1] * xb + g[:, 1:] * yb
        amb_rot = g_rot[:, :1] * _np(x_rot) + g_rot[:, 1:] * _np(y_rot)
        assert np.abs(amb - amb_rot).max() < rel_tol * np.abs(amb).max()
        dg, dg_rot = _np(gd.div(gd.grad(x))), _np(gd_rot.div(gd_rot.grad(x)))
        assert np.abs(dg - dg_rot).max() < rel_tol * np.abs(dg).max()


def _single_and_batch(dense, dtype=None):
    rng = np.random.default_rng(11)
    pos, normal = _surface(rng, 120)[:2]
    gd = build_operators(_t(pos), 10, _t(normal), dense_operators=dense,
                         operator_dtype=dtype)
    return gd, gd.batched()


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape[1:]
        assert torch.equal(x, y[0])


@pytest.mark.parametrize("dense", [True, False])
def test_single_cloud_hooks_bit_equal_to_a_batch_of_one(dense):
    """Every aggregation hook, ``grad`` and ``div`` of the operators of
    one cloud (``build_operators`` on ``[N, 3]``): the batch-of-one call's
    bits without the batch axis. The build itself equals the batched
    build of the same cloud."""
    rng = np.random.default_rng(12)
    gd, gb = _single_and_batch(dense)
    pos = _t(_surface(np.random.default_rng(11), 120)[0])
    again = build_operators(pos[None], 10, _t(_surface(
        np.random.default_rng(11), 120)[1])[None], dense_operators=dense)
    for f in ("nbr_idx", "nbr_mask", "w_grad" if dense else "grad_coef"):
        assert torch.equal(getattr(gd, f), getattr(again, f)[0]), f
    n = gd.nbr_idx.shape[0]
    h = _t(rng.standard_normal((n, 24)).astype(np.float32))
    v = _t(rng.standard_normal((n, 2, 24)).astype(np.float32))
    hb, w = h.to(torch.bfloat16), _t(rng.standard_normal(
        (24, 40)).astype(np.float32)).to(torch.bfloat16)
    sign = torch.where(torch.arange(40) % 3 == 0, -1.0, 1.0)
    affine = (sign, torch.rand(40) + 0.5, torch.randn(40), torch.randn(40))
    affine24 = tuple(a[:24] for a in affine)
    for name, args in (
            ("nbr_max", (h,)), ("nbr_minmax", (h,)), ("nbr_sum", (h,)),
            ("nbr_gather", (h,)), ("grad", (h,)), ("div", (v,)),
            ("nbr_max_affine", (hb, affine24)),
            ("nbr_max_affine", (hb, affine24, True)),
            ("nbr_matmul_max", (hb, w)), ("nbr_matmul_max", (hb, w, affine)),
            ("nbr_matmul_max_train", (hb, w)),
            ("nbr_matmul_minmax", (hb, w))):
        single = getattr(gd, name)(*args)
        batch = getattr(gb, name)(args[0][None], *args[1:])
        _same(single, batch)
    mask = gd.nbr_mask & (torch.rand(gd.nbr_mask.shape) > 0.3)
    _same(gd.nbr_sum(h, mask), gb.nbr_sum(h[None], mask[None]))

    ws = [w, _t(rng.standard_normal((40, 16)).astype(np.float32))]
    affines = [(torch.rand(40) + 0.5, torch.randn(40))]
    epi = (torch.ones(16), torch.rand(16) + 0.5, torch.randn(16),
           torch.randn(16))
    from deltaconv_tpu_torch.ops.gather_mlp_max import mlp_chain
    for centralized in (True, False):
        z0 = (mlp_chain(hb.new_zeros((1, 24)), ws, affines)[0] if centralized
              else mlp_chain(hb, ws, affines))
        z0b = z0 if centralized else z0[None]
        _same(gd.nbr_mlp_max(hb, ws, affines, centralized, z0, epi),
              gb.nbr_mlp_max(hb[None], ws, affines, centralized, z0b, epi))
    a0, b0 = torch.rand(24) + 0.5, torch.randn(24)
    w1 = torch.randn(24, 16).to(torch.bfloat16)
    z0 = torch.randn(16)
    _same(gd.nbr_edge_mlp(hb, a0, b0, w1, z0),
          gb.nbr_edge_mlp(hb[None], a0, b0, w1, z0))


def test_single_cloud_hooks_match_jax():
    """The f32 hooks of one cloud against JAX's unbatched calls on the
    same graph: the neighbour max, min/max and sum bit-equal, the gather
    exact, grad and div within 1e-5 x max (LAYER_REL)."""
    rng = np.random.default_rng(13)
    gd, _ = _single_and_batch(False)
    jg = _jax_gd(gd)
    n = gd.nbr_idx.shape[0]
    h = rng.standard_normal((n, 12)).astype(np.float32)
    v = rng.standard_normal((n, 2, 12)).astype(np.float32)
    np.testing.assert_array_equal(_np(gd.nbr_max(_t(h))),
                                  np.asarray(jg.nbr_max(jnp.asarray(h))))
    for a, b in zip(gd.nbr_minmax(_t(h)), jg.nbr_minmax(jnp.asarray(h))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_allclose(_np(gd.nbr_sum(_t(h))),
                               np.asarray(jg.nbr_sum(jnp.asarray(h))),
                               rtol=0, atol=1e-6 * np.abs(h).max() * 10)
    np.testing.assert_array_equal(_np(gd.nbr_gather(_t(h))),
                                  np.asarray(jg.nbr_gather(jnp.asarray(h))))
    _close(gd.grad(_t(h)), jg.grad(jnp.asarray(h)), LAYER_REL, "grad")
    _close(gd.div(_t(v)), jg.div(jnp.asarray(v)), LAYER_REL, "div")


_CONVS = {"edge": dict(depth=1, centralized=True),
          "point": dict(depth=1, centralized=False),
          "deep": dict(depth=2, centralized=True),
          "deep-point": dict(depth=2, centralized=False)}


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", sorted(_CONVS))
def test_single_cloud_deltaconv_bit_equal_to_a_batch_of_one(kind, train,
                                                            dtype):
    """``DeltaConv`` on the operators of one cloud, f32 and bf16, eval and
    train: outputs (and in train mode the parameters' gradients and the
    running statistics) bit-equal to the batched call at B=1."""
    rng = np.random.default_rng(14)
    gd, gb = _single_and_batch(True, dtype)
    n = gd.nbr_idx.shape[0]
    c_in = 3 if _CONVS[kind]["centralized"] else 16
    x = _t(rng.standard_normal((n, c_in)).astype(np.float32))
    v = _t(rng.standard_normal((n, 2, c_in)).astype(np.float32))
    outs = []
    for g, xx, vv in ((gd, x, v), (gb, x[None], v[None])):
        torch.manual_seed(0)
        conv = DeltaConv(c_in, 136, dtype=dtype, **_CONVS[kind])
        conv.train(train)
        xo, vo = conv(xx, vv, g)
        if train:
            (xo.float().sum() + vo.float().square().sum()).backward()
        outs.append((xo, vo, conv))
    (xs, vs, cs), (xb, vb, cb) = outs
    _same((xs, vs), (xb, vb))
    if train:
        for (name, p), q in zip(cs.named_parameters(), cb.parameters()):
            assert torch.equal(p.grad, q.grad), name
        for (name, b), c in zip(cs.named_buffers(), cb.buffers()):
            assert torch.equal(b, c), name


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["edge", "point", "deep"])
def test_single_cloud_deltaconv_matches_jax(kind, train):
    """The f32 ``DeltaConv`` of one cloud against JAX's unbatched layer
    on the same coefficients (the port's single-cloud coefficient form
    handed to JAX's ``GradDiv``): outputs within 1e-5 x max (LAYER_REL)."""
    rng = np.random.default_rng(15)
    gd, _ = _single_and_batch(False)
    jg = _jax_gd(gd)
    n = gd.nbr_idx.shape[0]
    cfg = _CONVS[kind]
    c_in, c_out = (3 if cfg["centralized"] else 8), 8
    x = rng.standard_normal((n, c_in)).astype(np.float32)
    v = rng.standard_normal((n, 2, c_in)).astype(np.float32)
    layer = JaxDeltaConv(c_out, depth=cfg["depth"],
                         centralized=cfg["centralized"])
    variables = layer.init(jax.random.PRNGKey(0), x, v, jg)
    params, stats = variables["params"], variables["batch_stats"]
    out = layer.apply({"params": params, "batch_stats": stats}, x, v, jg,
                      train=train, mutable=["batch_stats"])[0]
    port = DeltaConv(c_in, c_out, **cfg)
    port.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats)), strict=True)
    port.train(train)
    with torch.no_grad():
        got = port(_t(x), _t(v), gd)
    for a, b in zip(got, out):
        _close(a, b, LAYER_REL, f"{kind} train={train}")


def test_deltaconv_coordinate_independence():
    """``tests/nn/test_deltaconv.py::test_deltaconv_coordinate_
    independence`` on the port: the same loss and parameter gradients
    under randomly rotated tangent bases (one cloud, estimated frames)."""
    rng = np.random.default_rng(42)
    n = 500
    pos = _t(rng.random((n, 3)).astype(np.float32))
    idx, mask = geo.knn(pos, 20)
    normal, xb, yb = geo.estimate_basis(pos, idx, mask)
    angles = _t((rng.random(n) * 2 * np.pi).astype(np.float32))
    xb_rot = conn.rotate_around(xb, normal, angles)
    yb_rot = torch.linalg.cross(normal, xb_rot)
    target = _t(rng.random((n, 1)).astype(np.float32))
    torch.manual_seed(3)
    conv = DeltaConv(3, 1, depth=1, centralized=False)
    conv.train()
    results = []
    for x_b, y_b in ((xb, yb), (xb_rot, yb_rot)):
        gd = gdm.build_grad_div(pos, normal, x_b, y_b, idx, mask,
                                regularizer=1e-8)
        conv.zero_grad()
        state = {k: b.clone() for k, b in conv.named_buffers()}
        out, _ = conv(pos, gd.grad(pos), gd)
        loss = (out - target).abs().mean()
        loss.backward()
        for k, b in conv.named_buffers():
            b.copy_(state[k])
        results.append((float(loss.detach()), torch.cat(  # unused: 0, as JAX
            [torch.zeros_like(p).flatten() if p.grad is None
             else p.grad.flatten() for p in conv.parameters()])))
    np.testing.assert_allclose(results[0][0], results[1][0], atol=1e-5)
    np.testing.assert_allclose(_np(results[0][1]), _np(results[1][1]),
                               atol=1e-5)


@pytest.mark.parametrize("normals", [True, False])
def test_build_operators_on_one_cloud_matches_jax(normals):
    """``build_operators`` on ``[N, 3]`` (coefficient form) against JAX's
    single-cloud ``build_operators``: the same graph, coefficients within
    1e-4 x max|coef| (COEF_REL); without normals the frames are
    estimated on both sides."""
    rng = np.random.default_rng(16)
    pos, normal = _surface(rng, 200)[:2]
    nrm = normal if normals else None
    got = build_operators(_t(pos), 12, None if nrm is None else _t(nrm),
                          dense_operators=False)
    want = jax_build_operators(jnp.asarray(pos), 12, None if nrm is None
                               else jnp.asarray(nrm))
    _same_coefs(got, want, "build_operators")
