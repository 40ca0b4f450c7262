"""Clouds without normals in deltaconv_tpu_torch against the JAX package on
the CPU: the closed-form 3x3 eigendecomposition and Cholesky solve
(``geometry/linalg.py``), the estimated frames (``estimate_basis``), the
operators that ``build_operators`` makes from them, and a narrow
DeltaNetClassification served, trained and differentiated without
normals.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, and why:

- ``eigh3x3``: eigenvalues within 1e-5 x max|lambda| (the same formulas
  in the same order, f32); eigenvectors ``|v . v_jax| >= 1 - 1e-5``
  wherever the eigenvalue's gap to its nearest neighbour is at least
  1e-3 x max|lambda| (inside a smaller gap the eigenvector is not defined
  to f32 accuracy); scalar, rank-1 and repeated-eigenvalue matrices give
  finite, orthonormal results. ``chol_solve`` within 1e-5 relative.
- ``estimate_basis`` (``normal_k = 10``): normals within 1e-4; the x and
  y axes within 1e-4 where ``lambda2 - lambda1 >= 1e-3 lambda2`` (a
  smaller gap leaves the in-plane axis free); every frame orthonormal
  and right-handed.
- Dense f32 operators within 1e-4 x max|w| of JAX's ``densify``; f32
  logits within 1e-4 x max|logit| (tests/test_torch_model.py), on a
  planar grid too, where most x axes are degenerate (there on the same
  kNN graphs: see its test); bf16
  logits within 0.05 x max|logit| with the argmax equal where the f32
  margin exceeds twice the deviation (tests/test_torch_bf16.py); three
  SGD steps as tests/test_torch_train.py holds them (against a float64
  run of JAX's step: see its test); the positions' gradient through the estimated frames within 1e-3 x max|g| of
  ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.nn.deltaconv as jax_dc
from deltaconv_tpu.geometry.dense import densify as jax_densify
from deltaconv_tpu.geometry.frames import estimate_basis as jax_estimate
from deltaconv_tpu.geometry.knn import knn as jax_knn
from deltaconv_tpu.geometry.linalg import chol_solve as jax_chol_solve
from deltaconv_tpu.geometry.linalg import eigh3x3 as jax_eigh3x3
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.models.deltanet_base import \
    build_operators as jax_build_operators
from deltaconv_tpu.serving import InferenceEngine as JaxEngine
from deltaconv_tpu.training import TrainState as JaxTrainState
from deltaconv_tpu.training import make_train_step as jax_train_step
from deltaconv_tpu.training import sgd_momentum as jax_sgd
from deltaconv_tpu_torch import (DeltaNetClassification, InferenceEngine,
                                 ops, state_dict_from_flax)
from deltaconv_tpu_torch.geometry import chol_solve, eigh3x3, estimate_basis
from deltaconv_tpu_torch.geometry import knn
from deltaconv_tpu_torch.geometry.knn import squared_norms, top_k
from deltaconv_tpu_torch.models import build_operators, deltanet_base
from deltaconv_tpu_torch.training import (create_train_state,
                                          make_eval_step, make_train_step,
                                          sgd_momentum)

torch.set_num_threads(1)

B, N, K, NORMAL_K = 2, 128, 8, 10
WIDTH = dict(conv_channels=(8, 8, 16, 16), embedding_size=32,
             num_neighbors=K)
BF16_WIDTH = dict(conv_channels=(8, 16, 16, 136), embedding_size=32,
                  num_neighbors=K)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ellipsoids(rng, sizes, n=N):
    """Padded points on random ellipsoids ``[len(sizes), n, 3]`` (zero
    rows beyond each size) and the point mask."""
    pos = np.zeros((len(sizes), n, 3), np.float32)
    for i, m in enumerate(sizes):
        axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        d = rng.standard_normal((m, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pos[i, :m] = d * axes
    return pos, np.arange(n)[None, :] < np.asarray(sizes)[:, None]


def _grid():
    """A square 16 x 8 grid in the plane z = 0 (N = 128 points): an
    interior point's 10 nearest are itself, its 4 edge and 4 diagonal
    neighbours and ONE of the 4 tied points two steps away, so which one
    the kNN takes sets its x axis."""
    h = np.float32(2.0 / 15.0)
    u, v = np.meshgrid(np.arange(16, dtype=np.float32) * h - 1.0,
                       np.arange(8, dtype=np.float32) * h - 3.5 * h)
    return np.stack([u.ravel(), v.ravel(), np.zeros(N, np.float32)], -1)


def _within(got, want, rel, what=""):
    scale = float(np.abs(want).max())
    dev = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert dev <= rel * scale, f"{what}: {dev:.3e} > {rel} x {scale:.3e}"


# -- geometry/linalg.py ---------------------------------------------------------


def _symmetric(rng, b):
    m = rng.standard_normal((b, 3, 3)).astype(np.float32)
    return (m + np.swapaxes(m, -1, -2)) / np.float32(2.0)


def test_eigh3x3_matches_jax():
    a = _symmetric(np.random.default_rng(0), 2000)
    w, v = (t.numpy() for t in eigh3x3(_t(a)))
    jw, jv = (np.asarray(t) for t in jax_eigh3x3(jnp.asarray(a)))
    scale = np.abs(jw).max(axis=-1)
    assert (np.abs(w - jw).max(axis=-1) <= 1e-5 * scale).all()
    gaps = np.diff(jw, axis=-1)
    gap = np.stack([gaps[:, 0], gaps.min(axis=-1), gaps[:, 1]], -1)
    clear = gap >= 1e-3 * scale[:, None]
    dots = np.abs((v * jv).sum(axis=-2))  # [b, 3]: |v_i . v_jax_i|
    assert clear.mean() > 0.9
    assert (dots[clear] >= 1 - 1e-5).all(), dots[clear].min()


@pytest.mark.parametrize("kind", ["scalar", "rank1", "repeated", "zero"])
def test_eigh3x3_degenerate_is_finite_and_orthonormal(kind):
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.standard_normal((16, 3, 3)))
    if kind == "scalar":
        d = np.tile([2.0, 2.0, 2.0], (16, 1))
    elif kind == "rank1":
        d = np.tile([0.0, 0.0, 3.0], (16, 1))
    elif kind == "repeated":
        d = np.tile([1.0, 1.0, 4.0], (16, 1))
    else:
        d = np.zeros((16, 3))
    a = (q * d[:, None, :]) @ np.swapaxes(q, -1, -2)
    a = ((a + np.swapaxes(a, -1, -2)) / 2).astype(np.float32)
    w, v = (t.numpy() for t in eigh3x3(_t(a)))
    assert np.isfinite(w).all() and np.isfinite(v).all()
    jw = np.asarray(jax_eigh3x3(jnp.asarray(a))[0])
    np.testing.assert_allclose(w, jw, atol=1e-5 * (1 + d.max()))
    # The closed form near a repeated eigenvalue: the JAX tests' bound.
    np.testing.assert_allclose(w, np.sort(d, -1), atol=1e-3 * (1 + d.max()))
    vtv = np.einsum("bji,bjk->bik", v, v)
    np.testing.assert_allclose(vtv, np.broadcast_to(np.eye(3), vtv.shape),
                               atol=1e-5)


def test_chol_solve_matches_jax():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((300, 6, 6)).astype(np.float32)
    a = m @ np.swapaxes(m, -1, -2) + np.float32(0.1) * np.eye(6,
                                                               dtype=np.float32)
    rhs = rng.standard_normal((300, 6, 5)).astype(np.float32)
    got = chol_solve(_t(a), _t(rhs)).numpy()
    want = np.asarray(jax_chol_solve(jnp.asarray(a), jnp.asarray(rhs)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# -- estimate_basis ---------------------------------------------------------------


def _clear_in_plane(table, centres, idx, mask):
    """Where ``lambda2 - lambda1 >= 1e-3 lambda2`` of the offset
    covariance (float64)."""
    off = (table[idx].astype(np.float64)
           - centres[:, None].astype(np.float64))
    off *= mask[..., None]
    lam = np.linalg.eigvalsh(np.einsum("nkd,nke->nde", off, off))
    return lam[:, 2] - lam[:, 1] >= 1e-3 * lam[:, 2]


def _orthonormal_right_handed(n, x, y):
    basis = np.stack([n, x, y], axis=-1)
    btb = np.einsum("...ij,...ik->...jk", basis, basis)
    np.testing.assert_allclose(btb, np.broadcast_to(np.eye(3), btb.shape),
                               atol=1e-5)
    assert ((np.cross(x, y) * n).sum(-1) > 0).all()


@pytest.mark.parametrize("case", ["plain", "masked", "table"])
def test_estimate_basis_matches_jax(case):
    """Ellipsoid clouds at ``normal_k = 10``, oriented by the positions:
    unmasked, with a point mask (a ragged cloud's normal graph), and with
    ``table=`` (centre rows against a larger cloud, as a shard)."""
    rng = np.random.default_rng(3)
    sizes = [N, 90] if case == "masked" else [N, N]
    pos, pmask = _ellipsoids(rng, sizes)
    for b in range(B):
        p = pos[b]
        pm = jnp.asarray(pmask[b]) if case == "masked" else None
        idx, mask = (np.asarray(t) for t in jax_knn(jnp.asarray(p), NORMAL_K,
                                                    pm))
        rows = slice(0, N // 2) if case == "table" else slice(None)
        jargs = (jnp.asarray(p[rows]), jnp.asarray(idx[rows]),
                 jnp.asarray(mask[rows]) if case == "masked" else None,
                 jnp.asarray(p[rows]))
        targs = (_t(p[None, rows]), _t(idx[None, rows]),
                 _t(mask[None, rows]) if case == "masked" else None,
                 _t(p[None, rows]))
        if case == "table":
            want = jax_estimate(*jargs, table=jnp.asarray(p))
            got = estimate_basis(*targs, table=_t(p[None]))
        else:
            want = jax_estimate(*jargs)
            got = estimate_basis(*targs)
        want = [np.asarray(t) for t in want]
        got = [t[0].numpy() for t in got]
        for t in got:
            assert np.isfinite(t).all()
        np.testing.assert_allclose(got[0], want[0], atol=1e-4)
        clear = _clear_in_plane(p, p[rows], idx[rows], mask[rows])
        assert clear.mean() > 0.9
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g[clear], w[clear], atol=1e-4)
        _orthonormal_right_handed(*got)


def test_estimate_basis_batched_matches_rows():
    """The batched call equals the per-cloud calls, bit for bit."""
    rng = np.random.default_rng(4)
    pos, _ = _ellipsoids(rng, [N, N])
    idx, mask = knn(_t(pos), NORMAL_K)
    batched = estimate_basis(_t(pos), idx, mask, orientation=_t(pos))
    for b in range(B):
        p = _t(pos[b:b + 1])
        single = estimate_basis(p, idx[b:b + 1], mask[b:b + 1],
                                orientation=p)
        for x, y in zip(batched, single):
            assert torch.equal(x[b], y[0])


# -- build_operators and the model ----------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_dense_operators_match_jax(masked):
    rng = np.random.default_rng(5)
    pos, pmask = _ellipsoids(rng, [N, 90] if masked else [N, N])
    pm = pmask if masked else None
    want = jax_densify(jax_build_operators(
        jnp.asarray(pos), K, point_mask=None if pm is None
        else jnp.asarray(pm)))
    got = build_operators(_t(pos), K, point_mask=None if pm is None
                          else _t(pm))
    # JAX zeroes the ids of masked slots; the port keeps them (masked).
    valid = np.asarray(want.nbr_mask)
    np.testing.assert_array_equal(got.nbr_mask.numpy(), valid)
    np.testing.assert_array_equal(got.nbr_idx.numpy()[valid],
                                  np.asarray(want.nbr_idx)[valid])
    for g, w in ((got.w_grad, want.w_grad), (got.w_div, want.w_div)):
        assert np.isfinite(g.numpy()).all()
        _within(g.numpy(), np.asarray(w), 1e-4, "dense operators")


def test_approx_normal_graph_is_knn_topk(monkeypatch):
    """``knn_method="approx"`` builds a uniform batch's normal graph with
    ``knn_topk`` at K=10 (packed keys), a masked batch's by the exact
    route, and hands it to ``estimate_basis`` oriented by the positions."""
    calls = []

    def recorded(*args, **kw):
        calls.append((args, kw))
        return estimate_basis(*args, **kw)

    monkeypatch.setattr(deltanet_base, "estimate_basis", recorded)
    rng = np.random.default_rng(6)
    pos, pmask = _ellipsoids(rng, [N, 90])
    p = _t(pos)
    for pm in (None, _t(pmask)):
        build_operators(p, K, point_mask=pm, knn_method="approx",
                        dense_operators=False)
        (pos_in, idx, mask), kw = calls.pop()
        if pm is None:
            assert torch.equal(idx, ops.knn_topk_plain(p, NORMAL_K, True))
            assert bool(mask.all())
        else:
            want_idx, want_mask = knn(p, NORMAL_K, pm)
            assert torch.equal(idx, want_idx)
            assert torch.equal(mask, want_mask)
        assert pos_in is p and kw["orientation"] is p


def _perturb(tree, rng, stats_only=False, in_bn=False):
    """Running statistics away from their init and, unless
    ``stats_only``, BatchNorm scales of both signs and biases."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _perturb(x, rng, stats_only, in_bn or k == "BatchNorm_0")
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        elif stats_only:
            out[k] = np.asarray(x)
        elif k == "scale":
            out[k] = rng.uniform(-1.5, 1.5, x.shape).astype(np.float32)
        elif k == "bias" and in_bn:
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        else:
            out[k] = np.asarray(x)
    return out


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _pair(seed, width, stats_only=False, **kw):
    """(JAX model, its numpy variables, the port loaded from them), both
    without normals."""
    rng = np.random.default_rng(seed)
    model = JaxModel(num_classes=4, **width, **kw)
    pos, _ = _ellipsoids(rng, [N] * B)
    variables = jax.jit(lambda key, p: model.init(key, p))(
        jax.random.PRNGKey(0), pos)
    params = _perturb(_to_numpy(variables["params"]), rng, stats_only)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng, stats_only)
    port = DeltaNetClassification(4, **width, **kw)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return model, {"params": params, "batch_stats": stats}, port.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair(0, WIDTH)


@pytest.mark.parametrize("clouds", ["uniform", "ragged"])
def test_logits_match_jax_apply(pair, clouds):
    model, variables, port = pair
    rng = np.random.default_rng(7)
    pos, pmask = _ellipsoids(rng, [N, 90] if clouds == "ragged" else [N, N])
    pm = pmask if clouds == "ragged" else None
    want = np.asarray(jax.jit(
        lambda v, p, m: model.apply(v, p, point_mask=m, train=False))(
        variables, pos, pm))
    with torch.inference_mode():
        got = port(_t(pos), None, None if pm is None else _t(pm)).numpy()
    assert got.shape == (B, 4) and np.isfinite(got).all()
    _within(got, want, 1e-4, clouds)


@pytest.mark.parametrize("k", [K, NORMAL_K, 20])
@pytest.mark.parametrize("masked", [False, True])
def test_exact_knn_ids_equal_jax_on_ties(k, masked):
    """The exact kNN's ids equal JAX's (jitted, as the models run it)
    element by element on the tie grid, unmasked and with a point mask
    (the masked route: the first 100 points valid, then every third
    one too, so a row's ties straddle masked columns): the selection is
    XLA ``top_k``'s (lowest index first among equal scores) and the
    squared norms round as XLA's contraction."""
    grid = _grid()
    pm = (np.arange(N) < 100) | (np.arange(N) % 3 == 0) if masked else None
    idx, mask = knn(_t(grid)[None], k, None if pm is None
                    else _t(pm)[None])
    fn = jax.jit(lambda p, m: jax_knn(p, k, point_mask=m))
    want_idx, want_mask = fn(jnp.asarray(grid),
                             None if pm is None else jnp.asarray(pm))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(mask[0].numpy(), np.asarray(want_mask))


def test_top_k_and_squared_norms_are_xla_s():
    """``top_k`` against ``lax.top_k`` on rows of exact ties, signed
    zeros and infinities (-0.0 below +0.0, as XLA orders them), and
    ``squared_norms`` bit-equal to JAX's jitted ``jnp.sum(p * p, -1)``."""
    rng = np.random.default_rng(9)
    s = rng.integers(-3, 4, (64, 40)).astype(np.float32)
    s[:, ::7] = -0.0
    s[:, 3] = np.inf
    s[1::2, 5] = -np.inf
    for k in (1, 8, 40):
        values, idx = top_k(_t(s), k)
        want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(np.signbit(values.numpy()),
                                      np.signbit(np.asarray(want_v)))
        np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))
    p = rng.standard_normal((3, 500, 3)).astype(np.float32)
    want = jax.jit(lambda x: jnp.sum(x * x, -1))(jnp.asarray(p))
    np.testing.assert_array_equal(squared_norms(_t(p)).numpy(),
                                  np.asarray(want))


def test_grid_logits_match_jax_on_the_same_graphs(pair):
    """A planar grid beside an ellipsoid. The grid's kNN has exact and
    one-ulp ties (equidistant points), which pick the in-plane axis of
    the frames (a tie leaves it free). The exact kNN selects as XLA's
    ``top_k`` (lowest index first) on scores rounded as JAX's, so each
    package now builds the same graphs on its own: the estimated x axes
    agree on every row, and the logits of each package's own forward
    within 1e-4 x max|logit|. (Before the port broke ties so,
    ``torch.topk`` took other tied neighbours, the axes differed by a
    quarter turn on some rows and the logits by 7.1e-4 x max; the test
    then handed the port's graphs to JAX.)"""
    model, variables, port = pair
    pos, _ = _ellipsoids(np.random.default_rng(7), [N, N])
    pos[1] = _grid()
    for k in (K, NORMAL_K):
        want = np.stack([np.asarray(jax_knn(jnp.asarray(p), k)[0])
                         for p in pos])
        np.testing.assert_array_equal(knn(_t(pos), k)[0].numpy(), want)
    idx_n, mask_n = knn(_t(pos), NORMAL_K)
    grid = jnp.asarray(pos[1])
    own = jax_knn(grid, NORMAL_K)
    x_jax = np.asarray(jax_estimate(grid, *own, orientation=grid)[1])
    x_port = estimate_basis(_t(pos), idx_n, mask_n,
                            orientation=_t(pos))[1][1].numpy()
    assert ((x_jax * x_port).sum(-1) > 1.0 - 1e-5).all()  # the axes agree
    want = np.asarray(jax.jit(lambda v, p: model.apply(v, p, train=False))(
        variables, jnp.asarray(pos)))
    with torch.inference_mode():
        got = port(_t(pos)).numpy()
    assert np.isfinite(got).all()
    _within(got, want, 1e-4, "grid")


def test_engine_without_normals_matches_jax_engine(pair):
    """Uniform then ragged requests (a partial last batch included)."""
    model, variables, port = pair
    rng = np.random.default_rng(8)
    jax_engine = JaxEngine(model, variables, num_points=N, batch_size=B)
    engine = InferenceEngine(port, num_points=N, batch_size=B, device="cpu")
    for sizes in ([N] * 3, [N, 100, 77]):
        pos, _ = _ellipsoids(rng, sizes)
        clouds = [pos[i, :m] for i, m in enumerate(sizes)]
        want = jax_engine.predict(clouds)
        got = engine.predict(clouds)
        assert got.shape == (len(sizes), 4) and got.dtype == np.float32
        _within(got, want, 1e-4, f"engine {sizes}")


@pytest.mark.parametrize("sizes", [[N] * 3, [N, 100, 77]],
                         ids=["uniform", "ragged"])
def test_bf16_engine_without_normals_matches_jax(sizes, monkeypatch):
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    model, variables, port = _pair(9, BF16_WIDTH)
    pos, _ = _ellipsoids(np.random.default_rng(10), sizes)
    clouds = [pos[i, :m] for i, m in enumerate(sizes)]
    want = JaxEngine(model, variables, num_points=N, batch_size=B,
                     precision="bfloat16").predict(clouds)
    base = JaxEngine(model, variables, num_points=N,
                     batch_size=B).predict(clouds)
    got = InferenceEngine(port, num_points=N, batch_size=B,
                          precision="bfloat16", device="cpu").predict(clouds)
    dev = float(np.abs(got - want).max())
    assert dev < 0.05 * float(np.abs(want).max())
    assert dev < float(np.abs(want - base).max())  # bf16 really ran
    top2 = np.sort(base, axis=-1)
    decisive = top2[:, -1] - top2[:, -2] > 2 * dev
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


@pytest.mark.parametrize("masked", [False, True])
def test_three_train_steps_without_normals_match_jax(masked):
    """As tests/test_torch_train.py's three steps (8 clouds, dropout 0,
    lr 0.01, randomized running statistics), on batches without
    ``normal``: the loss within rtol 1e-5, parameters within 1e-3 and
    running statistics within 1e-4 x max after each step, then the eval
    logits within 1e-4 x max, against JAX's ``make_train_step`` run in
    float64 (``jax.enable_x64``). Why not its f32 run: on the ragged
    batch the JAX f32 step 3 takes another neighbour-max winner at a
    near-tie (measured: conv3's BatchNorm bias 1.1e-2 x max from the x64
    run, the port's steps within 5.7e-4 x max of it)."""
    n, k, lr = 64, 8, 0.01
    width = dict(WIDTH, num_neighbors=k)
    rng = np.random.default_rng(11)
    sizes = [n, 50, n, 40] * 2 if masked else [n] * 8
    pos, pmask = _ellipsoids(rng, sizes, n)
    labels = rng.integers(0, 4, len(sizes))
    model = JaxModel(num_classes=4, dropout=0.0, **width)
    variables = jax.jit(lambda key, p: model.init(key, p))(
        jax.random.PRNGKey(0), pos)
    params = _perturb(_to_numpy(variables["params"]), rng, stats_only=True)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng,
                     stats_only=True)
    f64 = jax.tree_util.Partial(np.asarray, dtype=np.float64)
    steps = []
    with jax.enable_x64(True):
        state = JaxTrainState.create(
            apply_fn=model.apply, params=jax.tree_util.tree_map(f64, params),
            batch_stats=jax.tree_util.tree_map(f64, stats), tx=jax_sgd(lr))
        jbatch = {"pos": jnp.asarray(pos, jnp.float64),
                  "label": jnp.asarray(labels)}
        if masked:
            jbatch["point_mask"] = jnp.asarray(pmask)
        jstep = jax_train_step(model, smoothing=0.2)
        for i in range(3):
            state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
            steps.append((float(jm["loss"]), state_dict_from_flax(
                *(jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float32), dict(t))
                  for t in (state.params, state.batch_stats)))))
        want_logits = np.asarray(model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            jbatch["pos"], point_mask=jbatch.get("point_mask"),
            train=False), np.float32)
    tbatch = {"pos": _t(pos), "label": _t(labels)}
    if masked:
        tbatch["point_mask"] = _t(pmask)
    port = DeltaNetClassification(4, dropout=0.0, **width)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    tstate = create_train_state(port, sgd_momentum(lr), device="cpu")
    tstep = make_train_step(port, smoothing=0.2)
    gen = torch.Generator().manual_seed(0)
    for i, (loss, want) in enumerate(steps):
        tm = tstep(tstate, tbatch, gen)
        np.testing.assert_allclose(float(tm["loss"]), loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        got = port.state_dict()
        for key, w in want.items():
            w = w.numpy()
            rel = 1e-4 if ".running_" in key else 1e-3
            np.testing.assert_allclose(
                got[key].numpy(), w, rtol=0,
                atol=rel * float(np.abs(w).max()), err_msg=f"{key}, {i}")
    got = make_eval_step(port)(tstate, tbatch)
    _within(got.numpy(), want_logits, 1e-4, "eval after training")


def test_position_gradient_through_estimated_frames_matches_jax(pair):
    """``d loss / d pos`` of one ellipsoid cloud without normals (eval,
    f32, dense operators): the kNN graphs carry no gradient, the frames,
    the WLS build and the convs do."""
    model, variables, port = pair
    rng = np.random.default_rng(12)
    pos, _ = _ellipsoids(rng, [N])
    ct = rng.standard_normal((1, 4)).astype(np.float32)

    def loss(p):
        return jnp.sum(model.apply(variables, p, train=False) * ct)

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(pos)))
    p = _t(pos).requires_grad_()
    (port(p) * _t(ct)).sum().backward()
    got = p.grad.numpy()
    assert np.isfinite(got).all()
    _within(got, want, 1e-3, "position gradient")
