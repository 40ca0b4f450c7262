"""The large-cloud coefficient-operator path of deltaconv_tpu_torch against
the JAX package on the CPU.

With ``dense_operators=False`` the convs apply the grad/div operators in
coefficient form (``coef_apply_grad``, ``coef_apply_div``), and their
feature cotangents scatter edge rows (``scatter_rows``, the gather's
VJP). The plain versions are held against the JAX functions with their
Pallas kernels in interpret mode (and against the XLA references), the
port's ``GradDiv`` against the JAX one on the same coefficients, then a
narrow ``DeltaNetClassification(dense_operators=False)`` against the JAX
model: f32 eval logits, the bf16 engine, an f32 train step and a bf16
step. Inputs are numpy arrays from a seed; weights move across with
``state_dict_from_flax``.

Tolerances, and why:

- f32 applies and their cotangents: the JAX TPU kernels gather f32 rows
  (and scatter f32 cotangents) as ``hi + lo`` bf16 halves, about 2^-16 of
  relative precision; the port's gather is exact: rtol = atol = 1e-4, as
  tests/ops/test_kernels.py holds the JAX kernel to its reference.
  Against the XLA references (exact gathers, another sum order): 1e-5 x
  max.
- bf16 applies: the gathered values are exact on both sides and the
  products and sums f32; XLA's CPU compiler contracts ``acc + a * b``
  into an FMA, the port rounds each, so the cast results differ by one
  bf16 ulp (2^-8 relative) on a few elements: held to one ulp of the
  largest entry.
- The scatter and the gather's VJP: sums of f32 edge rows, in another
  order and (JAX) from ``hi + lo`` halves: 1e-5 x max.
- The narrow model and its steps as the dense form's tests hold them
  (tests/test_torch_train.py, tests/test_torch_bf16.py,
  tests/test_torch_bf16_train.py), each stated where it is used.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.nn.deltaconv as jax_dc
from deltaconv_tpu.geometry.grad_div import GradDiv as JaxGradDiv
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.serving import InferenceEngine as JaxEngine
from deltaconv_tpu.serving import apply_precision as jax_apply_precision
from deltaconv_tpu.training import TrainState as JaxTrainState
from deltaconv_tpu.training import make_train_step as jax_train_step
from deltaconv_tpu.training import sgd_momentum as jax_sgd
from deltaconv_tpu.training import smooth_cross_entropy as jax_sce
from deltaconv_tpu_torch import (KERNEL_OPS, PLAIN_OPS,
                                 DeltaNetClassification, InferenceEngine,
                                 state_dict_from_flax)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.geometry import GradDiv
from deltaconv_tpu_torch.models import build_operators
from deltaconv_tpu_torch.ops import coef_apply as coef_mod
from deltaconv_tpu_torch.serving import apply_precision
from deltaconv_tpu_torch.training import (create_train_state,
                                          make_train_step, sgd_momentum)

# The modules (the package's ``ops`` exports functions of these names).
jax_coef = importlib.import_module("deltaconv_tpu.ops.coef_apply")
jax_rows = importlib.import_module("deltaconv_tpu.ops.gather_rows")

torch.set_num_threads(1)

B, N, K = 2, 256, 8
ULP = 2.0 ** -8  # one bf16 ulp, relative
KERNEL_TOL = 1e-4  # f32 against the hi/lo TPU kernels in interpret mode
REF_REL = 1e-5  # x max: f32 against exact gathers in another sum order
MODEL_K = 8
MODEL_N = 96


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(t):
    return t.detach().float().numpy()


def _within(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _inputs(rng, shape, dtype):
    """(jnp, torch) of the same normal draws, bf16-rounded for bf16."""
    a = rng.standard_normal(shape).astype(np.float32)
    if dtype == "float32":
        return jnp.asarray(a), _t(a)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(np.asarray(j, np.float32)).to(torch.bfloat16)


def _operators(rng):
    """Neighbour lists as the kNN makes them (self in slot 0, distinct
    columns) and coefficients; the last 3 slots of every other point are
    masked: clamped to self with zero coefficients."""
    idx = np.stack([np.stack([np.concatenate(
        [[i], rng.permutation(np.delete(np.arange(N), i))[:K - 1]])
        for i in range(N)]) for _ in range(B)]).astype(np.int32)
    coef = rng.standard_normal((B, N, K, 2)).astype(np.float32)
    idx[:, ::2, -3:] = np.arange(0, N, 2)[None, :, None]
    coef[:, ::2, -3:] = 0.0
    return idx, coef


def _apply_fns(op):
    """(JAX apply, the port's plain apply, the JAX XLA reference)."""
    if op == "grad":
        return (jax_coef.coef_apply_grad, ops.coef_apply_grad_plain,
                jax_coef._reference_grad)
    return (jax_coef.coef_apply_div, ops.coef_apply_div_plain,
            jax_coef._reference_div)


def _shape(op, c):
    return (B, N, c) if op == "grad" else (B, N, 2, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 24])
@pytest.mark.parametrize("op", ["grad", "div"])
def test_coef_apply_matches_jax(op, c, dtype):
    """The plain apply (and the kernel wrapper, which takes it on CPU
    tensors) against the JAX apply in interpret mode and its XLA
    reference."""
    rng = np.random.default_rng(0)
    idx, coef = _operators(rng)
    xj, x = _inputs(rng, _shape(op, c), dtype)
    jax_fn, port_fn, ref_fn = _apply_fns(op)
    want = jax_fn(xj, jnp.asarray(coef), jnp.asarray(idx), 128, True)
    ref = ref_fn(xj, jnp.asarray(coef), jnp.asarray(idx))
    got = port_fn(x, _t(coef), _t(idx))
    assert got.dtype == x.dtype and tuple(got.shape) == want.shape
    wrapper = (ops.coef_apply_grad if op == "grad"
               else ops.coef_apply_div)(x, _t(coef), _t(idx))
    assert torch.equal(wrapper, got)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)
        _within(got, ref, REF_REL)
    else:
        _within(got, np.asarray(want, np.float32), ULP)
        _within(got, np.asarray(ref, np.float32), ULP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["grad", "div"])
def test_coef_apply_vjp_matches_jax(op, dtype):
    """Both cotangents against ``jax.vjp`` of the JAX apply in interpret
    mode (its scatter and gather kernels): the features' (cast to their
    dtype) and the coefficients' (f32), through the plain route and the
    kernel route (plain versions on CPU tensors)."""
    rng = np.random.default_rng(1)
    idx, coef = _operators(rng)
    c = 24
    xj, x = _inputs(rng, _shape(op, c), dtype)
    ct_shape = (B, N, 2, c) if op == "grad" else (B, N, c)
    ctj, ct = _inputs(rng, ct_shape, dtype)
    jax_fn, _, _ = _apply_fns(op)
    _, vjp = jax.vjp(lambda a, w: jax_fn(a, w, jnp.asarray(idx), 128, True),
                     xj, jnp.asarray(coef))
    want_dx, want_dc = vjp(ctj)
    kernel_fn = ops.coef_apply_grad if op == "grad" else ops.coef_apply_div
    for fn in (_apply_fns(op)[1], kernel_fn):
        xg = x.clone().requires_grad_()
        cg = _t(coef).requires_grad_()
        fn(xg, cg, _t(idx)).backward(ct)
        assert xg.grad.dtype == x.dtype and cg.grad.dtype == torch.float32
        if dtype == "float32":
            np.testing.assert_allclose(_np(xg.grad), np.asarray(want_dx),
                                       rtol=KERNEL_TOL, atol=KERNEL_TOL)
        else:
            _within(xg.grad, np.asarray(want_dx, np.float32), ULP, "dx")
        np.testing.assert_allclose(_np(cg.grad), np.asarray(want_dc),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("op", ["grad", "div"])
def test_coef_cotangent_only_when_asked(op, monkeypatch):
    """The coefficients' cotangent (the sampled product) is formed only
    when the coefficients require grad, and the features' (its scatter)
    only when the features do; no backward runs for an input that requires
    none."""
    rng = np.random.default_rng(2)
    idx, coef = _operators(rng)
    _, x = _inputs(rng, _shape(op, 8), "float32")
    fn = ops.coef_apply_grad_plain if op == "grad" else ops.coef_apply_div_plain

    def forbidden(*_):
        raise AssertionError("not asked for")

    plain = coef_mod._PLAIN
    for needs_x, needs_c in ((True, False), (False, True)):
        route = plain._replace(
            cotangent=plain.cotangent if needs_c else forbidden,
            scatter_rows=plain.scatter_rows if needs_x else forbidden)
        monkeypatch.setattr(coef_mod, "_PLAIN", route)
        xg = x.clone().requires_grad_(needs_x)
        cg = _t(coef).requires_grad_(needs_c)
        fn(xg, cg, _t(idx)).sum().backward()
        assert (xg.grad is not None) == needs_x
        assert (cg.grad is not None) == needs_c
    with torch.no_grad():  # a forward only: no Function, no graph
        out = fn(x.clone().requires_grad_(), _t(coef), _t(idx))
    assert out.grad_fn is None


@pytest.mark.parametrize("n_out,c", [(N, 5), (N, 40), (N + 7, 12)])
def test_scatter_rows_matches_jax(n_out, c):
    """``scatter_rows`` (plain, and the wrapper on CPU tensors) against
    the JAX kernel in interpret mode, with indices repeated many times
    over (8 distinct rows take a third of the edges)."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, n_out, (B, N, K)).astype(np.int32)
    hot = rng.random((B, N, K)) < 1 / 3
    idx[hot] = rng.integers(0, 8, int(hot.sum()))
    g = rng.standard_normal((B, c, K, N)).astype(np.float32)
    want = jax_rows.scatter_rows(jnp.asarray(g), jnp.asarray(idx), n_out,
                                 128, True)
    for fn in (ops.scatter_rows_plain, ops.scatter_rows):
        got = fn(_t(g), _t(idx), n_out)
        assert got.shape == (B, n_out, c) and got.dtype == torch.float32
        _within(got, want, REF_REL)


def test_gather_rows_vjp_matches_jax():
    """``gather_rows`` is differentiable in its table through
    ``scatter_rows``, as the JAX ``custom_vjp``: the forward and the
    table's cotangent within 1e-5 x max (the JAX kernels' hi/lo halves)."""
    rng = np.random.default_rng(4)
    idx, _ = _operators(rng)
    table = rng.standard_normal((B, N, 9)).astype(np.float32)
    g = rng.standard_normal((B, 9, K, N)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jax_rows.gather_rows(
        t, jnp.asarray(idx), 128, True), jnp.asarray(table))
    (want_dt,) = vjp(jnp.asarray(g))
    for fn in (ops.gather_rows_plain, ops.gather_rows):
        tg = _t(table).requires_grad_()
        got = fn(tg, _t(idx))
        _within(got, want, REF_REL)
        got.backward(_t(g))
        _within(tg.grad, want_dt, REF_REL)


def _clouds(rng, sizes, n=MODEL_N):
    """Padded ellipsoid clouds with analytic normals and a point mask."""
    pos = np.zeros((len(sizes), n, 3), np.float32)
    nrm = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (len(sizes), n, 1))
    for i, m in enumerate(sizes):
        axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        d = rng.standard_normal((m, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        q = d / axes
        pos[i, :m] = d * axes
        nrm[i, :m] = q / np.linalg.norm(q, axis=1, keepdims=True)
    mask = np.arange(n)[None, :] < np.asarray(sizes)[:, None]
    return pos, nrm, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_div_object_matches_jax(dtype):
    """The port's batched ``GradDiv`` (built by ``build_operators(...,
    dense_operators=False)``) against the JAX ``GradDiv`` on the same
    coefficients (its vmapped gather + einsum): ``grad``, ``div`` and the
    neighbour max of the shared protocol."""
    rng = np.random.default_rng(5)
    pos, nrm, mask = _clouds(rng, [MODEL_N, 70])
    gd = build_operators(_t(pos), MODEL_K, _t(nrm), _t(mask),
                         dense_operators=False)
    assert isinstance(gd, GradDiv) and gd.ops is KERNEL_OPS and not gd.int8
    jgd = JaxGradDiv(*(jnp.asarray(t.numpy()) for t in (
        gd.nbr_idx, gd.nbr_mask, gd.grad_coef, gd.div_coef)))
    xj, x = _inputs(rng, (2, MODEL_N, 12), dtype)
    vj, v = _inputs(rng, (2, MODEL_N, 2, 12), dtype)
    rel = REF_REL if dtype == "float32" else ULP
    for got, want in ((gd.grad(x), jgd.grad(xj)), (gd.div(v), jgd.div(vj)),
                      (gd.nbr_max(x), jgd.nbr_max(xj))):
        assert got.dtype == x.dtype
        _within(got, np.asarray(want, np.float32), rel)


@pytest.mark.parametrize("b,n,k,masked", [(2, 100, 7, False),
                                           (3, 65, 20, True),
                                           (1, 40, 40, False),
                                           (2, 33, 1, True)])
def test_coef_plan_plain(b, n, k, masked):
    """The gather plan's plain builder: ``order`` a permutation of each
    cloud with the padded points last, every edge's local slot naming
    its id in its run's rows (``-1`` for an id outside ``[0, N)``), the
    ids distinct within a run and ``-1`` after its count, runs of
    ``run`` points that never cross a cloud (``run * K <= 1024``), and
    the same plan from a second call."""
    rng = np.random.default_rng(60)
    pos = _t(rng.standard_normal((b, n, 3)).astype(np.float32))
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[0, 3, 0] = n + 5
    idx[-1, 4, 0] = -1
    pm = np.ones((b, n), bool)
    if masked:
        pm[-1, n // 2:] = False
    plan = ops.coef_plan_plain(pos, _t(idx), _t(pm) if masked else None)
    r = plan.run
    n_runs = -(-n // r)
    assert r * k <= 1024 and plan.run_rows.shape == (b * n_runs, r * k)
    order = plan.order.numpy()
    local = plan.local_slot.numpy().astype(np.int64)
    rows = plan.run_rows.numpy()
    count = plan.run_count.numpy()
    for bb in range(b):
        assert sorted(order[bb]) == list(range(n))
        if masked and bb == b - 1:
            assert set(order[bb, n // 2:]) == set(range(n // 2, n))
        place = np.empty(n, np.int64)
        place[order[bb]] = np.arange(n)
        run = bb * n_runs + place // r
        got = rows[run[:, None], local[bb]]
        want = np.where((idx[bb] >= 0) & (idx[bb] < n), idx[bb], -1)
        np.testing.assert_array_equal(got, want)
        assert (local[bb] < count[run][:, None]).all()
    for row, c in zip(rows, count):
        assert len(set(row[:c])) == c and (row[c:] == -1).all()
    again = ops.coef_plan_plain(pos, _t(idx), _t(pm) if masked else None)
    for a, w in zip(plan[:4], again[:4]):
        assert torch.equal(a, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_div_plan_changes_nothing(dtype):
    """``build_operators(..., dense_operators=False)`` attaches the gather
    plan of its neighbour lists (ragged clouds: the padded points last),
    and ``GradDiv.grad``/``div`` give the same bits with it as without
    it, at a row width that takes the planned route on the card (128
    channels)."""
    rng = np.random.default_rng(61)
    pos, nrm, mask = _clouds(rng, [MODEL_N, 70])
    gd = build_operators(_t(pos), MODEL_K, _t(nrm), _t(mask),
                         dense_operators=False)
    assert isinstance(gd.plan, ops.CoefPlan)
    assert set(gd.plan.order[1, 70:].tolist()) == set(range(70, MODEL_N))
    bare = dataclasses.replace(gd, plan=None)
    _, x = _inputs(rng, (2, MODEL_N, 128), dtype)
    _, v = _inputs(rng, (2, MODEL_N, 2, 128), dtype)
    for got, want in ((gd.grad(x), bare.grad(x)), (gd.div(v), bare.div(v))):
        assert got.dtype == want.dtype and torch.equal(got, want)


NARROW = dict(conv_channels=(8, 8, 16, 16), embedding_size=32,
              num_neighbors=MODEL_K, dense_operators=False)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _perturb(tree, rng, in_bn=False, stats_only=False):
    """Running statistics away from their init and, unless
    ``stats_only``, BatchNorm scales of both signs and biases."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _perturb(x, rng, in_bn or k == "BatchNorm_0",
                              stats_only)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        elif k == "scale" and not stats_only:
            out[k] = rng.uniform(-1.5, 1.5, x.shape).astype(np.float32)
        elif k == "bias" and in_bn and not stats_only:
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        else:
            out[k] = np.asarray(x)
    return out


def _model_pair(rng, widths=NARROW, stats_only=False, **extra):
    """(JAX model, its perturbed numpy params and stats, the port loaded
    from them)."""
    model = JaxModel(num_classes=4, **widths, **extra)
    pos, nrm, _ = _clouds(rng, [MODEL_N] * 2)
    variables = jax.jit(lambda key, p, n_: model.init(key, p, normal=n_))(
        jax.random.PRNGKey(0), pos, nrm)
    params = _perturb(_to_numpy(variables["params"]), rng,
                      stats_only=stats_only)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng,
                     stats_only=stats_only)
    port = DeltaNetClassification(4, **widths, **extra)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return model, params, stats, port


@pytest.mark.parametrize("sizes", [[MODEL_N] * 3, [MODEL_N, 70, 55]],
                         ids=["uniform", "ragged"])
def test_coef_model_eval_matches_jax(sizes):
    """f32 eval logits of the narrow coefficient-form model against the
    JAX model's, within 1e-4 x max|logit| (as the dense form's,
    tests/test_torch_model.py); the dense form of the same weights gives
    the same logits within 1e-5 x max|logit| (both apply the same
    coefficients; the dense products sum over N in another order)."""
    rng = np.random.default_rng(6)
    model, params, stats, port = _model_pair(rng)
    pos, nrm, mask = _clouds(rng, sizes)
    jmask = None if min(sizes) == MODEL_N else jnp.asarray(mask)
    tmask = None if jmask is None else _t(mask)
    want = model.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(pos), normal=jnp.asarray(nrm),
                       point_mask=jmask)
    port.eval()
    with torch.no_grad():
        got = port(_t(pos), _t(nrm), tmask)
        dense = DeltaNetClassification(4, **dict(NARROW,
                                                 dense_operators=True))
        dense.load_state_dict(port.state_dict(), strict=True)
        got_dense = dense.eval()(_t(pos), _t(nrm), tmask)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got_dense.numpy(), got.numpy(), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("sizes", [[MODEL_N] * 3, [MODEL_N, 70, 55]],
                         ids=["uniform", "ragged"])
def test_coef_bf16_engine_matches_jax_engine(sizes, monkeypatch):
    """The port's bf16 engine on the coefficient-form model (widths (8,
    16, 16, 136): the last conv is lane-narrower, so both PointMaxMLP
    branches run) against the JAX bf16 engine on the same weights (its
    eval branches on the ``_FORCE_FUSED_INTERPRET`` hook): within 0.05 x
    max|logit| (tests/models/test_serving.py), closer than bf16 is to
    f32, argmax equal wherever the f32 margin exceeds twice the
    deviation."""
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    widths = dict(NARROW, conv_channels=(8, 16, 16, 136))
    model, params, stats, port = _model_pair(np.random.default_rng(7),
                                             widths)
    variables = {"params": params, "batch_stats": stats}
    pos, nrm, _ = _clouds(np.random.default_rng(8), sizes)
    clouds = [p[:m] for p, m in zip(pos, sizes)]
    normals = [q[:m] for q, m in zip(nrm, sizes)]
    kw = dict(num_points=MODEL_N, batch_size=2)
    want = JaxEngine(model, variables, precision="bfloat16",
                     **kw).predict(clouds, normals)
    base = JaxEngine(model, variables, **kw).predict(clouds, normals)
    engine = InferenceEngine(port, precision="bfloat16", device="cpu", **kw)
    got = engine.predict(clouds, normals)
    assert got.shape == (len(sizes), 4)
    assert engine.model.compute_dtype == torch.bfloat16
    assert not engine.model.dense_operators
    dev = float(np.abs(got - want).max())
    assert dev < 0.05 * float(np.abs(want).max())
    assert dev < float(np.abs(want - base).max())
    top2 = np.sort(base, axis=-1)
    decisive = top2[:, -1] - top2[:, -2] > 2 * dev
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


def _batches(rng, sizes):
    pos, nrm, mask = _clouds(rng, sizes)
    labels = rng.integers(0, 4, len(sizes))
    jbatch = {"pos": jnp.asarray(pos), "normal": jnp.asarray(nrm),
              "label": jnp.asarray(labels)}
    tbatch = {"pos": _t(pos), "normal": _t(nrm), "label": _t(labels)}
    if min(sizes) < MODEL_N:
        jbatch["point_mask"] = jnp.asarray(mask)
        tbatch["point_mask"] = _t(mask)
    return jbatch, tbatch


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_coef_train_step_matches_jax(ragged):
    """One f32 train step of the narrow coefficient-form model (dropout 0,
    SGD lr 0.01, momentum 0.9, weight decay 1e-4, smoothing 0.2, 8 clouds,
    running statistics randomized) against the JAX ``make_train_step``,
    as the dense form's step is held (tests/test_torch_train.py, which
    says why this recipe): loss rtol 1e-5, parameters 1e-3 x max,
    running statistics 1e-4 x max. The applies' feature cotangents run
    through ``scatter_rows`` in the port and through ``jax.vjp`` of the
    XLA reference in the JAX package."""
    rng = np.random.default_rng(9)
    model, params, stats, port = _model_pair(rng, stats_only=True,
                                             dropout=0.0)
    sizes = [MODEL_N, 50, MODEL_N, 40] * 2 if ragged else [MODEL_N] * 8
    jbatch, tbatch = _batches(rng, sizes)
    jstate = JaxTrainState.create(apply_fn=model.apply, params=params,
                                  batch_stats=stats, tx=jax_sgd(0.01))
    jstate, jm = jax_train_step(model, smoothing=0.2)(
        jstate, jbatch, jax.random.PRNGKey(0))
    state = create_train_state(port, sgd_momentum(0.01), device="cpu")
    tm = make_train_step(port, smoothing=0.2)(state, tbatch, None)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = state_dict_from_flax(_to_numpy(jstate.params),
                                _to_numpy(jstate.batch_stats))
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        rel = 1e-4 if ".running_" in key else 1e-3
        _within(got[key], w.numpy(), rel, key)


def _frob(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(_np(got) - want)
                 / max(np.linalg.norm(want), 1e-30))


BF16_WIDTHS = {  # widths, JAX hook: every PointMaxMLP on one branch
    "commuted": ((8, 136, 272), True),
    "per-point": ((16, 16, 16), False),
}


@pytest.mark.parametrize("branch", list(BF16_WIDTHS))
def test_coef_bf16_train_step_matches_jax(branch, monkeypatch):
    """One bf16 train step of the narrow coefficient-form model (bf16
    compute, dropout 0, SGD lr 0.1, perturbed weights, a ragged batch of
    8) against the JAX step, held as the dense bf16 step is
    (tests/test_torch_bf16_train.py says why the whole bf16 step is held
    by its distance to the f32 step): loss rtol 3e-3, the port's mean
    gradient deviation from the JAX f32 step at most 1.25 x the JAX bf16
    step's, running statistics 2e-3 x max. The widths keep every
    PointMaxMLP on one branch in both packages (``_FORCE_FUSED_TRAIN``
    forces the commuted one on the JAX side)."""
    widths, hook = BF16_WIDTHS[branch]
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_TRAIN", hook)
    rng = np.random.default_rng(10)
    cfg = dict(NARROW, conv_channels=widths)
    model, params, stats, port = _model_pair(
        rng, cfg, dropout=0.0, compute_dtype="bfloat16")
    jbatch, tbatch = _batches(rng, [MODEL_N, 70, MODEL_N, 80] * 2)
    f32 = JaxModel(num_classes=4, dropout=0.0, **cfg)

    def loss_fn(p):
        logits, _ = f32.apply(
            {"params": p, "batch_stats": stats}, jbatch["pos"], train=True,
            normal=jbatch["normal"], point_mask=jbatch["point_mask"],
            mutable=["batch_stats"])
        return jax_sce(logits, jbatch["label"], 0.2)

    zero = jax.tree_util.tree_map(np.zeros_like, stats)
    f32_grad = state_dict_from_flax(
        _to_numpy(jax.jit(jax.grad(loss_fn))(params)), zero)
    jstate = JaxTrainState.create(apply_fn=model.apply, params=params,
                                  batch_stats=stats, tx=jax_sgd(0.1))
    jstate, jm = jax_train_step(model, smoothing=0.2)(
        jstate, jbatch, jax.random.PRNGKey(0))
    want = state_dict_from_flax(_to_numpy(jstate.params),
                                _to_numpy(jstate.batch_stats))
    old = state_dict_from_flax(params, stats)
    state = create_train_state(port, sgd_momentum(0.1), device="cpu")
    tm = make_train_step(port, smoothing=0.2)(state, tbatch, None)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=3e-3)
    err_port, err_jax = [], []
    for key, p in port.named_parameters():
        o = old[key].numpy()
        jgrad = (o - want[key].numpy()) / 0.1 - 1e-4 * o
        err_port.append(_frob(p.grad, f32_grad[key].numpy()))
        err_jax.append(_frob(_t(jgrad), f32_grad[key].numpy()))
    assert np.mean(err_port) <= 1.25 * np.mean(err_jax)
    got = port.state_dict()
    for key, w in want.items():
        if ".running_" in key:
            _within(got[key], w.numpy(), 2e-3, key)


def test_coef_form_keeps_the_parameter_tree():
    """The operator form changes no parameter or buffer: the same keys
    and shapes as the dense form, so checkpoints load either way."""
    dense = DeltaNetClassification(4, **dict(NARROW, dense_operators=True))
    coef = DeltaNetClassification(4, **NARROW)
    assert dense.dense_operators and not coef.dense_operators
    got = {k: tuple(v.shape) for k, v in coef.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in dense.state_dict().items()}


def test_int8_refuses_the_coefficient_form():
    """int8 has no coefficient form: ``apply_precision`` and the engine
    refuse it, with JAX's reason, as the JAX package does."""
    port = DeltaNetClassification(4, **NARROW)
    with pytest.raises(ValueError, match="dense_operators=True"):
        apply_precision(port, "int8")
    with pytest.raises(ValueError, match="dense_operators=True"):
        InferenceEngine(port, num_points=MODEL_N, precision="int8",
                        device="cpu")
    with pytest.raises(ValueError, match="dense_operators=True"):
        jax_apply_precision(JaxModel(num_classes=4, **NARROW), "int8")
    assert apply_precision(port, "bfloat16").compute_dtype == torch.bfloat16


def test_plain_ops_route_the_coefficient_form():
    """``PLAIN_OPS`` carries the plain applies, and the operators built
    with them apply through them."""
    assert PLAIN_OPS.coef_apply_grad is ops.coef_apply_grad_plain
    assert PLAIN_OPS.coef_apply_div is ops.coef_apply_div_plain
    rng = np.random.default_rng(11)
    pos, nrm, _ = _clouds(rng, [MODEL_N] * 2)
    gd = build_operators(_t(pos), MODEL_K, _t(nrm), ops=PLAIN_OPS,
                         dense_operators=False)
    assert gd.ops is PLAIN_OPS
    x = _t(rng.standard_normal((2, MODEL_N, 4)).astype(np.float32))
    assert torch.equal(gd.grad(x), ops.coef_apply_grad_plain(
        x, gd.grad_coef, gd.nbr_idx))


def test_coef_kernels_refuse_other_devices():
    """The three wrappers run their kernels only on CUDA tensors (plain
    versions on CPU ones): anything else raises before a launch."""
    meta = torch.device("meta")
    idx = torch.zeros((B, N, K), dtype=torch.int32, device=meta)
    coef = torch.zeros((B, N, K, 2), device=meta)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.coef_apply_grad(torch.zeros((B, N, 4), device=meta), coef, idx)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.coef_apply_div(torch.zeros((B, N, 2, 4), device=meta), coef, idx)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.scatter_rows(torch.zeros((B, 4, K, N), device=meta), idx, N)
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        ops.coef_apply_grad(torch.zeros((B, N, 4), dtype=torch.float16,
                                        device=meta), coef, idx)
    assert sum(ops.launch_counts().values()) == 0
