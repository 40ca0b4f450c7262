"""The bf16 train step of deltaconv_tpu_torch against the JAX package on
the CPU.

The JAX package's production train step runs with bf16 compute and
operators: bf16 Linear products and activations, f32 BatchNorm, the
neighbour maxes on bf16 values with single-winner gradients (f32
accumulation of the cotangents, cast to bf16), and, in a lane-narrower
PointMaxMLP, the commuted branch through ``gather_matmul_max_train``.
Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs its CPU reference paths (the TPU kernels' plain
counterparts).

Routing (the JAX package's TPU route, which the port takes everywhere):
off the TPU the JAX PointMaxMLP takes its commuted train branch only
under the test hook ``_FORCE_FUSED_TRAIN``, which forces it for every
PointMaxMLP, narrower or not. The module tests set the hook where the
port takes that branch (a lane-narrower conv); the whole-model tests
pick widths where every PointMaxMLP takes the same branch in both
packages: (8, 136, 272) with the hook on (every non-centralized conv is
lane-narrower), (16, 16, 16) with it off (none is).

Tolerances, and why:

- The kernels' plain versions (neighbour max with winners, its VJP, the
  gather-then-matmul max) are bit-equal to JAX where the arithmetic is
  exact: values and winners of the max are selections; the matmul max is
  held on inputs whose products and sums are exact in f32. The
  contractions of its VJP (``dx = dy @ w^T``, ``dw = x^T dy``) sum f32
  terms in another order before the bf16 cast: one bf16 ulp (2^-8
  relative) of the largest entry.
- The bf16 dense applies and their input cotangents: f32 sums over N in
  another order, then one bf16 rounding: one bf16 ulp of the largest
  entry.
- Modules: XLA's CPU compiler contracts ``a * b + c`` into an FMA in
  the f32 epilogues and BatchNorm, so a bf16 output may differ by one
  ulp, and a neighbour max whose values differ by that ulp may pick
  another winner and move a whole cotangent. As the JAX package holds
  its own two bf16 train routes against each other
  (tests/nn/test_deltaconv.py), gradients are held by their relative
  Frobenius deviation (below 2e-2); outputs (one bf16 ulp) and running
  statistics (1e-5) by their largest deviation against their largest
  magnitude.
- The whole step is chaotic in bf16 at a test's size; see
  :func:`test_bf16_train_step_matches_jax` for what is held there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.nn.deltaconv as jax_dc
from deltaconv_tpu.geometry.dense import DenseGradDiv as JaxDenseGradDiv
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.ops.gather_max import _fwd as jax_max_fwd
from deltaconv_tpu.ops.gather_max import _mm_train_reference_fwd
from deltaconv_tpu.ops.gather_max import gather_matmul_max_train as jax_gmm
from deltaconv_tpu.ops.gather_max import masked_nbr_max as jax_masked_max
from deltaconv_tpu.training import TrainState as JaxTrainState
from deltaconv_tpu.training import make_train_step as jax_train_step
from deltaconv_tpu.training import sgd_momentum as jax_sgd
from deltaconv_tpu.training import smooth_cross_entropy as jax_sce
from deltaconv_tpu_torch import DeltaNetClassification, state_dict_from_flax
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.models import build_operators
from deltaconv_tpu_torch.nn import DeltaConv, EdgeMaxMLP, PointMaxMLP
from deltaconv_tpu_torch.training import (create_train_state,
                                          make_train_step, sgd_momentum)

torch.set_num_threads(1)

B, N, K = 2, 96, 8
ULP = 2.0 ** -8  # one bf16 ulp, relative (measured: equal)
GRAD_FROB = 2e-2  # relative Frobenius deviation (measured: <= 8.9e-3)
OUT_REL = ULP  # x max: a bf16 activation (measured: <= 7.4e-4)
STATS_REL = 1e-5  # x max: a layer's running statistics (measured 9.4e-7)
STEP_STATS_REL = 2e-3  # x max: after a whole step (measured 8.0e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(rng, shape, scale=1.0):
    """(jnp bf16, torch bf16) of the same values."""
    j = jnp.asarray((rng.standard_normal(shape) * scale).astype(
        np.float32)).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.detach().float().numpy()


def _bits_equal(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def _within(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _frob(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(_np(got) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _graph(rng, masked):
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    idx[:, :, 0] = np.arange(N)  # the kNN self loop in slot 0
    mask = np.ones((B, N, K), bool)
    if masked:
        mask = rng.random((B, N, K)) > 0.3
        mask[:, :, 0] = True
        mask[1, 60:] = False  # padded points: no valid neighbour
    return idx, mask


@pytest.mark.parametrize("masked", [False, True])
def test_gather_max_bf16_and_vjp_match_jax(masked):
    """bf16 in, bf16 out: values, winners and the bf16 ``dh`` equal the
    JAX ``gather_max``'s (CPU reference path) bit for bit."""
    rng = np.random.default_rng(0)
    idx, mask = _graph(rng, masked)
    hj, h = _bf16(rng, (B, N, 24))
    gj, g = _bf16(rng, (B, N, 24))
    want, vjp = jax.vjp(lambda a: jax_masked_max(a, idx, mask, True), hj)
    (want_dh,) = vjp(gj)
    want_out, want_win = jax_max_fwd(hj, jnp.asarray(idx), jnp.asarray(mask))

    ti, tm = _t(idx), _t(mask)
    out, win = ops.gather_max_win_plain(h, ti, tm)
    assert out.dtype == torch.bfloat16 and win.dtype == torch.int32
    _bits_equal(out, want_out)
    np.testing.assert_array_equal(win.numpy(), np.asarray(want_win))
    for fn in (ops.gather_max, ops.gather_max_plain):
        hg = h.clone().requires_grad_()
        got = ops.masked_nbr_max(hg, ti, tm, fn)
        got.backward(g)
        assert got.dtype == hg.grad.dtype == torch.bfloat16
        _bits_equal(got, want)
        _bits_equal(hg.grad, want_dh)


@pytest.mark.parametrize("masked", [False, True])
def test_gather_matmul_max_train_matches_jax(masked):
    """Forward values and winners bit-equal to the JAX
    ``gather_matmul_max_train`` (CPU reference path) on inputs whose
    products and sums are exact in f32; ``dx``, ``dw`` within one bf16
    ulp of the largest entry (f32 sums in another order)."""
    rng = np.random.default_rng(1)
    idx, mask = _graph(rng, masked)
    c_in, c_out = 24, 40
    x = (rng.integers(-16, 17, (B, N, c_in)) / 8.0).astype(np.float32)
    w = (rng.integers(-16, 17, (c_in, c_out)) / 16.0).astype(np.float32)
    xj, wj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
    gj, g = _bf16(rng, (B, N, c_out))
    want, vjp = jax.vjp(lambda a, b: jax_gmm(a, b, idx, mask, True), xj, wj)
    want_dx, want_dw = vjp(gj)
    _, want_win = _mm_train_reference_fwd(xj, wj, jnp.asarray(idx),
                                          jnp.asarray(mask))

    ti, tm = _t(idx), _t(mask)
    xt, wt = (_t(a).to(torch.bfloat16) for a in (x, w))
    out, win = ops.gather_matmul_max_win_plain(xt, wt, ti, tm)
    _bits_equal(out, want)
    np.testing.assert_array_equal(win.numpy(), np.asarray(want_win))
    for fn in (ops.gather_matmul_max_train,
               ops.gather_matmul_max_train_plain):
        xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
        got = fn(xg, wg, ti, tm)
        got.backward(g)
        assert got.dtype == xg.grad.dtype == wg.grad.dtype == torch.bfloat16
        _bits_equal(got, want)
        _within(xg.grad, want_dx, ULP, "dx")
        _within(wg.grad, want_dw, ULP, "dw")


def _clouds(rng, sizes):
    """Padded ellipsoid clouds with analytic normals and a point mask."""
    pos = np.zeros((len(sizes), N, 3), np.float32)
    nrm = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (len(sizes), N, 1))
    for i, n in enumerate(sizes):
        axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        q = d / axes
        pos[i, :n] = d * axes
        nrm[i, :n] = q / np.linalg.norm(q, axis=1, keepdims=True)
    mask = np.arange(N)[None, :] < np.asarray(sizes)[:, None]
    return pos, nrm, mask


def _operators(rng, masked):
    """The port's bf16 dense operators of a batch, the same arrays as a
    JAX DenseGradDiv, and the point mask (None when uniform)."""
    pos, nrm, mask = _clouds(rng, [N, 60] if masked else [N] * B)
    pm = _t(mask) if masked else None
    gd = build_operators(_t(pos), K, _t(nrm), pm, operator_dtype="bfloat16")
    jgd = JaxDenseGradDiv(
        jnp.asarray(gd.nbr_idx.numpy()), jnp.asarray(gd.nbr_mask.numpy()),
        *(jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
          for w in (gd.w_grad, gd.w_div)))
    return gd, jgd, pm


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_dense_applies_and_vjp_match_jax(masked):
    """``grad`` and ``div`` on bf16 operators and features, and their
    input cotangents from bf16 output cotangents, against ``jax.vjp`` of
    the JAX DenseGradDiv: within one bf16 ulp of the largest entry."""
    rng = np.random.default_rng(2)
    gd, jgd, _ = _operators(rng, masked)
    xj, x = _bf16(rng, (B, N, 12))
    vj, v = _bf16(rng, (B, N, 2, 12))
    for apply_j, apply_t, inj, int_, ct_shape in (
            (jgd.grad, gd.grad, xj, x, (B, N, 2, 12)),
            (jgd.div, gd.div, vj, v, (B, N, 12))):
        ctj, ct = _bf16(rng, ct_shape)
        want, vjp = jax.vjp(apply_j, inj)
        (want_d,) = vjp(ctj)
        xg = int_.clone().requires_grad_()
        got = apply_t(xg)
        got.backward(ct)
        assert got.dtype == xg.grad.dtype == torch.bfloat16
        _within(got, want, ULP, "apply")
        _within(xg.grad, want_d, ULP, "input cotangent")


def _perturb(tree, rng, in_bn=False):
    """Running statistics away from their init, BatchNorm scales of both
    signs (the sign fold) and biases."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _perturb(x, rng, in_bn or k == "BatchNorm_0")
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(-1.5, 1.5, x.shape).astype(np.float32)
        elif k == "bias" and in_bn:
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        else:
            out[k] = np.asarray(x)
    return out


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _check_layer(port, params, stats, jgrad, mutated, outs, wants):
    """Outputs, parameter gradients and running statistics of a train-mode
    layer against its JAX run."""
    for got, want in zip(outs, wants):
        assert got.dtype == torch.bfloat16
        _within(got, want, OUT_REL, "output")
    zero = jax.tree_util.tree_map(np.zeros_like, stats)
    want_grad = state_dict_from_flax(_to_numpy(jgrad), zero)
    for key, p in port.named_parameters():
        frob = _frob(p.grad, want_grad[key].numpy())
        assert frob < GRAD_FROB, (key, frob)
    want_stats = state_dict_from_flax(params, _to_numpy(mutated))
    for key, b in port.named_buffers():
        _within(b, want_stats[key].numpy(), STATS_REL, key)


@pytest.mark.parametrize("kind,c_in,c_out,masked", [
    ("edge", 3, 8, False), ("edge", 3, 8, True),
    ("point", 8, 16, False), ("point", 8, 16, True),
    ("commuted", 16, 136, False), ("commuted", 16, 136, True)])
def test_scalar_max_branch_bf16_train_matches_jax(kind, c_in, c_out, masked,
                                                  monkeypatch):
    """EdgeMaxMLP, PointMaxMLP per point (8 -> 16) and commuted (16 ->
    136, lane-narrower; the JAX side under ``_FORCE_FUSED_TRAIN``) in
    bf16 train mode, with and without a statistics mask: outputs,
    updated running statistics, parameter and input gradients."""
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_TRAIN", kind == "commuted")
    rng = np.random.default_rng(3)
    gd, jgd, pm = _operators(rng, masked)
    stats_mask = None
    if masked:
        stats_mask = gd.nbr_mask if kind == "edge" else pm
    jstats_mask = None if stats_mask is None else jnp.asarray(
        stats_mask.numpy())
    xj, x = _bf16(rng, (B, N, c_in))
    ct = rng.standard_normal((B, N, c_out)).astype(np.float32)
    layer = (jax_dc.EdgeMaxMLP if kind == "edge" else jax_dc.PointMaxMLP)(
        c_out, dtype="bfloat16")
    variables = layer.init(jax.random.PRNGKey(0), xj, jgd)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)

    def loss(p, a):
        out, mutated = layer.apply({"params": p, "batch_stats": stats}, a,
                                   jgd, train=True, stats_mask=jstats_mask,
                                   mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, mutated["batch_stats"])

    (_, (want, mutated)), (jgrad, want_dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, xj)

    port = (EdgeMaxMLP if kind == "edge" else PointMaxMLP)(
        c_in, c_out, dtype=torch.bfloat16)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.train()
    xg = x.clone().requires_grad_()
    got = port(xg, gd, stats_mask)
    (got.float() * _t(ct)).sum().backward()
    _check_layer(port, params, stats, jgrad, mutated, [got], [want])
    assert xg.grad.dtype == torch.bfloat16
    assert _frob(xg.grad, want_dx) < GRAD_FROB
    if masked:
        assert not got[1, 60:].float().any()  # padded points: no neighbour


@pytest.mark.parametrize("centralized,c_in,c_out,commuted,masked", [
    (True, 3, 8, False, False), (True, 3, 8, False, True),
    (False, 8, 16, False, True), (False, 16, 136, True, False)])
def test_deltaconv_bf16_train_matches_jax(centralized, c_in, c_out, commuted,
                                          masked, monkeypatch):
    """A whole bf16 DeltaConv in train mode: both streams, the bf16
    operator applies differentiated, the bf16 MLPs with f32 train
    BatchNorm, the VectorNonLin's f32 norm."""
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_TRAIN", commuted)
    rng = np.random.default_rng(4)
    gd, jgd, pm = _operators(rng, masked)
    xj, x = _bf16(rng, (B, N, c_in))
    vj, v = _bf16(rng, (B, N, 2, c_in))
    ct_x = rng.standard_normal((B, N, c_out)).astype(np.float32)
    ct_v = rng.standard_normal((B, N, 2, c_out)).astype(np.float32)
    jpm = None if pm is None else jnp.asarray(pm.numpy())
    layer = jax_dc.DeltaConv(c_out, centralized=centralized,
                             dtype="bfloat16")
    variables = layer.init(jax.random.PRNGKey(0), xj, vj, jgd)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)

    def loss(p):
        (xo, vo), mutated = layer.apply(
            {"params": p, "batch_stats": stats}, xj, vj, jgd, train=True,
            point_mask=jpm, mutable=["batch_stats"])
        return (jnp.sum(xo * ct_x) + jnp.sum(vo * ct_v),
                (xo, vo, mutated["batch_stats"]))

    (_, (jx, jv, mutated)), jgrad = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)

    port = DeltaConv(c_in, c_out, centralized=centralized,
                     dtype=torch.bfloat16)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.train()
    tx, tv = port(x, v, gd, pm)
    ((tx.float() * _t(ct_x)).sum() + (tv.float() * _t(ct_v)).sum()
     ).backward()
    _check_layer(port, params, stats, jgrad, mutated, [tx, tv], [jx, jv])


MODEL_WIDTHS = {  # widths, JAX hook: every PointMaxMLP on one branch
    "commuted": ((8, 136, 272), True),
    "per-point": ((16, 16, 16), False),
}


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("branch", list(MODEL_WIDTHS))
def test_bf16_train_step_matches_jax(branch, ragged, monkeypatch):
    """One train step of a narrow bf16 DeltaNetClassification (bf16
    compute and operators, exact kNN in both packages, dropout 0, SGD lr
    0.1, momentum 0.9, weight decay 1e-4, smoothing 0.2) from the same
    perturbed weights, against the JAX ``make_train_step``.

    The whole bf16 step is ill-conditioned at this size: a one-ulp
    difference anywhere (an FMA, a sum order) flips neighbour-max winners
    at bf16 ties and is amplified by the head's 8-row BatchNorm. The JAX
    bf16 step's own gradients lie 0.3 to 0.65 (mean relative Frobenius
    deviation over the tensors) from the f32 step's, and the port's from
    the JAX step's up to 1.3 on single small tensors (measured). So the
    gradients are held by their distance to the JAX f32 step: the port's
    mean deviation may exceed the JAX bf16 step's by at most 25%
    (measured ratios 0.97 to 1.07). A wrong rounding point or a missing
    term moves that distance far more; the modules above hold the same
    arithmetic where it is well conditioned. The loss is held to rtol
    3e-3 (measured up to 1.8e-3), the running statistics (forward
    quantities) to 2e-3 x max (measured up to 8.0e-4), and the port's
    SGD update to its own gradients exactly (f32 rounding)."""
    widths, hook = MODEL_WIDTHS[branch]
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_TRAIN", hook)
    rng = np.random.default_rng(5)
    nb = 8
    sizes = [N, 70, N, 80] * 2 if ragged else [N] * nb
    pos, nrm, mask = _clouds(rng, sizes)
    labels = rng.integers(0, 4, nb)
    cfg = dict(conv_channels=widths, embedding_size=32, num_neighbors=K,
               dropout=0.0, compute_dtype="bfloat16",
               operator_dtype="bfloat16")
    model = JaxModel(num_classes=4, **cfg)
    variables = jax.jit(lambda key, p, n_: model.init(key, p, normal=n_))(
        jax.random.PRNGKey(0), pos, nrm)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)
    jbatch = {"pos": jnp.asarray(pos), "normal": jnp.asarray(nrm),
              "label": jnp.asarray(labels)}
    tbatch = {"pos": _t(pos), "normal": _t(nrm), "label": _t(labels)}
    if ragged:
        jbatch["point_mask"] = jnp.asarray(mask)
        tbatch["point_mask"] = _t(mask)

    f32 = JaxModel(num_classes=4, **dict(cfg, compute_dtype=None,
                                          operator_dtype=None))

    def loss_fn(params_):
        logits, _ = f32.apply(
            {"params": params_, "batch_stats": stats}, jbatch["pos"],
            train=True, normal=jbatch["normal"],
            point_mask=jbatch.get("point_mask"), mutable=["batch_stats"])
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

    port = DeltaNetClassification(4, **cfg)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    state = create_train_state(port, sgd_momentum(0.1), device="cpu")
    tm = make_train_step(port, smoothing=0.2)(state, tbatch, None)

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=3e-3)
    # The gradients of the JAX step, from its first SGD update
    # (momentum buffer = gradient + weight decay): old - 0.1 (g + 1e-4 old).
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    dev, err_port, err_jax = [], [], []
    for key, p in port.named_parameters():
        assert p.dtype == torch.float32
        o = old[key].numpy()
        jgrad = (o - want[key].numpy()) / 0.1 - 1e-4 * o
        np.testing.assert_allclose(  # the port's update of its gradient
            got[key].numpy(), o - 0.1 * (p.grad.numpy() + 1e-4 * o),
            rtol=0, atol=1e-6 * float(np.abs(o).max()), err_msg=key)
        dev.append(_frob(p.grad, jgrad))
        err_port.append(_frob(p.grad, f32_grad[key].numpy()))
        err_jax.append(_frob(_t(jgrad), f32_grad[key].numpy()))
    print(f"{branch} {'ragged' if ragged else 'uniform'}: loss "
          f"{float(tm['loss'])} vs {float(jm['loss'])}; gradients: worst "
          f"deviation from JAX {max(dev):.3e}, mean deviation from the f32 "
          f"step {np.mean(err_port):.3e} (JAX bf16: {np.mean(err_jax):.3e})")
    assert np.mean(err_port) <= 1.25 * np.mean(err_jax)
    for key, w in want.items():
        if ".running_" in key:
            _within(got[key], w.numpy(), STEP_STATS_REL, key)
