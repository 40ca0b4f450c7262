"""Segmentation training of deltaconv_tpu_torch against the JAX package on
the CPU: ``DeepMaxMLP`` in train mode (its three branches), a narrow
``DeltaNetSegmentation`` through ``make_train_step(per_point=True)`` and
``make_eval_step`` with categories.

Inputs are made with numpy from a seed and handed to both packages, and
the weights move with ``state_dict_from_flax``. Routing: off the TPU the
JAX ``DeepMaxMLP`` takes its fused train branches only under the test
hook ``_FORCE_FUSED_TRAIN`` (the edge MLP in Pallas interpret mode under
``_FORCE_FUSED_INTERPRET`` too); the port takes the TPU's route on every
device, with the fused centralized branch under its own switch
``_EDGE_FUSED_TRAIN`` (off by default, as JAX's). So each case sets both
packages on one branch:

- (a) the fused centralized depth-2 branch: port switch on, JAX hook on;
- (b) the commuted branch of a non-centralized conv whose last layer is
  lane-narrower (8 -> 16 -> 136): JAX hook on; the port takes it alone;
- (c) the reference pipeline (the edge tensor, or the per-point MLP and
  the neighbour max): f32, and bf16 with both off.

Tolerances, and why:

- f32 modules: outputs and running statistics within 1e-5 x max,
  gradients within 1e-4 x max (f32 sums in another order).
- bf16 modules, as ``tests/test_torch_bf16_train.py`` holds them: outputs
  within one bf16 ulp x max (XLA's CPU compiler contracts the epilogues
  into FMAs), running statistics within 1e-5 x max, gradients by their
  relative Frobenius deviation (below 2e-2; a one-ulp difference moves a
  max winner and a whole cotangent).
- Branch (a) against JAX's (a): JAX's CPU reference of the neighbour sum
  (``gather_sum``) sums the bf16 table ``[y, y^2]`` into bf16, where its
  TPU kernel and the port's sum it exactly in f32; the first layer's
  moments then differ by about 2^-9 relative, the edges' affine with
  them. Outputs within 2e-2 x max, running statistics within 2e-3 x max,
  gradients below 5e-2 (relative Frobenius).
- Branch (a) with a statistics mask that is not the graph's: the JAX
  fused branch takes its second BatchNorm's moments under ``nbr_mask``
  (ADVICE r5, ``deltaconv_tpu/nn/deltaconv.py:601-603``); the port takes
  them under the mask it is given, and is held to JAX's reference branch
  (c), which does the same, at the JAX package's own commute tolerance
  between its two branches (``rtol = atol = 5e-2``,
  ``tests/ops/test_edge_mlp.py``).
- The f32 train step: 3 SGD steps (lr 0.01, dropout 0) from the same JAX
  init with randomized running statistics, as the classification step is
  held (``tests/test_torch_train.py``): loss rtol 1e-5, parameters and
  statistics within 1e-4 x max (plus 1e-9: the embedding's BatchNorm bias,
  ``lin_global.0.1.bn.bias``, has a gradient that cancels to f32 rounding
  and moves by ~1e-11 in both packages), the masked accuracy equal. At
  B=2 the f32 step is chaotic: a neighbour-max winner at a near-tie flips
  in one package and not the other, and a BatchNorm bias (a cancelling
  sum) moves by up to 5e-2 x max. Measured over seeds 105..116: on 9 of
  12 such a flip happened in the 3 steps of the uniform or the ragged
  batch, the port's run as often as JAX's the one away from a jax x64
  run of the same steps (seed 104, uniform: the port's step 2 at 4.6e-3
  x max from x64, JAX's at 5.8e-6; ragged, step 3: the port's at 6.0e-6,
  JAX's at 3.2e-3). So the per-element test takes its batch from seed
  113, flip-free in both (measured within 6.9e-6 x max), as the
  classification test does, and a second test holds the chaos itself:
  over the uniform and ragged batches of seeds 104..107 both packages'
  f32 runs are held against a jax x64 run of the same 3 steps, and the
  port may leave the tight bound (1e-4 x max on some tensor, the
  cancelling bias above left out) in at most one run more than JAX
  does (measured over seeds 104..116: the port in 12 of 26 runs, JAX in
  13, both in 8 of them, where the x64 run took the other winner; over
  104..107 each in 4 of 8). A step that computes something else is off
  the x64 run in every run it touches: with a per-point loss that
  ignores ``point_mask`` the port left it in 7 of the 8.
- The bf16 step is chaotic at a test's size (one-ulp differences flip max
  winners at bf16 ties): as the bf16 classification step
  (``tests/test_torch_bf16_train.py``), its gradients are
  held by their distance to the JAX f32 step's, at most 1.25 times the
  JAX bf16 step's (mean relative Frobenius deviation over the tensors,
  leaving out those whose f32 gradient is rounding noise, below 1e-6 of
  the largest: ``lin_global.0.1.bn.bias``, above), and so are the updated
  running statistics (their distance to the f32 step's), since the
  segmentation head's BatchNorm over 2 clouds moves them by up to 4.7e-3
  x max between the two bf16 steps (measured); the loss to rtol 3e-3
  (measured up to 3.5e-4). Measured ratios of the port's distance to
  JAX's: gradients 0.67 to 1.09, statistics 0.92 to 1.07.
- The eval step: logits within 1e-4 x max|logit| (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.nn.deltaconv as jax_dc
import deltaconv_tpu_torch.nn.deltaconv as port_dc
from deltaconv_tpu.geometry.dense import DenseGradDiv as JaxDenseGradDiv
from deltaconv_tpu.models import DeltaNetSegmentation as JaxModel
from deltaconv_tpu.training import TrainState as JaxTrainState
from deltaconv_tpu.training import make_eval_step as jax_eval_step
from deltaconv_tpu.training import make_train_step as jax_train_step
from deltaconv_tpu.training import sgd_momentum as jax_sgd
from deltaconv_tpu.training import smooth_cross_entropy as jax_sce
from deltaconv_tpu_torch import DeltaNetSegmentation, state_dict_from_flax
from deltaconv_tpu_torch.models import build_operators
from deltaconv_tpu_torch.nn import DeepMaxMLP
from deltaconv_tpu_torch.training import (create_train_state,
                                          make_eval_step, make_train_step,
                                          sgd_momentum)

torch.set_num_threads(1)

B, N, K = 2, 96, 8
ULP = 2.0 ** -8  # one bf16 ulp, relative
GRAD_FROB = 2e-2  # bf16 modules: relative Frobenius deviation
FUSED_OUT_REL, FUSED_STATS_REL, FUSED_FROB = 2e-2, 2e-3, 5e-2  # (a) vs (a)
COMMUTE_TOL = 5e-2  # the JAX package's fused-vs-reference bound
NUM_CLASSES = 6
WIDTH = dict(conv_channels=(8, 16, 136), embedding_size=32,
             num_neighbors=K, categorical_vector=True)
LR = 0.01


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(t):
    return t.detach().float().numpy()


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


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


def _operators(rng, masked, dtype):
    """The port's dense operators of a batch, the same arrays as a JAX
    DenseGradDiv, and the point mask (None when uniform)."""
    pos, nrm, mask = _clouds(rng, [N, 60] if masked else [N] * B)
    pm = _t(mask) if masked else None
    gd = build_operators(_t(pos), K, _t(nrm), pm, operator_dtype=dtype)
    jdt = jnp.bfloat16 if dtype else jnp.float32
    jgd = JaxDenseGradDiv(
        jnp.asarray(gd.nbr_idx.numpy()), jnp.asarray(gd.nbr_mask.numpy()),
        *(jnp.asarray(w.float().numpy()).astype(jdt)
          for w in (gd.w_grad, gd.w_div)))
    return gd, jgd, pm


def _inputs(rng, shape, dtype):
    """(jnp, torch) of the same values, bf16-rounded for bf16."""
    a = rng.standard_normal(shape).astype(np.float32)
    if dtype is None:
        return jnp.asarray(a), _t(a)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(np.asarray(j, np.float32)).to(torch.bfloat16)


def _within(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _frob(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(_np(got) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _jax_layer_run(layer, params, stats, x, jgd, smask, ct):
    """Output, updated statistics, parameter and input gradients of one
    train-mode JAX ``DeepMaxMLP``."""
    def loss(p, a):
        out, mutated = layer.apply({"params": p, "batch_stats": stats}, a,
                                   jgd, train=True, stats_mask=smask,
                                   mutable=["batch_stats"])
        return (jnp.sum(out.astype(jnp.float32) * ct),
                (out, mutated["batch_stats"]))

    (_, (out, mutated)), grads = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, x)
    return out, _to_numpy(mutated), grads


def _port_layer_run(c_in, channels, centralized, tdt, params, stats, x, gd,
                    smask, ct):
    port = DeepMaxMLP(c_in, channels, centralized, tdt)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.train()
    xg = x.clone().requires_grad_()
    out = port(xg, gd, smask)
    (out.float() * _t(ct)).sum().backward()
    return port, out, xg.grad


MODULE_CASES = {  # dtype, centralized, c_in, channels, branch
    "f32-centralized": (None, True, 3, (16, 16), "c"),
    "f32-point": (None, False, 8, (24, 24), "c"),
    "bf16-centralized-reference": ("bfloat16", True, 3, (16, 16), "c"),
    "bf16-point": ("bfloat16", False, 8, (16, 16), "c"),
    "bf16-centralized-fused": ("bfloat16", True, 3, (16, 16), "a"),
    "bf16-narrower": ("bfloat16", False, 8, (16, 136), "b"),
}


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "masked"])
@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_deep_max_mlp_train_matches_jax(case, masked, monkeypatch):
    """``DeepMaxMLP`` in train mode, each branch against the JAX module's
    (module docstring for the routing and the tolerances), with and
    without a statistics mask (the graph's edges when centralized, as
    ``DeltaConv`` passes them; the points otherwise): outputs, updated
    running statistics, parameter and input gradients."""
    dtype, centralized, c_in, channels, branch = MODULE_CASES[case]
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_TRAIN", branch != "c")
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", branch == "a")
    monkeypatch.setattr(port_dc, "_EDGE_FUSED_TRAIN", branch == "a")
    rng = np.random.default_rng(100)
    gd, jgd, pm = _operators(rng, masked, dtype)
    smask = None
    if masked:
        smask = gd.nbr_mask if centralized else pm
    jsmask = None if smask is None else jnp.asarray(smask.numpy())
    xj, x = _inputs(rng, (B, N, c_in), dtype)
    ct = rng.standard_normal((B, N, channels[-1])).astype(np.float32)
    layer = jax_dc.DeepMaxMLP(channels, centralized=centralized, dtype=dtype)
    variables = layer.init(jax.random.PRNGKey(0), xj, jgd)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)
    want, mutated, (jgrad, want_dx) = _jax_layer_run(
        layer, params, stats, xj, jgd, jsmask, ct)

    tdt = torch.bfloat16 if dtype else None
    port, got, dx = _port_layer_run(c_in, channels, centralized, tdt, params,
                                    stats, x, gd, smask, ct)
    assert got.dtype == (tdt or torch.float32) and got.shape == (
        B, N, channels[-1])
    if masked:
        assert not got[1, 60:].float().any()  # padded points
    out_rel, stats_rel = (1e-5, 1e-5) if dtype is None else (ULP, 1e-5)
    if branch == "a":
        out_rel, stats_rel = FUSED_OUT_REL, FUSED_STATS_REL
    _within(got, want, out_rel, "output")
    want_stats = state_dict_from_flax(params, mutated)
    for key, b in port.named_buffers():
        _within(b, want_stats[key].numpy(), stats_rel, key)
    zero = jax.tree_util.tree_map(np.zeros_like, stats)
    want_grad = state_dict_from_flax(_to_numpy(jgrad), zero)
    for key, p in port.named_parameters():
        if dtype is None:
            _within(p.grad, want_grad[key].numpy(), 1e-4, key)
        else:
            frob = _frob(p.grad, want_grad[key].numpy())
            assert frob < (FUSED_FROB if branch == "a" else GRAD_FROB), (
                key, frob)
    assert dx.dtype == x.dtype
    if dtype is None:
        _within(dx, want_dx, 1e-4, "dx")
    else:
        assert _frob(dx, want_dx) < (FUSED_FROB if branch == "a"
                                     else GRAD_FROB)


def test_fused_branch_takes_its_statistics_mask(monkeypatch):
    """Branch (a) with a statistics mask that is not the graph's (a third
    of the valid edges left out): held to the JAX reference branch (c),
    which takes its second BatchNorm's moments under that mask as the port
    does, at the JAX package's fused-vs-reference tolerance; the JAX
    fused branch, which takes them under ``nbr_mask``, moves the running
    statistics of ``bn1`` farther from (c) than the port does."""
    monkeypatch.setattr(port_dc, "_EDGE_FUSED_TRAIN", True)
    rng = np.random.default_rng(101)
    gd, jgd, _ = _operators(rng, True, "bfloat16")
    smask = gd.nbr_mask & _t(rng.random((B, N, K)) > 0.33)
    smask[:, :, 0] = gd.nbr_mask[:, :, 0]
    jsmask = jnp.asarray(smask.numpy())
    xj, x = _inputs(rng, (B, N, 3), "bfloat16")
    ct = rng.standard_normal((B, N, 16)).astype(np.float32)
    layer = jax_dc.DeepMaxMLP((16, 16), centralized=True, dtype="bfloat16")
    variables = layer.init(jax.random.PRNGKey(0), xj, jgd)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)
    want, mutated, _ = _jax_layer_run(layer, params, stats, xj, jgd, jsmask,
                                      ct)
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_TRAIN", True)
    _, mutated_fault, _ = _jax_layer_run(layer, params, stats, xj, jgd,
                                         jsmask, ct)
    port, got, _ = _port_layer_run(3, (16, 16), True, torch.bfloat16, params,
                                   stats, x, gd, smask, ct)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=COMMUTE_TOL, atol=COMMUTE_TOL)
    want_stats = state_dict_from_flax(params, mutated)
    fault_stats = state_dict_from_flax(params, mutated_fault)
    for key, b in port.named_buffers():
        np.testing.assert_allclose(_np(b), want_stats[key].numpy(),
                                   rtol=COMMUTE_TOL, atol=COMMUTE_TOL,
                                   err_msg=key)
    key = "1.1.bn.running_var"
    ours = float(np.abs(_np(dict(port.named_buffers())[key])
                        - want_stats[key].numpy()).max())
    theirs = float(np.abs(fault_stats[key].numpy()
                          - want_stats[key].numpy()).max())
    print(f"bn1 running_var from the reference branch: port {ours:.3e}, "
          f"JAX fused branch {theirs:.3e}")
    assert ours < theirs


# -- the model and the steps -------------------------------------------------


def _seg_batch(rng, masked):
    sizes = [N, 70] if masked else [N] * B
    pos, nrm, mask = _clouds(rng, sizes)
    labels = rng.integers(0, NUM_CLASSES, (B, N))
    cat = np.eye(16, dtype=np.float32)[[3, 11]]
    jbatch = {"pos": jnp.asarray(pos), "normal": jnp.asarray(nrm),
              "label": jnp.asarray(labels), "category": jnp.asarray(cat)}
    tbatch = {"pos": _t(pos), "normal": _t(nrm), "label": _t(labels),
              "category": _t(cat)}
    if masked:
        jbatch["point_mask"] = jnp.asarray(mask)
        tbatch["point_mask"] = _t(mask)
    return jbatch, tbatch


def _seg_variables(model, jbatch, rng, stats_only):
    variables = jax.jit(lambda key, p, n_, c: model.init(
        key, p, normal=n_, category=c))(
        jax.random.PRNGKey(0), jbatch["pos"], jbatch["normal"],
        jbatch["category"])
    return (_perturb(_to_numpy(variables["params"]), rng, stats_only),
            _perturb(_to_numpy(variables["batch_stats"]), rng, stats_only))


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "ragged"])
def test_three_seg_train_steps_match_jax(masked):
    """3 SGD steps of the f32 ``make_train_step(per_point=True)`` with
    categories against JAX's (module docstring), then the eval step."""
    rng = np.random.default_rng(113)
    jbatch, tbatch = _seg_batch(rng, masked)
    model = JaxModel(num_classes=NUM_CLASSES, dropout=0.0, **WIDTH)
    params, stats = _seg_variables(model, jbatch, rng, stats_only=True)
    state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                 batch_stats=stats, tx=jax_sgd(LR))
    jstep = jax_train_step(model, smoothing=0.0, per_point=True)

    port = DeltaNetSegmentation(NUM_CLASSES, dropout=0.0, **WIDTH)
    port.load_state_dict(state_dict_from_flax(params, stats,
                                              head="segmentation"),
                         strict=True)
    tstate = create_train_state(port, sgd_momentum(LR), device="cpu")
    tstep = make_train_step(port, smoothing=0.0, per_point=True)
    for i in range(3):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        tm = tstep(tstate, tbatch, None)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(tm["accuracy"]),
                                   float(jm["accuracy"]), rtol=1e-6)
        want = state_dict_from_flax(_to_numpy(state.params),
                                    _to_numpy(state.batch_stats),
                                    head="segmentation")
        got = port.state_dict()
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(
                _np(got[key]), w.numpy(), rtol=0,
                atol=1e-4 * float(w.abs().max()) + 1e-9,
                err_msg=f"{key}, step {i}")
    want = jax_eval_step(model, per_point=True)(state, jbatch)
    got = make_eval_step(port, per_point=True)(tstate, tbatch)
    assert got.shape == (B, N, NUM_CLASSES)
    _within(got, want, 1e-4, "eval logits")


X64_SEEDS = range(104, 108)
NEAR_X64 = 1e-4  # the 3-step test's per-element bound, x max


def _jax_seg_steps(model, params, stats, jbatch, dtype):
    """The state dicts after each of 3 JAX f32 (or, under x64, f64) SGD
    steps, as f64 numpy."""
    def cast(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)

    def as_f64(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      dict(tree))

    batch = {k: jnp.asarray(v, dtype) if jnp.issubdtype(v.dtype, jnp.floating)
             else v for k, v in jbatch.items()}
    state = JaxTrainState.create(apply_fn=model.apply, params=cast(params),
                                 batch_stats=cast(stats), tx=jax_sgd(LR))
    step = jax_train_step(model, smoothing=0.0, per_point=True)
    out = []
    for i in range(3):
        state, _ = step(state, batch, jax.random.PRNGKey(i))
        out.append(state_dict_from_flax(as_f64(state.params),
                                        as_f64(state.batch_stats),
                                        head="segmentation"))
    return out


def _x64_distance(got, ref):
    """The largest deviation of any tensor from the x64 run's, x its max,
    leaving out the cancelling ``lin_global.0.1.bn.bias``."""
    return max(float(np.abs(np.asarray(got[k], np.float64) - w.numpy()).max()
                     / max(float(w.abs().max()), 1e-30))
               for k, w in ref.items() if k != "lin_global.0.1.bn.bias")


def test_f32_seg_steps_leave_the_x64_run_no_more_often_than_jax():
    """The f32 seg steps' chaos (module docstring): over seeds 104..107,
    uniform and ragged, the port's 3 steps leave the jax x64 run's tight
    bound in at most one run more than JAX's f32 steps do."""
    far = {"port": 0, "jax": 0}
    for seed in X64_SEEDS:
        for masked in (False, True):
            rng = np.random.default_rng(seed)
            jbatch, tbatch = _seg_batch(rng, masked)
            model = JaxModel(num_classes=NUM_CLASSES, dropout=0.0, **WIDTH)
            params, stats = _seg_variables(model, jbatch, rng,
                                           stats_only=True)
            j32 = _jax_seg_steps(model, params, stats, jbatch, jnp.float32)
            with jax.enable_x64(True):
                j64 = _jax_seg_steps(model, params, stats, jbatch,
                                     jnp.float64)
            port = DeltaNetSegmentation(NUM_CLASSES, dropout=0.0, **WIDTH)
            port.load_state_dict(state_dict_from_flax(
                params, stats, head="segmentation"), strict=True)
            tstate = create_train_state(port, sgd_momentum(LR), device="cpu")
            tstep = make_train_step(port, smoothing=0.0, per_point=True)
            d_port, d_jax = [], []
            for i in range(3):
                tstep(tstate, tbatch, None)
                got = {k: _np(v) for k, v in port.state_dict().items()}
                d_port.append(_x64_distance(got, j64[i]))
                d_jax.append(_x64_distance(j32[i], j64[i]))
            far["port"] += max(d_port) > NEAR_X64
            far["jax"] += max(d_jax) > NEAR_X64
            print(f"seed {seed} {'ragged' if masked else 'uniform'}: from "
                  f"x64, port {['%.1e' % d for d in d_port]}, JAX f32 "
                  f"{['%.1e' % d for d in d_jax]}")
    print(f"runs beyond {NEAR_X64} x max of x64: {far}")
    assert far["port"] <= far["jax"] + 1


MODEL_BRANCHES = {"reference": False, "fused": True}  # conv0 in bf16


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("conv0", list(MODEL_BRANCHES))
def test_bf16_seg_train_step_matches_jax(conv0, masked, monkeypatch):
    """One bf16 train step (compute and operators, exact kNN in both
    packages, dropout 0, smoothing 0) from the same perturbed weights
    against JAX's, the first conv on the reference branch (both switches
    off) or the fused one (port switch, JAX hook); held as the module
    docstring says."""
    fused = MODEL_BRANCHES[conv0]
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_TRAIN", fused)
    monkeypatch.setattr(port_dc, "_EDGE_FUSED_TRAIN", fused)
    rng = np.random.default_rng(103)
    jbatch, tbatch = _seg_batch(rng, masked)
    cfg = dict(WIDTH, dropout=0.0, compute_dtype="bfloat16",
               operator_dtype="bfloat16")
    model = JaxModel(num_classes=NUM_CLASSES, **cfg)
    params, stats = _seg_variables(model, jbatch, rng, stats_only=False)
    f32 = JaxModel(num_classes=NUM_CLASSES, **dict(
        cfg, compute_dtype=None, operator_dtype=None))

    def loss_fn(params_):
        logits, mutated = f32.apply(
            {"params": params_, "batch_stats": stats}, jbatch["pos"],
            train=True, normal=jbatch["normal"],
            category=jbatch["category"],
            point_mask=jbatch.get("point_mask"), mutable=["batch_stats"])
        return (jax_sce(logits, jbatch["label"], 0.0,
                        jbatch.get("point_mask")), mutated["batch_stats"])

    zero = jax.tree_util.tree_map(np.zeros_like, stats)
    grads, f32_stats = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    f32_grad = state_dict_from_flax(_to_numpy(grads), zero,
                                    head="segmentation")
    f32_state = state_dict_from_flax(params, _to_numpy(f32_stats),
                                     head="segmentation")
    jstate = JaxTrainState.create(apply_fn=model.apply, params=params,
                                  batch_stats=stats, tx=jax_sgd(LR))
    jstate, jm = jax_train_step(model, smoothing=0.0, per_point=True)(
        jstate, jbatch, jax.random.PRNGKey(0))
    want = state_dict_from_flax(_to_numpy(jstate.params),
                                _to_numpy(jstate.batch_stats),
                                head="segmentation")
    old = state_dict_from_flax(params, stats, head="segmentation")

    port = DeltaNetSegmentation(NUM_CLASSES, **cfg)
    port.load_state_dict(old, strict=True)
    state = create_train_state(port, sgd_momentum(LR), device="cpu")
    tm = make_train_step(port, smoothing=0.0, per_point=True)(
        state, tbatch, None)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=3e-3)
    got = port.state_dict()
    scale = max(float(np.linalg.norm(g.numpy())) for g in f32_grad.values())
    err_port, err_jax = [], []
    for key, p in port.named_parameters():
        assert p.dtype == torch.float32
        if np.linalg.norm(f32_grad[key].numpy()) < 1e-6 * scale:
            continue  # an f32 gradient of rounding noise
        o = old[key].numpy()
        jgrad = (o - want[key].numpy()) / LR - 1e-4 * o
        err_port.append(_frob(p.grad, f32_grad[key].numpy()))
        err_jax.append(_frob(_t(jgrad), f32_grad[key].numpy()))
    stats_port, stats_jax = [], []
    for key, w in f32_state.items():
        if ".running_" in key:
            stats_port.append(_frob(got[key], w.numpy()))
            stats_jax.append(_frob(want[key], w.numpy()))
    print(f"{conv0} {'ragged' if masked else 'uniform'}: loss "
          f"{float(tm['loss'])} vs {float(jm['loss'])}; mean deviation from "
          f"the f32 step: gradients {np.mean(err_port):.3e} (JAX bf16: "
          f"{np.mean(err_jax):.3e}), running statistics "
          f"{np.mean(stats_port):.3e} (JAX bf16: {np.mean(stats_jax):.3e})")
    assert np.mean(err_port) <= 1.25 * np.mean(err_jax)
    assert np.mean(stats_port) <= 1.25 * np.mean(stats_jax)


def test_steps_pass_categories_and_features_to_the_model():
    """The steps hand ``category`` to the model (a categorical model
    without it raises in the model, as JAX's) and per-point ``features``
    (4 channels: the positions and the first normal component; the model
    built with ``in_channels=4``): the f32 eval logits and one train
    step's loss and parameters against JAX's steps on the same batch and
    weights, as :func:`test_three_seg_train_steps_match_jax` holds them."""
    rng = np.random.default_rng(104)
    jbatch, tbatch = _seg_batch(rng, True)
    feats = np.concatenate([np.asarray(jbatch["pos"]),
                            np.asarray(jbatch["normal"])[..., :1]], -1)
    jbatch["features"], tbatch["features"] = jnp.asarray(feats), _t(feats)
    model = JaxModel(num_classes=NUM_CLASSES, dropout=0.0, **WIDTH)
    variables = jax.jit(lambda key, p, n_, f, c: model.init(
        key, p, normal=n_, features=f, category=c))(
        jax.random.PRNGKey(0), jbatch["pos"], jbatch["normal"],
        jbatch["features"], jbatch["category"])
    params = _perturb(_to_numpy(variables["params"]), rng, True)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng, True)
    jstate = JaxTrainState.create(apply_fn=model.apply, params=params,
                                  batch_stats=stats, tx=jax_sgd(LR))
    port = DeltaNetSegmentation(NUM_CLASSES, dropout=0.0, in_channels=4,
                                **WIDTH)
    port.load_state_dict(state_dict_from_flax(params, stats, "segmentation"),
                         strict=True)
    state = create_train_state(port, sgd_momentum(LR), device="cpu")
    logits = make_eval_step(port)(state, tbatch)
    assert logits.shape == (B, N, NUM_CLASSES)
    want = jax_eval_step(model, per_point=True)(jstate, jbatch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    bare = {k: v for k, v in tbatch.items() if k != "category"}
    with pytest.raises(ValueError, match="category"):
        make_eval_step(port)(state, bare)
    jstate, jm = jax_train_step(model, smoothing=0.0, per_point=True)(
        jstate, jbatch, jax.random.PRNGKey(0))
    tm = make_train_step(port, smoothing=0.0, per_point=True)(state, tbatch,
                                                              None)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = state_dict_from_flax(_to_numpy(jstate.params),
                                _to_numpy(jstate.batch_stats), "segmentation")
    for key, w in port.state_dict().items():
        np.testing.assert_allclose(
            _np(w), want[key].numpy(), rtol=0,
            atol=1e-4 * float(want[key].abs().max()) + 1e-9, err_msg=key)


def test_seg_head_dropout_draws_from_the_generator():
    """Train-mode dropout in the head draws from the step's generator:
    the same seed gives the same step, another seed another."""
    rng = np.random.default_rng(105)
    _, tbatch = _seg_batch(rng, False)

    def one_step(seed):
        port = DeltaNetSegmentation(NUM_CLASSES, dropout=0.5,
                                    generator=torch.Generator().manual_seed(0),
                                    **WIDTH)
        state = create_train_state(port, sgd_momentum(LR), device="cpu")
        gen = torch.Generator().manual_seed(seed)
        return float(make_train_step(port, per_point=True)(
            state, tbatch, gen)["loss"])

    assert one_step(1) == one_step(1) != one_step(2)
