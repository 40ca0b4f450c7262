"""Point-sharded training in deltaconv_tpu_torch
(``parallel.point_sharded_train_step``) against the JAX package on the
CPU: ONE cloud whose rows are spread over 2 ``gloo`` ranks spawned by
``parallel.launch.run_ranks`` (every case in one job, one spawn), the
JAX side on ``Mesh(jax.devices()[:2])``, jitted. This module imports JAX
inside its functions, so the spawned ranks load torch alone; weights
cross with ``state_dict_from_flax``.

Cases: classification at JAX ``test_point_sharding.py``'s config (n=128,
k=12, conv channels (16, 16), 5 classes, coefficient operators; one
cloud, so the head's BatchNorms see one row and pass the backbone no
gradient, as in JAX); segmentation as JAX's ``test_point_sharding.py:
216``, reduced to n=128 (k=10, (16, 16), depth 1, the categorical head,
7 classes); and the padded cloud of rule 2: 97 points, padded to 98 by
``pad_cloud``, the padding on the last rank.

Tolerances, and why:

- the port's 2-rank steps against JAX at dropout 0 (JAX's single-device
  ``make_train_step`` on the one-cloud batch, and JAX's
  ``point_sharded_train_step``): tests/test_torch_train.py's bounds, loss
  rtol 1e-5, parameters within 1e-3 x the tensor's max, running
  statistics within 1e-4 x max; or, where JAX's own two steps part by
  more, within twice their distance (two BatchNorm biases of the
  segmentation head, whose gradients are rounding noise);
- the port's 2-rank steps against its 1-process steps at dropout 0.5
  (every rank draws the whole cloud's masks): JAX's data-parallel bounds
  (tests/training/test_parallel.py), loss rtol 1e-5, atol 1e-5 + rtol
  1e-4;
- the ranks against each other, and two calls from one state: bit-equal.
"""

import numpy as np
import pytest
import torch

from deltaconv_tpu_torch import (DeltaNetClassification, DeltaNetSegmentation,
                                 state_dict_from_flax)
from deltaconv_tpu_torch.parallel import (pad_cloud, point_sharded_train_step,
                                          shard_rows)
from deltaconv_tpu_torch.parallel.launch import run_ranks
from deltaconv_tpu_torch.training import create_train_state, sgd_momentum

torch.set_num_threads(1)

LR = 0.05  # JAX test_point_sharding.py
STEPS = 2
LOSS_RTOL = 1e-5
JAX_PARAM_REL, JAX_STATS_REL = 1e-3, 1e-4  # tests/test_torch_train.py
DP_ATOL, DP_RTOL = 1e-5, 1e-4  # tests/training/test_parallel.py
SPAWN_TIMEOUT = 240
CLS = dict(num_classes=5, conv_channels=(16, 16), num_neighbors=12,
           embedding_size=32, dense_operators=False)
SEG = dict(num_classes=7, conv_channels=(16, 16), mlp_depth=1,
           embedding_size=32, categorical_vector=True, num_neighbors=10,
           dense_operators=False)
CATEGORY = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(rng, n):
    """A unit-sphere cloud with its normals."""
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    pos *= rng.uniform(0.7, 1.3, 3).astype(np.float32)
    return pos, pos / np.linalg.norm(pos, axis=1, keepdims=True)


def _bit_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


# -- the rank job -------------------------------------------------------------


def _port_steps(case, group):
    """``STEPS`` point-sharded steps on this rank's rows of the padded
    cloud (``group=None``: the whole cloud in one process): losses,
    accuracies and the final ``state_dict``."""
    seg = case["seg"]
    widths = dict(SEG if seg else CLS, dropout=case["dropout"])
    model = (DeltaNetSegmentation if seg else DeltaNetClassification)(
        **widths)
    model.load_state_dict(case["state"], strict=True)
    state = create_train_state(model, sgd_momentum(LR), device="cpu")
    step = point_sharded_train_step(model, group, smoothing=0.2,
                                    per_point=seg)
    pos, nrm, mask = pad_cloud(_t(case["pos"]), 2, _t(case["normal"]))
    label = _t(case["label"])
    if seg:
        label = shard_rows(torch.cat([label, label.new_zeros(
            pos.shape[0] - label.shape[0])]), group)
    kwargs = {}
    if seg:
        kwargs["category"] = torch.nn.functional.one_hot(
            torch.tensor(CATEGORY), 16).float()
    gen = torch.Generator().manual_seed(11)
    metrics = [step(state, shard_rows(pos, group), shard_rows(nrm, group),
                    label, gen, point_mask=shard_rows(mask, group), **kwargs)
               for _ in range(STEPS)]
    return ([float(m["loss"]) for m in metrics],
            [float(m["accuracy"]) for m in metrics],
            {k: v.clone() for k, v in model.state_dict().items()})


def _shard_job(group, job):
    """A spawned rank: every case twice (two calls from the same state
    must give the same bits)."""
    return {name: (_port_steps(case, group), _port_steps(case, group))
            for name, case in job.items()}


# -- JAX ----------------------------------------------------------------------


def _jax_case(seg, pos, nrm, label):
    """The JAX model and its variables for ``pos`` padded to a multiple
    of 2 (the categorical one-hot for segmentation)."""
    import jax
    import jax.numpy as jnp

    from deltaconv_tpu.models import DeltaNetClassification as JaxCls
    from deltaconv_tpu.models import DeltaNetSegmentation as JaxSeg
    from deltaconv_tpu.parallel.point_sharding import pad_cloud as jax_pad

    model = (JaxSeg if seg else JaxCls)(dropout=0.0,
                                        **(SEG if seg else CLS))
    p, n, m = jax_pad(jnp.asarray(pos), 2, jnp.asarray(nrm))
    kwargs = {"normal": n[None]}
    cat = None
    if seg:
        cat = jnp.zeros((16,)).at[CATEGORY].set(1.0)
        kwargs["category"] = cat[None]
        label = np.concatenate([label, np.zeros(p.shape[0] - len(label),
                                                label.dtype)])
    variables = jax.jit(lambda k, p_: model.init(k, p_, **kwargs))(
        jax.random.PRNGKey(2 if seg else 1), p[None])
    return model, variables, (p, n, m, jnp.asarray(label), cat)


def _to_port(seg, params, stats):
    import jax
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))  # noqa
    return state_dict_from_flax(to_np(params), to_np(stats),
                                "segmentation" if seg else "classification")


def _jax_steps(seg, model, variables, inputs, sharded):
    """JAX's ``STEPS`` steps: ``point_sharded_train_step`` on a 2-device
    mesh (jitted), or ``make_train_step`` on the one-cloud batch."""
    import jax
    from jax.sharding import Mesh

    from deltaconv_tpu.parallel.point_sharding import (
        point_sharded_train_step as jax_sharded)
    from deltaconv_tpu.training import TrainState, make_train_step
    from deltaconv_tpu.training import sgd_momentum as jax_sgd

    p, n, m, label, cat = inputs
    state = TrainState.create(apply_fn=model.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=jax_sgd(LR))
    losses = []
    if sharded:
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("points",))
        step = jax.jit(jax_sharded(mesh, model, smoothing=0.2,
                                   per_point=seg))
        for i in range(STEPS):
            state, metrics = step(state, p, n, label, jax.random.PRNGKey(i),
                                  point_mask=m, category=cat)
            losses.append(float(metrics["loss"]))
    else:
        step = make_train_step(model, smoothing=0.2, per_point=seg)
        batch = {"pos": p[None], "normal": n[None], "point_mask": m[None],
                 "label": label[None] if seg else label.reshape(1)}
        if seg:
            batch["category"] = cat[None]
        for i in range(STEPS):
            state, metrics = step(state, batch, jax.random.PRNGKey(i))
            losses.append(float(metrics["loss"]))
    return losses, _to_port(seg, state.params, state.batch_stats)


def _parts(got: dict, want: dict, spread=None):
    """The tensors where ``got`` leaves tests/test_torch_train.py's
    bounds of ``want`` (or twice ``spread[key]`` where that is larger),
    with their distance over the bound."""
    out = {}
    for key, w in want.items():
        rel = JAX_STATS_REL if ".running_" in key else JAX_PARAM_REL
        bound = max(rel * float(w.abs().max()),
                    2 * spread[key] if spread else 0.0)
        dist = float((got[key] - w).abs().max())
        if dist > bound:
            out[key] = dist / max(bound, 1e-30)
    return out


# -- tests --------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded():
    """The cases, their JAX models and one spawn of 2 ranks running them
    (each case twice)."""
    rng = np.random.default_rng(21)
    cases, jax_side = {}, {}
    for name, seg, n in (("cls", False, 128), ("seg", True, 128),
                         ("padded", False, 97)):
        pos, nrm = _cloud(rng, n)
        label = (rng.integers(0, SEG["num_classes"], n) if seg
                 else np.asarray(2))
        model, variables, inputs = _jax_case(seg, pos, nrm, label)
        state = _to_port(seg, variables["params"], variables["batch_stats"])
        jax_side[name] = (seg, model, variables, inputs)
        for dropout in (0.0, 0.5):
            if name == "padded" and dropout:
                continue
            cases[f"{name}-{dropout}"] = dict(
                seg=seg, dropout=dropout, state=state, pos=pos, normal=nrm,
                label=label)
    ranks = run_ranks(_shard_job, 2, cases, timeout=SPAWN_TIMEOUT)
    return cases, jax_side, ranks


@pytest.mark.parametrize("name", ["cls-0.0", "cls-0.5", "seg-0.0", "seg-0.5",
                                  "padded-0.0"])
def test_ranks_and_calls_bit_equal(sharded, name):
    """Both ranks end with the same bits (losses, accuracies, parameters
    and running statistics), and two calls from the same state too."""
    _, _, ranks = sharded
    first, again = ranks[0][name]
    assert first[:2] == again[:2] and _bit_equal(first[2], again[2])
    other = ranks[1][name][0]
    assert first[:2] == other[:2] and _bit_equal(first[2], other[2])


@pytest.mark.parametrize("name", ["cls", "seg"])
def test_steps_match_jax(sharded, name):
    """2 point-sharded steps on 2 ranks at dropout 0 against JAX's
    single-device step and JAX's ``point_sharded_train_step`` on a
    2-device mesh: each tensor within the bound, or within twice the
    distance between JAX's own two steps where that is larger (the
    segmentation head's ``lin_global`` and ``lin_categorical`` BatchNorm
    biases, whose gradients are rounding noise: the head's per-point
    BatchNorms cancel a shift of the whole cloud's rows)."""
    _, jax_side, ranks = sharded
    got = ranks[0][f"{name}-0.0"][0]
    runs = {label: _jax_steps(*jax_side[name], sharded=flag)
            for label, flag in (("JAX single device", False),
                                ("JAX sharded", True))}
    (_, one), (_, two) = runs.values()
    spread = {k: float((one[k] - two[k]).abs().max()) for k in one}
    for label, (losses, want) in runs.items():
        np.testing.assert_allclose(got[0], losses, rtol=LOSS_RTOL,
                                   err_msg=f"{name} loss vs {label}")
        assert _parts(got[2], want, spread) == {}, f"{name} vs {label}"


@pytest.mark.parametrize("name", ["cls", "seg"])
def test_steps_with_dropout_match_one_process(sharded, name):
    """At dropout 0.5 the 2-rank steps track the port's 1-process
    sharded step on the whole cloud (each rank keeps its points of the
    whole cloud's segmentation masks; the classification head's masks
    are the same on every rank)."""
    cases, _, ranks = sharded
    got = ranks[0][f"{name}-0.5"][0]
    one = _port_steps(cases[f"{name}-0.5"], None)
    np.testing.assert_allclose(got[0], one[0], rtol=LOSS_RTOL)
    assert got[1] == pytest.approx(one[1], abs=1e-6)
    for key, w in one[2].items():
        np.testing.assert_allclose(got[2][key].numpy(), w.numpy(),
                                   atol=DP_ATOL, rtol=DP_RTOL, err_msg=key)


def test_padded_cloud_jax_fault(sharded):
    """Rule 2's padded cloud (97 points on 2 ranks: 49 and 48 valid).
    JAX's sharded step takes ``pmean`` of each rank's masked BatchNorm
    means (flax's ``_compute_stats`` with an ``axis_name``), which is the
    cloud's mean only when every rank keeps as many points: its running
    statistics part from its own single-device step by more than the
    bound. The port completes the masked sums and counts over the ranks
    and stays within the bound of JAX's single-device step."""
    _, jax_side, ranks = sharded
    got = ranks[0]["padded-0.0"][0]
    losses, single = _jax_steps(*jax_side["padded"], sharded=False)
    _, jax_sharded = _jax_steps(*jax_side["padded"], sharded=True)
    parted = _parts(jax_sharded, single)
    assert parted and all(".running_" in k for k in parted), parted
    np.testing.assert_allclose(got[0], losses, rtol=LOSS_RTOL)
    assert _parts(got[2], single) == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sharded_operator_gradients_one_rank(dtype):
    """``ShardedGradDiv`` differentiated in its features on one rank (the
    gathers through ``ops.gather_rows`` and its destination-major
    backward, bf16 cotangents summed in f32 and rounded once): ``grad``,
    ``div``, ``nbr_sum`` (of the f32 widening, as the edge moments call
    it) and ``nbr_gather`` and their input gradients against the same
    functions through the cloud's coefficient-form ``GradDiv`` (the plain
    versions of the applies and of the sum, and their VJPs): within 1e-6
    x max in f32, and within one bf16 rounding of the contraction (1e-2
    x max) in bf16."""
    from deltaconv_tpu_torch.parallel import ShardedGradDiv
    from deltaconv_tpu_torch.parallel import point_sharded_operators

    rng = np.random.default_rng(23)
    pos, nrm = _cloud(rng, 96)
    gd = point_sharded_operators(_t(pos), 10, _t(nrm))
    sgd = ShardedGradDiv(gd)
    x0 = torch.from_numpy(rng.standard_normal((1, 96, 5)).astype(
        np.float32)).to(dtype)
    v0 = torch.from_numpy(rng.standard_normal((1, 96, 2, 5)).astype(
        np.float32)).to(dtype)
    cot = {name: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for name, shape in (("grad", (1, 96, 2, 5)),
                                         ("div", (1, 96, 5)),
                                         ("sum", (1, 96, 5)),
                                         ("gather", (1, 96, 10, 5)))}
    rel = 1e-6 if dtype == torch.float32 else 1e-2
    for name in cot:
        outs, grads = [], []
        for ops in (sgd, gd):
            x = (v0 if name == "div" else x0).clone().requires_grad_()
            y = {"grad": lambda: ops.grad(x), "div": lambda: ops.div(x),
                 "sum": lambda: ops.nbr_sum(x.float()),
                 "gather": lambda: ops.nbr_gather(x)}[name]()
            (y.float() * cot[name]).sum().backward()
            outs.append(y.detach().float())
            grads.append(x.grad.float())
        for label, (a, b) in (("value", outs), ("gradient", grads)):
            torch.testing.assert_close(
                a, b, rtol=0, atol=rel * float(b.abs().max()),
                msg=lambda m: f"{name} {label}: {m}")
