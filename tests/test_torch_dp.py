"""Data parallelism in deltaconv_tpu_torch (``make_train_step(...,
group=)``, ``parallel.shard_train_step``, ``training.fit`` with
``data_parallel=True``) against the JAX package on the CPU.

The port's ranks are 2 ``gloo`` processes spawned by
``parallel.launch.run_ranks``; every case a rank runs comes in one job,
so a test spawns once. This module imports JAX inside its test
functions, so the spawned ranks load torch alone. Weights cross from
the JAX models with ``state_dict_from_flax``.

Tolerances, and why:

- the collectives' gradients in f64 against the one-process formula:
  1e-12 (sums of a few f64 values in another order);
- BatchNorm over 2 ranks against the concatenated rows: moments and
  gradients within 1e-6 x max (f32 sums in another order); the two
  ranks' moments bit-equal;
- the port's 2-rank steps against JAX's steps at dropout 0 (JAX's
  single-device step, and JAX's ``shard_train_step`` on
  ``Mesh(jax.devices()[:2])``): the bounds of tests/test_torch_train.py,
  loss rtol 1e-5, every parameter within 1e-3 x its tensor's max, every
  running statistic within 1e-4 x max; or, where JAX's own two steps
  part by more, within twice their distance. That happens to the
  BatchNorm bias of ``lin_embedding`` (1.1e-3 x max) and of
  ``lin_global`` (1.1 x max): the heads' BatchNorms cancel a shift of
  every cloud's pooled row, so these biases' gradients are rounding
  noise, a few 1e-8 either way;
- the port's 2-rank steps against its 1-process steps at dropout 0.5:
  JAX's own data-parallel bounds (tests/training/test_parallel.py), loss
  rtol 1e-5, parameters and running statistics atol 1e-5 + rtol 1e-4;
- the two ranks against each other: bit-equal.
"""

import os

import numpy as np
import pytest
import torch

from deltaconv_tpu_torch import (DeltaNetClassification, DeltaNetSegmentation,
                                 state_dict_from_flax)
from deltaconv_tpu_torch.nn.nonlin import BatchNorm, batch_moments
from deltaconv_tpu_torch.parallel import (all_gather, pmax, pmean, psum,
                                          shard_batch, shard_train_step)
from deltaconv_tpu_torch.parallel.launch import run_ranks
from deltaconv_tpu_torch.training import (FitConfig, create_train_state, fit,
                                          make_train_step, sgd_momentum)
from deltaconv_tpu_torch.training import loop as loop_mod

torch.set_num_threads(1)

B, N, K, CLASSES = 8, 96, 10, 4  # tests/training/test_parallel.py
LR = 0.01
STEPS = 2
LOSS_RTOL = 1e-5
JAX_PARAM_REL, JAX_STATS_REL = 1e-3, 1e-4  # tests/test_torch_train.py
DP_ATOL, DP_RTOL = 1e-5, 1e-4  # tests/training/test_parallel.py
SPAWN_TIMEOUT = 240
CLS = dict(conv_channels=(8, 8), num_neighbors=K)
SEG = dict(conv_channels=(8, 8), mlp_depth=1, embedding_size=16,
           categorical_vector=True, num_neighbors=K)
SEG_CLASSES = 6
RAGGED = [N, 70, N, 50, 81, N, 64, N]  # points per cloud of the ragged batch


def _t(x):
    return torch.from_numpy(np.array(x))


def _within_jax_bounds(got: dict, want: dict, spread: dict, label: str):
    """Each tensor within tests/test_torch_train.py's bound of JAX's, or
    within twice ``spread[key]``, the distance between JAX's own
    single-device and 2-device steps, where that is larger."""
    assert sorted(got) == sorted(want), label
    for key, w in want.items():
        w = w.numpy()
        rel = JAX_STATS_REL if ".running_" in key else JAX_PARAM_REL
        atol = max(rel * float(np.abs(w).max()), 2 * spread[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=atol,
                                   err_msg=f"{label}: {key}")


def _within_dp_bounds(got: dict, want: dict, label: str):
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(),
                                   atol=DP_ATOL, rtol=DP_RTOL,
                                   err_msg=f"{label}: {key}")


def _bit_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


# -- the rank jobs (module level: the spawned ranks import them) --------------


def _collective_cases(group):
    """Each collective's value and f64 gradient on this rank's rows: row
    block ``r`` of ``x`` (4 x 3 a rank), and the cotangent ``ct``
    weighting the result on every rank."""
    rank = torch.distributed.get_rank(group)
    gen = torch.Generator().manual_seed(0)
    x_all = torch.randn(8, 3, generator=gen, dtype=torch.float64)
    x_all[5] = x_all[1]  # a tie across ranks for pmax
    ct = torch.randn(8, 3, generator=gen, dtype=torch.float64)
    out = {}
    for name, fn in (("all_gather", lambda x: all_gather(x, group)),
                     ("psum", lambda x: psum(x, group)),
                     ("pmean", lambda x: pmean(x, group)),
                     ("pmax", lambda x: pmax(x, group))):
        x = x_all[rank * 4:(rank + 1) * 4].clone().requires_grad_()
        y = fn(x)
        (y * ct[:y.shape[0]]).sum().backward()
        out[name] = (y.detach(), x.grad)
    return out


def _bn_case(group, x, mask):
    """A train-mode BatchNorm over this rank's rows (``x [4, 5, C]``
    row-split over the 2 ranks) and its input gradient."""
    rank = torch.distributed.get_rank(group)
    rows = x.shape[0] // 2
    xl = x[rank * rows:(rank + 1) * rows].clone().requires_grad_()
    ml = None if mask is None else mask[rank * rows:(rank + 1) * rows]
    bn = BatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(-1.5, 1.5, x.shape[-1]))
    bn.train()
    y = bn(xl, ml, group)
    start = rank * y.numel()  # the cotangent of the concatenated rows
    (y * torch.arange(start, start + y.numel()).reshape(y.shape).float(
    ).sin()).sum().backward()
    return {"moments": batch_moments(xl.detach(), ml, group=group),
            "y": y.detach(), "grad": xl.grad,
            "running": (bn.running_mean, bn.running_var)}


def _model(case):
    if case["seg"]:
        model = DeltaNetSegmentation(SEG_CLASSES, dropout=case["dropout"],
                                     **SEG)
    else:
        model = DeltaNetClassification(CLASSES, dropout=case["dropout"],
                                       **CLS)
    model.load_state_dict(case["state"], strict=True)
    return model


def _steps(case, group):
    """``STEPS`` data-parallel steps (``shard_train_step`` on the global
    batch; ``group=None``: the one-process step): losses, accuracies and
    the final ``state_dict``."""
    model = _model(case)
    state = create_train_state(model, sgd_momentum(LR), device="cpu")
    step = shard_train_step(make_train_step(
        model, smoothing=0.2, per_point=case["seg"], group=group))
    batch = {k: _t(v) for k, v in case["batch"].items()}
    gen = torch.Generator().manual_seed(5)
    metrics = [step(state, batch, gen) for _ in range(STEPS)]
    return ([float(m["loss"]) for m in metrics],
            [float(m["accuracy"]) for m in metrics],
            {k: v.clone() for k, v in model.state_dict().items()})


def _fit(case, group):
    """``fit`` for 2 epochs on a list of global batches (one batch of 8
    clouds an epoch: longer runs on these clouds move near-tied
    neighbour-max winners, and the f32 sums' order then shows), with
    checkpoints every epoch; then a run of 1 epoch resumed to 2. Returns
    both final ``state_dict``s and the checkpoint writes this rank
    made."""
    writes = []
    save = loop_mod.save_checkpoint

    def counted(ckpt_dir, state, step=None):
        writes.append(step)
        return save(ckpt_dir, state, step)

    loop_mod.save_checkpoint = counted
    try:
        out = []
        for name, epochs, resume in (("full", 2, False), ("part", 1, False),
                                     ("part", 2, True)):
            model = _model(case)
            state = create_train_state(model, sgd_momentum(LR),
                                       device="cpu")
            config = FitConfig(epochs=epochs, seed=3, checkpoint_every=1,
                               data_parallel=group is not None, log_every=1)
            batches = [{k: v[i] for k, v in case["batch"].items()}
                       for i in range(len(case["batch"]["pos"]))]
            fit(model, state, batches, batches[:1], config,
                checkpoint_dir=os.path.join(case["dir"], name),
                resume=resume, augment=_augment)
            out.append({k: v.clone() for k, v in model.state_dict().items()})
    finally:
        loop_mod.save_checkpoint = save
    return {"full": out[0], "resumed": out[2], "writes": writes}


def _augment(generator, batch):
    """A per-cloud scale drawn from the epoch's generator."""
    pos = batch["pos"]
    scale = torch.rand(pos.shape[0], 1, 1, generator=generator,
                       device=pos.device) * 0.4 + 0.8
    return dict(batch, pos=pos * scale)


def _cli(argv):
    """``train_modelnet.main(argv)``: the final ``state_dict`` and what
    this rank printed."""
    import contextlib
    import io

    from deltaconv_tpu_torch.experiments import train_modelnet

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, _ = train_modelnet.main(argv)
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            out.getvalue())


def _dp_job(group, job):
    """A spawned rank: every case of ``job``."""
    out = {}
    for name, case in job.items():
        if name == "cli":
            out[name] = _cli(case)
        elif name == "collectives":
            out[name] = _collective_cases(group)
        elif name.startswith("bn"):
            out[name] = _bn_case(group, case["x"], case["mask"])
        elif name == "fit":
            out[name] = _fit(case, group)
        else:
            out[name] = _steps(case, group)
    return out


# -- inputs -------------------------------------------------------------------


def _jax_models():
    import jax
    import jax.numpy as jnp

    from deltaconv_tpu.data.synthetic import (synthetic_classification_batch,
                                              synthetic_segmentation_batch)
    from deltaconv_tpu.models import DeltaNetClassification as JaxCls
    from deltaconv_tpu.models import DeltaNetSegmentation as JaxSeg

    cls_batch = synthetic_classification_batch(7, B, N, CLASSES)
    seg_batch = synthetic_segmentation_batch(11, B, N, num_parts=SEG_CLASSES,
                                             num_categories=16)
    seg_batch["point_mask"] = (np.arange(N)[None, :]
                               < np.asarray(RAGGED)[:, None])
    cls = JaxCls(num_classes=CLASSES, dropout=0.0, **CLS)
    seg = JaxSeg(num_classes=SEG_CLASSES, dropout=0.0, **SEG)
    cls_vars = jax.jit(lambda k, p, n: cls.init(k, p, normal=n))(
        jax.random.PRNGKey(0), cls_batch["pos"], cls_batch["normal"])
    seg_vars = jax.jit(lambda k, p, n, c: seg.init(k, p, normal=n,
                                                   category=c))(
        jax.random.PRNGKey(1), seg_batch["pos"], seg_batch["normal"],
        seg_batch["category"])
    del jnp
    return (cls, cls_vars, cls_batch), (seg, seg_vars, seg_batch)


def _jax_steps(model, variables, batch, per_point, mesh=None):
    """JAX's ``STEPS`` steps (single device, or ``shard_train_step`` on
    ``mesh``): losses and the port's ``state_dict`` of the result."""
    import jax
    import jax.numpy as jnp

    from deltaconv_tpu.parallel import shard_train_step as jax_shard
    from deltaconv_tpu.training import TrainState, make_train_step as jstep
    from deltaconv_tpu.training import sgd_momentum as jax_sgd

    state = TrainState.create(apply_fn=model.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=jax_sgd(LR))
    step = jstep(model, smoothing=0.2, per_point=per_point)
    if mesh is not None:
        step = jax_shard(step, mesh)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for i in range(STEPS):
        state, metrics = step(state, jbatch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
    head = "segmentation" if per_point else "classification"
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     dict(state.params)),
                              jax.tree_util.tree_map(
                                  np.asarray, dict(state.batch_stats)), head)
    return losses, sd


# -- tests --------------------------------------------------------------------


def test_indivisible_batch_raises(monkeypatch):
    """``shard_batch`` refuses a batch whose size is not a multiple of
    the group's ranks (rank 1 of 2, faked: no group is needed to
    refuse); a divisible one splits into equal blocks in rank order."""
    import deltaconv_tpu_torch.parallel.mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "rank_and_size", lambda group: (1, 2))
    batch = {"pos": torch.zeros(5, 4, 3), "label": torch.arange(5)}
    with pytest.raises(ValueError, match="not a multiple"):
        shard_batch(batch, object())
    got = shard_batch({"label": torch.arange(6)}, object())
    assert got["label"].tolist() == [3, 4, 5]


def _modelnet_argv(tmp):
    """``train_modelnet`` arguments on a ModelNet tree of boxes (8 train
    and 4 test meshes, processed here once so that the ranks only read
    it), 2 epochs of 1 batch of 8 clouds, f32, on the CPU."""
    from test_torch_cli import _write_box

    from deltaconv_tpu_torch.experiments import train_modelnet

    root = tmp / "modelnet"
    rng = np.random.default_rng(1)
    for cat in ("bed", "chair"):
        for split, count in (("train", 4), ("test", 2)):
            os.makedirs(root / "raw" / cat / split, exist_ok=True)
            for i in range(count):
                _write_box(root / "raw" / cat / split / f"{cat}_{i:04d}.off",
                           rng)
    open(root / "raw" / ".extracted", "w").close()
    argv = ["--epochs", "2", "--num_points", "32", "--k", "8",
            "--batch_size", "8", "--sampling_margin", "2",
            "--operator_dtype", "float32", "--device", "cpu",
            "--data_root", str(root)]
    args = train_modelnet.build_parser().parse_args(argv)
    train_modelnet.build_datasets(_common_args(args))
    return argv


def _common_args(args):
    from deltaconv_tpu_torch.experiments.common import finish_args
    return finish_args(args, "modelnet40", "ModelNet40")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of 2 gloo ranks runs every case of this module:

    - the collectives in f64 (``all_gather``, ``psum``, ``pmean``,
      ``pmax`` with a tie across the ranks);
    - a train-mode BatchNorm over the 2 ranks with uneven masked counts
      (9 of 10 rows on rank 0, 3 of 10 on rank 1), and with no mask;
    - 2 data-parallel steps of both models (classification at JAX
      ``test_parallel.py``'s config; segmentation on a ragged batch,
      50 to 96 points a cloud) at dropout 0 and 0.5;
    - ``fit`` of 2 epochs with checkpoints, and a run of 1 epoch resumed
      to 2.

    Returns ``(ranks' results, the inputs)``."""
    import jax

    tmp = tmp_path_factory.mktemp("dp")
    (cls, cls_vars, cls_batch), (seg, seg_vars, seg_batch) = _jax_models()
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))  # noqa
    states = {
        False: state_dict_from_flax(to_np(cls_vars["params"]),
                                    to_np(cls_vars["batch_stats"])),
        True: state_dict_from_flax(to_np(seg_vars["params"]),
                                   to_np(seg_vars["batch_stats"]),
                                   "segmentation")}
    batches = {False: cls_batch, True: seg_batch}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 5, 6)).astype(np.float32) * 2 + 0.5
    mask = np.zeros((4, 5), bool)
    mask.reshape(-1)[:9] = True  # rank 0's rows: 9 valid
    mask[2:].reshape(-1)[[0, 4, 7]] = True  # rank 1's: 3 valid
    job = {"collectives": None,
           "bn-masked": dict(x=_t(x), mask=_t(mask)),
           "bn-all": dict(x=_t(x), mask=None)}
    for seg_case in (False, True):
        for dropout in (0.0, 0.5):
            job[f"{'seg' if seg_case else 'cls'}-{dropout}"] = dict(
                seg=seg_case, dropout=dropout, state=states[seg_case],
                batch=batches[seg_case])
    fit_batch = {k: v[None] for k, v in cls_batch.items()}  # one an epoch
    job["fit"] = dict(seg=False, dropout=0.5, state=states[False],
                      batch=fit_batch, dir=str(tmp / "ranks"))
    job["cli"] = _modelnet_argv(tmp) + ["--logdir", str(tmp / "cli-ranks")]
    ranks = run_ranks(_dp_job, 2, job, timeout=SPAWN_TIMEOUT)
    inputs = dict(job=job, x=x, mask=mask, states=states, batches=batches,
                  models={False: (cls, cls_vars), True: (seg, seg_vars)},
                  tmp=tmp)
    return ranks, inputs


def test_collectives_gradients(two_ranks):
    """Each collective's value and f64 gradient on 2 ranks against the
    one-process formulas: ``all_gather`` the concatenation, its backward
    this rank's rows of the sum of both ranks' cotangents; ``psum`` the
    sum, its backward the summed cotangent; ``pmean``; ``pmax``, whose
    gradient splits in halves at a tie across the ranks."""
    ranks, _ = two_ranks
    gen = torch.Generator().manual_seed(0)
    x_all = torch.randn(8, 3, generator=gen, dtype=torch.float64)
    x_all[5] = x_all[1]
    ct = torch.randn(8, 3, generator=gen, dtype=torch.float64)
    blocks = torch.stack([x_all[:4], x_all[4:]])
    mx = blocks.amax(dim=0)
    share = (blocks == mx).double()
    share = share / share.sum(dim=0)
    assert (share[0] == 0.5).any()  # the tie
    for rank, res in enumerate(ranks):
        rows = slice(rank * 4, (rank + 1) * 4)
        want = {"all_gather": (x_all, 2 * ct[rows]),
                "psum": (x_all[:4] + x_all[4:], 2 * ct[:4]),
                "pmean": ((x_all[:4] + x_all[4:]) / 2, ct[:4]),
                "pmax": (mx, 2 * ct[:4] * share[rank])}
        for name, (value, grad) in want.items():
            got_value, got_grad = res["collectives"][name]
            torch.testing.assert_close(got_value, value, rtol=0, atol=1e-12)
            torch.testing.assert_close(got_grad, grad, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["bn-masked", "bn-all"])
def test_batchnorm_over_ranks(two_ranks, name):
    """A train-mode BatchNorm over 2 ranks (uneven masked counts, or no
    mask) against one BatchNorm on the concatenated rows: moments,
    output, input gradient and running statistics within 1e-6 x max; the
    ranks' moments bit-equal."""
    ranks, inputs = two_ranks
    m = None if name == "bn-all" else _t(inputs["mask"])
    xt = _t(inputs["x"]).requires_grad_()
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(-1.5, 1.5, 6))
    bn.train()
    y = bn(xt, m)
    (y * torch.arange(y.numel()).reshape(y.shape).float().sin()).sum(
    ).backward()
    moments = batch_moments(_t(inputs["x"]), m)
    for rank, res in enumerate(ranks):
        rows = slice(rank * 2, (rank + 1) * 2)
        pairs = [*zip(res[name]["moments"], moments),
                 (res[name]["y"], y.detach()[rows]),
                 (res[name]["grad"], xt.grad[rows]),
                 *zip(res[name]["running"],
                      (bn.running_mean, bn.running_var))]
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-6 * float(b.abs().max()))
    for a, b in zip(ranks[0][name]["moments"], ranks[1][name]["moments"]):
        assert torch.equal(a, b), f"{name}: the ranks' moments"


@pytest.mark.parametrize("seg_case", [False, True], ids=["cls", "seg"])
def test_steps_match_jax(two_ranks, seg_case):
    """2 data-parallel steps on 2 ranks at dropout 0 against JAX's
    single-device step and JAX's ``shard_train_step`` on a 2-device mesh
    (bounds in the module docstring); the ranks bit-equal."""
    import jax
    from jax.sharding import Mesh

    ranks, inputs = two_ranks
    kind = "seg" if seg_case else "cls"
    name = f"{kind}-0.0"
    assert _bit_equal(ranks[0][name][2], ranks[1][name][2]), name
    assert ranks[0][name][:2] == ranks[1][name][:2], name
    model, variables = inputs["models"][seg_case]
    batch = inputs["batches"][seg_case]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    jax_runs = {label: _jax_steps(model, variables, batch, seg_case, m)
                for label, m in (("JAX single device", None),
                                 ("JAX 2-device", mesh))}
    (_, one_dev), (_, two_dev) = jax_runs.values()
    spread = {k: float((one_dev[k] - two_dev[k]).abs().max())
              for k in one_dev}
    for label, (losses, want) in jax_runs.items():
        np.testing.assert_allclose(ranks[0][name][0], losses,
                                   rtol=LOSS_RTOL,
                                   err_msg=f"{kind} loss vs {label}")
        _within_jax_bounds(ranks[0][name][2], want, spread,
                           f"{kind}, 2 ranks vs {label}")


@pytest.mark.parametrize("seg_case", [False, True], ids=["cls", "seg"])
def test_steps_with_dropout_match_one_process(two_ranks, seg_case):
    """At dropout 0.5 the 2-rank steps track the port's one-process step
    on the whole batch (each rank keeps its rows of the whole batch's
    masks) within JAX's data-parallel bounds; the ranks bit-equal."""
    ranks, inputs = two_ranks
    kind = "seg" if seg_case else "cls"
    name = f"{kind}-0.5"
    assert _bit_equal(ranks[0][name][2], ranks[1][name][2]), name
    assert ranks[0][name][:2] == ranks[1][name][:2], name
    one = _steps(inputs["job"][name], None)
    np.testing.assert_allclose(ranks[0][name][0], one[0], rtol=LOSS_RTOL,
                               err_msg=f"{kind} dropout 0.5 loss")
    assert ranks[0][name][1] == pytest.approx(one[1], abs=1e-6)
    _within_dp_bounds(ranks[0][name][2], one[2],
                      f"{kind} dropout 0.5, 2 ranks vs 1")


def test_fit_two_ranks(two_ranks):
    """``fit`` with ``data_parallel=True`` on 2 ranks: 2 epochs within
    JAX's data-parallel bounds of the one-process ``fit``; a run
    interrupted after epoch 1 and resumed (every rank restores) bit-equal
    to the uninterrupted one; the ranks bit-equal; rank 0 alone writes
    the checkpoints, the same ones as the one-process run."""
    ranks, inputs = two_ranks
    got = ranks[0]["fit"]
    one = _fit(dict(inputs["job"]["fit"], dir=str(inputs["tmp"] / "one")),
               None)
    _within_dp_bounds(got["full"], one["full"], "fit, 2 ranks vs 1")
    assert _bit_equal(got["full"], got["resumed"])
    assert _bit_equal(ranks[0]["fit"]["full"], ranks[1]["fit"]["full"])
    assert got["writes"] == one["writes"] == [1, 2, 2, 1, 1, 2, 2]
    assert ranks[1]["fit"]["writes"] == []


def test_dryrun_multichip_two_ranks():
    """``parallel.dryrun.dryrun_multichip(2)`` on 2 gloo CPU ranks: every
    multi-rank path at tiny shapes passes its checks, and the summary
    names the largest parameter difference from the one-process step and
    its cause."""
    from deltaconv_tpu_torch.parallel.dryrun import dryrun_multichip

    summary = dryrun_multichip(2)
    assert summary.startswith("dryrun_multichip(2) on 2 CPU ranks (gloo): ok")
    assert "largest parameter difference" in summary
    assert "sums add in another order" in summary
    assert "every rank's parameters bit-equal" in summary


def test_train_modelnet_cli_two_ranks(two_ranks):
    """``train_modelnet.main`` on 2 gloo ranks (data parallelism is its
    default; the group is initialised, as ``torchrun`` would): 2 epochs
    within JAX's data-parallel bounds of the one-process run
    (``--no_data_parallel``); the ranks bit-equal; rank 0 alone makes
    the run directory and logs, both print the test accuracy."""
    ranks, inputs = two_ranks
    argv = inputs["job"]["cli"][:-2]
    one, _ = _cli(argv + ["--no_data_parallel", "--logdir",
                          str(inputs["tmp"] / "cli-one")])
    (got, printed), (other, printed1) = ranks[0]["cli"], ranks[1]["cli"]
    _within_dp_bounds(got, one, "train_modelnet, 2 ranks vs 1")
    assert _bit_equal(got, other)
    assert "Logging to" in printed and "Logging to" not in printed1
    assert "Test accuracy" in printed and "Test accuracy" in printed1
    runs = os.listdir(inputs["tmp"] / "cli-ranks" / "runs" / "modelnet40")
    assert len(runs) == 1
