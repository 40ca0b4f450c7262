"""The port's training loop, checkpoints and the engine's checkpoint entry
points, held against the JAX package on the CPU.

- ``adam_steplr``: the lr at every step and 5 Adam steps on the same
  parameters and gradients, within 1e-6 x max of optax's;
- checkpoints: a save/restore round trip bit-exact, optimizer and
  scheduler included (step N+1's lr too), ``params_only``, the four
  release ``.pt`` forms built from the port's own ``state_dict``,
  ``latest_step`` on an empty or missing directory;
- ``fit`` against JAX ``fit`` on the same data, weights and shuffle
  (test_torch_train.py's narrow model, dropout 0, no augmentation, 2
  epochs): parameters within 1e-3 x max and statistics 1e-4 x max (that
  file's tolerances, for the reason it gives), the logged tags, steps and
  eval scalars equal to JAX's ``metrics.jsonl``, the losses to 1e-5;
- a resumed ``fit`` bit-equal to an uninterrupted one, and a no-op
  resume when no checkpoint exists yet;
- ``evaluate_voting`` against JAX's (identity augmentation) and its error
  on a loader that reorders between votes; ``evaluate_segmentation``'s
  mIoU against JAX's;
- a train step at the CLIs' default mix (bf16 dense operators under the
  f32 conv stack) against JAX's ``make_train_step`` at the same mix;
- ``InferenceEngine.from_checkpoint`` and ``warmup`` on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deltaconv_tpu.data as jdata
import deltaconv_tpu.training as jtr
import deltaconv_tpu_torch.data as data
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.models import DeltaNetSegmentation as JaxSegModel
from deltaconv_tpu_torch import (DeltaNetClassification, DeltaNetSegmentation,
                                 InferenceEngine, state_dict_from_flax)
from deltaconv_tpu_torch.serving import load_variables
from deltaconv_tpu_torch.training import (FitConfig, MetricsLogger,
                                          adam_steplr,
                                          cosine_epoch_schedule,
                                          create_train_state,
                                          evaluate_classification,
                                          evaluate_segmentation,
                                          evaluate_voting, fit, latest_step,
                                          make_eval_step, make_train_step,
                                          restore_any, restore_checkpoint,
                                          save_checkpoint, sgd_momentum)
from deltaconv_tpu_torch.training import loop as loop_mod

torch.set_num_threads(1)

B, N, K = 8, 64, 8
WIDTH = dict(conv_channels=(8, 8, 16, 16), embedding_size=32,
             num_neighbors=K)
LR = 0.01


def _t(x):
    return torch.from_numpy(np.array(x))


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _stats(tree, rng):
    """Running statistics away from their init (as test_torch_train)."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _stats(x, rng)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        else:
            out[k] = np.asarray(x)
    return out


class _List:
    def __init__(self, clouds):
        self.clouds = clouds

    def __len__(self):
        return len(self.clouds)

    def __getitem__(self, i):
        return self.clouds[i]


def _ellipsoids(rng, count, n=N, classes=4):
    pos = np.zeros((count, n, 3), np.float32)
    nrm = np.zeros((count, n, 3), np.float32)
    for i in range(count):
        axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        q = d / axes
        pos[i] = d * axes
        nrm[i] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return pos, nrm, rng.integers(0, classes, count)


def _datasets(seed, count):
    """The same clouds as a port dataset and a JAX dataset."""
    pos, nrm, y = _ellipsoids(np.random.default_rng(seed), count)
    return tuple(_List([m.Cloud(pos=pos[i], normal=nrm[i], y=np.int64(y[i]))
                        for i in range(count)]) for m in (data, jdata))


def _jax_init(rng, model, pos, nrm):
    variables = jax.jit(lambda key, p, n_: model.init(key, p, normal=n_))(
        jax.random.PRNGKey(0), pos, nrm)
    return (_to_numpy(variables["params"]),
            _stats(_to_numpy(variables["batch_stats"]), rng))


def _port_model(params, stats, **kw):
    port = DeltaNetClassification(4, dropout=0.0, **WIDTH, **kw)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return port


def _states_equal(a, b):
    for key, value in a.model.state_dict().items():
        assert torch.equal(value, b.model.state_dict()[key]), key
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sorted(sa["state"]) == sorted(sb["state"])
    for i in sa["state"]:
        for name, value in sa["state"][i].items():
            assert torch.equal(torch.as_tensor(value),
                               torch.as_tensor(sb["state"][i][name])), name
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert a.step == b.step


@pytest.fixture(scope="module")
def narrow():
    """JAX-initialised variables of the narrow classifier (running
    statistics randomized) and a batch."""
    rng = np.random.default_rng(3)
    pos, nrm, labels = _ellipsoids(rng, B)
    params, stats = _jax_init(rng, JaxModel(num_classes=4, dropout=0.0,
                                            **WIDTH), pos, nrm)
    batch = {"pos": _t(pos), "normal": _t(nrm), "label": _t(labels).long()}
    return params, stats, batch


# -- optimizer and checkpoints ---------------------------------------------------


def test_adam_steplr_matches_optax():
    """The lr of every step of 10 epochs (3 decays) against the JAX
    schedule's formula in jnp, then 5 Adam steps with a decay inside them
    against optax's updates."""
    probe_p = torch.nn.Parameter(torch.zeros(1))
    probe, probe_sched = adam_steplr(1e-3, 3, 0.5, 4)([probe_p])
    lrs = []
    for _ in range(40):
        lrs.append(probe.param_groups[0]["lr"])
        probe.step()
        probe_sched.step()
    want_lrs = [float(1e-3 * 0.5 ** ((jnp.asarray(s) // 4) // 3))
                for s in range(40)]
    np.testing.assert_allclose(lrs, want_lrs, rtol=1e-6, atol=0)

    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    want = jtr.adam_steplr(1e-3, 2, 0.5, 1)
    param = torch.nn.Parameter(_t(p0))
    opt, sched = adam_steplr(1e-3, 2, 0.5, 1)([param])
    state = want.init(jnp.asarray(p0))
    pj = jnp.asarray(p0)
    for i in range(5):
        g = rng.standard_normal((5, 7)).astype(np.float32) * 10.0 ** -i
        upd, state = want.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        param.grad = _t(g)
        opt.step()
        sched.step()
        w = np.asarray(pj)
        np.testing.assert_allclose(param.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("tx", ["sgd", "adam"])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, narrow, tx):
    params, stats, batch = narrow

    def fresh():
        make = (sgd_momentum(lambda s: 0.05 / (1 + s)) if tx == "sgd"
                else adam_steplr(1e-3, 1, 0.5, 2))
        return create_train_state(_port_model(params, stats), make,
                                  device="cpu")

    state = fresh()
    step = make_train_step(state.model)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        step(state, batch, gen)
    path = save_checkpoint(str(tmp_path), state)
    assert path.endswith("step_3") and latest_step(str(tmp_path)) == 3
    restored = restore_checkpoint(str(tmp_path), fresh())
    _states_equal(state, restored)
    # The scheduler's lambda is held by reference: step N + 1 takes the
    # same lr, and the next step lands on the same bits.
    lrs = [s.optimizer.param_groups[0]["lr"] for s in (state, restored)]
    assert lrs[0] == lrs[1] == (0.05 / 4 if tx == "sgd" else 1e-3 * 0.5)
    for s in (state, restored):
        make_train_step(s.model)(s, batch, torch.Generator().manual_seed(1))
    _states_equal(state, restored)
    # params_only keeps the target's optimizer, scheduler and step.
    target = fresh()
    before = target.optimizer.state_dict()
    restore_checkpoint(str(tmp_path), target, step=3, params_only=True)
    assert target.step == 0 and target.optimizer.state_dict() == before
    loaded = load_variables(str(tmp_path))
    for key, value in target.model.state_dict().items():
        assert torch.equal(value, loaded[key]), key


@pytest.mark.parametrize("form", ["raw", "snapshot", "state_dict", "module"])
def test_restore_any_takes_the_release_forms(tmp_path, narrow, form):
    params, stats, batch = narrow
    source = _port_model(params, stats)
    sd = source.state_dict()
    payload = {"raw": sd,
               "snapshot": {"epoch": 3, "model_state_dict": sd,
                            "optimizer_state_dict": {"lr": 0.1}},
               "state_dict": {"state_dict": sd},
               "module": {"module." + k: v for k, v in sd.items()}}[form]
    path = str(tmp_path / f"{form}.pth")
    torch.save(payload, path)
    model = DeltaNetClassification(4, dropout=0.0, **WIDTH,
                                   generator=torch.Generator().manual_seed(5))
    state = create_train_state(model, sgd_momentum(LR), device="cpu")
    assert restore_any(path, state) is state
    for key, value in sd.items():
        assert torch.equal(value, model.state_dict()[key]), key
    for key, value in load_variables(path).items():
        assert torch.equal(value, sd[key]), key
    engine = InferenceEngine.from_checkpoint(
        DeltaNetClassification(4, dropout=0.0, **WIDTH), path, num_points=N,
        batch_size=B, device="cpu")
    with torch.inference_mode():
        want = source.eval()(batch["pos"], batch["normal"]).numpy()
    got = engine.predict(list(batch["pos"].numpy()),
                         list(batch["normal"].numpy()))
    np.testing.assert_array_equal(got, want)


def test_latest_step_and_restore_on_empty_directories(tmp_path, narrow):
    assert latest_step(str(tmp_path / "missing")) is None
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "step_x").mkdir()
    assert latest_step(str(tmp_path / "empty")) is None
    state = create_train_state(_port_model(*narrow[:2]), sgd_momentum(LR),
                               device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), state)
    with pytest.raises(FileNotFoundError):
        load_variables(str(tmp_path / "missing"))


# -- fit -------------------------------------------------------------------------


def test_fit_matches_jax_fit(tmp_path, narrow):
    """Two epochs of 2 shuffled batches each, one test batch."""
    params, stats, _ = narrow
    config = dict(epochs=2, seed=0, checkpoint_every=10, data_parallel=False,
                  log_every=1)
    train_p, train_j = _datasets(10, 2 * B)
    test_p, test_j = _datasets(11, B)

    model = JaxModel(num_classes=4, dropout=0.0, **WIDTH)
    jstate = jtr.TrainState.create(apply_fn=model.apply, params=params,
                                   batch_stats=stats, tx=jtr.sgd_momentum(LR))
    jlog = jtr.MetricsLogger(str(tmp_path / "jax"))
    jstate = jtr.fit(model, jstate, jdata.BatchLoader(train_j, B,
                                                      shuffle=True, seed=4),
                     jdata.BatchLoader(test_j, B, drop_last=False),
                     jtr.FitConfig(**config), logger=jlog)
    jlog.close()

    port = _port_model(params, stats)
    state = create_train_state(port, sgd_momentum(LR), device="cpu")
    log = MetricsLogger(str(tmp_path / "port"))
    out = fit(port, state, data.BatchLoader(train_p, B, shuffle=True, seed=4),
              data.BatchLoader(test_p, B, drop_last=False),
              FitConfig(**config), logger=log)
    log.close()
    assert out is state and state.step == 4

    want = state_dict_from_flax(_to_numpy(jstate.params),
                                _to_numpy(jstate.batch_stats))
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = w.numpy()
        rel = 1e-4 if ".running_" in key else 1e-3
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=key)

    def records(pkg):
        with open(tmp_path / pkg / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    got, want = records("port"), records("jax")
    assert [(r["tag"], r["step"]) for r in got] == [
        (r["tag"], r["step"]) for r in want]
    assert [r["tag"] for r in got].count("training loss") == 4
    for g, w in zip(got, want):
        if g["tag"] == "training loss":
            np.testing.assert_allclose(g["value"], w["value"], rtol=1e-5)
        else:
            assert g["value"] == w["value"], g["tag"]


def test_fit_resume_matches_uninterrupted(tmp_path, narrow):
    """An interrupted run resumed from its checkpoint (a fresh state, as
    a new process has) lands on the uninterrupted run's bits: model,
    optimizer, scheduler and step. Dropout 0.5 and an augmentation draw
    from the epoch's generator, so the stream is exercised; the schedule
    is a cosine over the run's epochs, as the CLIs'."""
    params, stats, _ = narrow
    train, _ = _datasets(12, 2 * B)
    test, _ = _datasets(13, B)

    def augment(generator, batch):
        out = dict(batch)
        out["pos"] = batch["pos"] * (1.0 + 0.1 * torch.rand(
            (B, 1, 3), generator=generator))
        return out

    def run(epochs, ckpt, resume=False):
        model = DeltaNetClassification(4, dropout=0.5, **WIDTH)
        model.load_state_dict(state_dict_from_flax(params, stats))
        # The cosine depends on the run's epochs (2 batches an epoch):
        # the resumed run must take its own schedule's lr, not the
        # saving run's.
        state = create_train_state(model, sgd_momentum(
            cosine_epoch_schedule(0.05, epochs, 2, eta_min=0.001)),
            device="cpu")
        return fit(model, state, data.BatchLoader(train, B, shuffle=True,
                                                  seed=0),
                   data.BatchLoader(test, B, drop_last=False),
                   FitConfig(epochs=epochs, seed=7, checkpoint_every=2),
                   checkpoint_dir=str(tmp_path / ckpt), augment=augment,
                   resume=resume)

    full = run(3, "full")
    run(1, "part")  # epoch 1's lr is the base lr of any such cosine
    resumed = run(3, "part", resume=True)
    assert resumed.step == full.step == 6
    _states_equal(full, resumed)
    assert latest_step(str(tmp_path / "part")) == 3
    # resume with no checkpoint yet is a plain start.
    fresh = run(1, "empty", resume=True)
    assert fresh.step == 2


def test_data_parallel_with_several_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match=r"\[11\]"):
        loop_mod._check_data_parallel(FitConfig(),
                                      torch.device("cuda", 0))
    loop_mod._check_data_parallel(FitConfig(data_parallel=False),
                                  torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    loop_mod._check_data_parallel(FitConfig(), torch.device("cuda", 0))


# -- evaluations -----------------------------------------------------------------


def test_evaluate_voting_matches_jax(narrow):
    params, stats, _ = narrow
    test_p, test_j = _datasets(14, 12)
    model = JaxModel(num_classes=4, dropout=0.0, **WIDTH)
    jstate = jtr.TrainState.create(apply_fn=model.apply, params=params,
                                   batch_stats=stats, tx=jtr.sgd_momentum(LR))
    want = jtr.evaluate_voting(model, jstate, jdata.BatchLoader(
        test_j, 4, drop_last=False), lambda key, b: b, num_votes=3)
    port = _port_model(params, stats)
    loader = data.BatchLoader(test_p, 4, drop_last=False)
    got = evaluate_voting(port, None, loader, lambda g, b: b, num_votes=3)
    assert got == want
    assert got[0] == evaluate_classification(port, None, loader)[
        "test accuracy"]
    shuffled = data.BatchLoader(test_p, 4, shuffle=True, seed=0)
    with pytest.raises(ValueError, match="different sample order"):
        evaluate_voting(port, None, shuffled, None, num_votes=2)


def test_evaluate_segmentation_miou_matches_jax():
    rng = np.random.default_rng(21)
    width = dict(conv_channels=(8, 16, 16), embedding_size=32,
                 num_neighbors=K, categorical_vector=True)
    cats = [3, 11, 3, 0, 15, 11]
    pos, nrm, _ = _ellipsoids(rng, len(cats))
    start = [8, 36, 8, 0, 47, 36]
    count = [4, 2, 4, 4, 3, 2]
    clouds = {m: _List([m.Cloud(
        pos=pos[i], normal=nrm[i],
        y=(start[i] + np.arange(N) % count[i]).astype(np.int64),
        category=np.eye(16, dtype=np.float32)[c])
        for i, c in enumerate(cats)]) for m in (data, jdata)}
    model = JaxSegModel(num_classes=50, dropout=0.0, **width)
    cat = np.eye(16, dtype=np.float32)[cats[:2]]
    variables = jax.jit(lambda key, p, n_, c: model.init(
        key, p, normal=n_, category=c))(jax.random.PRNGKey(0), pos[:2],
                                        nrm[:2], cat)
    params = _to_numpy(variables["params"])
    stats = _stats(_to_numpy(variables["batch_stats"]), rng)
    jstate = jtr.TrainState.create(apply_fn=model.apply, params=params,
                                   batch_stats=stats, tx=jtr.sgd_momentum(LR))
    want = jtr.evaluate_segmentation(model, jstate, jdata.BatchLoader(
        clouds[jdata], 4, drop_last=False))
    port = DeltaNetSegmentation(50, dropout=0.0, **width)
    port.load_state_dict(state_dict_from_flax(params, stats,
                                              head="segmentation"))
    got = evaluate_segmentation(port, None, data.BatchLoader(
        clouds[data], 4, drop_last=False))
    assert sorted(got) == ["test accuracy", "test mIoU"]
    assert got == want


# -- the CLIs' precision mix -------------------------------------------------------


def test_train_step_at_the_cli_mix_matches_jax(narrow):
    """bf16 dense operators under the f32 conv stack (``--operator_dtype
    bfloat16``, no ``compute_dtype``), one step of each package. Both
    round the operators and the features they apply to to bf16 and sum
    in f32, but an f32 difference of one ulp upstream flips a bf16
    rounding, so the gradients are not elementwise close (up to 3e-2 of
    a tensor's update in conv0). What is held: the loss to 1e-5; each
    parameter's update (after - before) within a quarter of what the
    bf16 operators themselves move it (JAX's mixed step against JAX's f32
    step; measured at most 0.10 of it, 0.07 to 0.33 of the update being
    that move); the running statistics within 1e-3 x max."""
    params, stats, batch = narrow
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def jax_step(operator_dtype):
        model = JaxModel(num_classes=4, dropout=0.0,
                         operator_dtype=operator_dtype, **WIDTH)
        jstate = jtr.TrainState.create(apply_fn=model.apply, params=params,
                                       batch_stats=stats,
                                       tx=jtr.sgd_momentum(LR))
        jstate, jm = jtr.make_train_step(model)(jstate, jbatch,
                                                jax.random.PRNGKey(0))
        return state_dict_from_flax(_to_numpy(jstate.params),
                                    _to_numpy(jstate.batch_stats)), jm

    want, jm = jax_step("bfloat16")
    want_f32, _ = jax_step(None)
    port = _port_model(params, stats, operator_dtype="bfloat16")
    state = create_train_state(port, sgd_momentum(LR), device="cpu")
    tm = make_train_step(port)(state, batch, torch.Generator())
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    init = state_dict_from_flax(params, stats)
    got = port.state_dict()
    for key, w in want.items():
        w = w.numpy()
        if ".running_" in key:
            np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                       atol=1e-3 * float(np.abs(w).max()),
                                       err_msg=key)
            continue
        step = w - init[key].numpy()
        mixed = np.linalg.norm(step - (want_f32[key].numpy()
                                       - init[key].numpy()))
        dev = np.linalg.norm(got[key].numpy() - w)
        assert dev <= 0.25 * mixed + 1e-7 * np.linalg.norm(step), (
            key, dev, mixed)


# -- serving from a checkpoint -------------------------------------------------------


def test_engine_from_checkpoint_and_warmup(tmp_path, narrow):
    params, stats, batch = narrow
    state = create_train_state(_port_model(params, stats), sgd_momentum(LR),
                               device="cpu")
    make_train_step(state.model)(state, batch, torch.Generator())
    save_checkpoint(str(tmp_path), state, step=1)
    caller = DeltaNetClassification(4, dropout=0.0, **WIDTH)
    before = {k: v.clone() for k, v in caller.state_dict().items()}
    for path in (str(tmp_path), str(tmp_path / "step_1")):
        engine = InferenceEngine.from_checkpoint(caller, path, num_points=N,
                                                 batch_size=4, device="cpu")
        engine.warmup()
        engine.warmup(masked=True, has_normal=False)
        clouds = list(batch["pos"].numpy())
        normals = list(batch["normal"].numpy())
        want = make_eval_step(state.model)(state, batch).numpy()
        np.testing.assert_array_equal(engine.predict(clouds, normals), want)
    for key, value in caller.state_dict().items():  # the caller's model
        assert torch.equal(value, before[key]), key
    seg = DeltaNetSegmentation(50, conv_channels=(8, 8), embedding_size=16,
                               num_neighbors=K, categorical_vector=True)
    seg_state = create_train_state(seg, sgd_momentum(LR), device="cpu")
    save_checkpoint(str(tmp_path / "seg"), seg_state)
    engine = InferenceEngine.from_checkpoint(
        DeltaNetSegmentation(50, conv_channels=(8, 8), embedding_size=16,
                             num_neighbors=K, categorical_vector=True),
        str(tmp_path / "seg"), num_points=N, batch_size=2, device="cpu")
    engine.warmup(masked=False, has_category=True)
    with pytest.raises(RuntimeError):
        InferenceEngine.from_checkpoint(
            DeltaNetClassification(5, **WIDTH), str(tmp_path), num_points=N,
            device="cpu")
