"""The port's experiment CLIs against the JAX package's
(``experiments/train_scanobjectnn.py``, ``train_modelnet.py``,
``train_shrec.py``, ``train_shapenet.py``, ``test_shapenet.py`` and
``train_shapeseg.py``, loaded as ``tests/experiments/test_cli_defaults.py``
loads them):

- every parser default and the ``RECIPE`` equal (the port adds only
  ``--device``), and the default dataset and log folders the same;
- ``augment`` applying the JAX CLI's own draws (its key split) equal to
  the JAX CLI's ``augment`` on the same batch;
- one in-process ``main([..., "--device", "cpu"])`` of each on a
  fixture it writes (a ScanObjectNN h5, a ModelNet tree of OFF meshes,
  and as ``tests/test_torch_io.py`` writes them a SHREC zip, a ShapeNet
  tree and a ShapeSeg archive) at the JAX smoke tests' sizes
  (``tests/training/test_cli_smoke.py``'s ``_FAST``), which prints the
  test accuracy; then, for the classifiers and ShapeNet, ``--resume``
  into the same run and an evaluate-only ``--checkpoint`` run of what it
  wrote; ``test_shapenet`` votes on ``train_shapenet``'s checkpoint;
  ShapeSeg's early stopping saves the state of its best validation
  epoch.
"""

import glob
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu_torch.experiments import common
from deltaconv_tpu_torch.experiments import test_shapenet as vote
from deltaconv_tpu_torch.experiments import train_modelnet as modelnet
from deltaconv_tpu_torch.experiments import train_scanobjectnn as sonn
from deltaconv_tpu_torch.experiments import train_shapenet as shapenet
from deltaconv_tpu_torch.experiments import train_shapeseg as shapeseg
from deltaconv_tpu_torch.experiments import train_shrec as shrec

torch.set_num_threads(1)

_EXPERIMENTS = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "experiments"))

_FAST = ["--epochs", "1", "--num_points", "32", "--k", "8",
         "--batch_size", "4", "--sampling_margin", "2",
         "--operator_dtype", "float32", "--no_data_parallel",
         "--device", "cpu"]

PORT = {"train_scanobjectnn": sonn, "train_modelnet": modelnet,
        "train_shrec": shrec, "train_shapenet": shapenet,
        "test_shapenet": vote, "train_shapeseg": shapeseg}
NAMES = {"train_scanobjectnn": ("scanobjectnn", "ScanObjectNN"),
         "train_modelnet": ("modelnet40", "ModelNet40"),
         "train_shrec": ("shrec", "SHREC"),
         "train_shapenet": ("shapenet", "ShapeNet"),
         "test_shapenet": ("shapenet_test", "ShapeNet"),
         "train_shapeseg": ("shapeseg", "ShapeSeg")}


def _load(script):
    if _EXPERIMENTS not in sys.path:
        sys.path.insert(0, _EXPERIMENTS)
    return importlib.import_module(script)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("script", sorted(PORT))
def test_parser_defaults_and_recipe_equal_jax(script):
    jax_cli, port = _load(script), PORT[script]
    want = vars(jax_cli.build_parser().parse_args([]))
    got = vars(port.build_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    if hasattr(jax_cli, "RECIPE"):
        assert port.RECIPE == jax_cli.RECIPE
    name = NAMES[script]
    want = _load("common").finish_args(jax_cli.build_parser().parse_args([]),
                                       *name)
    got = common.finish_args(port.build_parser().parse_args([]), *name)
    assert got.data_root == want.data_root
    assert os.path.realpath(got.logdir) == os.path.realpath(want.logdir)


def _batch(rng, normals):
    pos = rng.standard_normal((3, 16, 3)).astype(np.float32)
    batch = {"pos": pos, "label": rng.integers(0, 15, 3)}
    if normals:
        nrm = rng.standard_normal((3, 16, 3)).astype(np.float32)
        batch["normal"] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    return batch


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("normals", [False, True])
def test_scanobjectnn_augment_applies_jax_draws(normals):
    batch = _batch(np.random.default_rng(0), normals)
    key = jax.random.PRNGKey(5)
    want = _load("train_scanobjectnn").augment(
        key, {k: jnp.asarray(v) for k, v in batch.items()})
    k0, k1, k2, k3 = jax.random.split(key, 4)
    draws = (jax.random.uniform(k0, (3,), minval=-360.0, maxval=360.0)
             * (jnp.pi / 180.0),
             jax.random.uniform(k1, (3, 16, 3), minval=-0.01, maxval=0.01),
             jax.random.uniform(k2, (3, 1, 3), minval=0.8, maxval=1.25),
             jax.random.uniform(k3, (3, 1, 3), minval=-0.1, maxval=0.1))
    got = sonn.apply_augment({k: _t(v) for k, v in batch.items()},
                             tuple(_t(d) for d in draws))
    assert sorted(got) == sorted(want)
    _close(got["pos"], want["pos"])
    if normals:
        _close(got["normal"], want["normal"])
    assert torch.equal(got["label"], _t(batch["label"]))


def test_modelnet_augment_applies_jax_draws():
    batch = _batch(np.random.default_rng(1), True)
    key = jax.random.PRNGKey(6)
    want = _load("train_modelnet").augment(
        key, {k: jnp.asarray(v) for k, v in batch.items()})
    k1, k2 = jax.random.split(key)
    draws = (jax.random.uniform(k1, (3, 1, 3), minval=0.8, maxval=1.25),
             jax.random.uniform(k2, (3, 1, 3), minval=-0.1, maxval=0.1))
    got = modelnet.apply_augment({k: _t(v) for k, v in batch.items()},
                                 tuple(_t(d) for d in draws))
    _close(got["pos"], want["pos"])
    _close(got["normal"], want["normal"])


def test_augments_draw_from_the_generator():
    batch = {k: _t(v) for k, v in _batch(np.random.default_rng(2),
                                         True).items()}
    for cli in (sonn, modelnet):
        a = cli.augment(torch.Generator().manual_seed(0), batch)
        b = cli.augment(torch.Generator().manual_seed(0), batch)
        c = cli.augment(torch.Generator().manual_seed(1), batch)
        assert torch.equal(a["pos"], b["pos"])
        assert not torch.equal(a["pos"], c["pos"])
        assert not torch.equal(a["pos"], batch["pos"])


def _run_dir(logs, name):
    (run,) = glob.glob(os.path.join(logs, "runs", name, "*"))
    return run


def _train_resume_evaluate(cli, name, argv, tmp_path, capsys):
    """One epoch, a resume to two in the same run, and an evaluate-only
    run of the run's checkpoints."""
    logs = str(tmp_path / "logs")
    state, scalars = cli.main(argv + ["--logdir", logs])
    out = capsys.readouterr().out
    assert "Test accuracy" in out and "Logging to" in out
    assert state.step > 0 and 0.0 <= scalars["test accuracy"] <= 1.0
    run = _run_dir(logs, name)
    assert os.path.isfile(os.path.join(run, "settings.txt"))
    assert os.path.isdir(os.path.join(run, "checkpoints", "step_1"))
    steps = state.step
    longer = list(argv)
    longer[longer.index("--epochs") + 1] = "2"
    resumed, _ = cli.main(longer + ["--logdir", logs, "--resume", run])
    assert "Resuming run in" in capsys.readouterr().out
    assert resumed.step == 2 * steps
    assert os.path.isdir(os.path.join(run, "checkpoints", "step_2"))
    evaluated, again = cli.main(argv + ["--checkpoint",
                                        os.path.join(run, "checkpoints")])
    for key, value in resumed.model.state_dict().items():
        assert torch.equal(value, evaluated.model.state_dict()[key]), key
    assert "Test accuracy" in capsys.readouterr().out
    with open(os.path.join(run, "metrics.jsonl")) as f:
        tags = [line for line in f if "test accuracy" in line]
    assert len(tags) == 2
    return again


def test_train_scanobjectnn_main_on_cpu(tmp_path, capsys):
    h5py = pytest.importorskip("h5py")
    raw = tmp_path / "sonn" / "raw" / "main_split_nobg"
    os.makedirs(raw)
    rng = np.random.default_rng(0)
    for fn, count in (("training_objectdataset.h5", 8),
                      ("test_objectdataset.h5", 4)):
        with h5py.File(raw / fn, "w") as f:
            f["data"] = rng.random((count, 64, 3)).astype(np.float32)
            f["label"] = rng.integers(0, 15, count)
    _train_resume_evaluate(sonn, "scanobjectnn", _FAST + [
        "--data_root", str(tmp_path / "sonn")], tmp_path, capsys)


def _write_box(path, rng):
    """A closed triangulated box, randomly stretched."""
    v = (np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                   for z in (0, 1)], np.float64) - 0.5) * rng.uniform(
        0.5, 1.5, 3)
    f = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
         (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    with open(path, "w") as fh:
        fh.write(f"OFF\n{len(v)} {len(f)} 0\n")
        fh.writelines(" ".join(f"{c:.6f}" for c in row) + "\n" for row in v)
        fh.writelines("3 " + " ".join(map(str, t)) + "\n" for t in f)


def test_train_modelnet_main_on_cpu(tmp_path, capsys):
    root = tmp_path / "modelnet"
    rng = np.random.default_rng(1)
    for cat in ("bed", "chair"):
        for split, count in (("train", 4), ("test", 2)):
            os.makedirs(root / "raw" / cat / split)
            for i in range(count):
                _write_box(root / "raw" / cat / split / f"{cat}_{i:04d}.off",
                           rng)
    open(root / "raw" / ".extracted", "w").close()
    scalars = _train_resume_evaluate(modelnet, "modelnet40", _FAST + [
        "--data_root", str(root)], tmp_path, capsys)
    assert sorted(scalars) == ["test accuracy", "test mean class accuracy"]


def _jax_angle(key, b):
    return jax.random.uniform(key, (b,), minval=-360.0,
                              maxval=360.0) * (jnp.pi / 180.0)


def _jax_box(key, b, lo, hi):
    return jax.random.uniform(key, (b, 1, 3), minval=lo, maxval=hi)


def _jax_draws(script, key):
    """The JAX CLI's own draws for a batch of 3 (its key split, its
    order), as the port's ``apply_augment`` takes them."""
    if script == "train_shrec":
        k = jax.random.split(key, 4)
        return (_jax_angle(k[0], 3), _jax_angle(k[1], 3), _jax_angle(k[2], 3),
                _jax_box(k[3], 3, -0.1, 0.1))
    if script == "train_shapenet":
        k0, k1 = jax.random.split(key)
        return (_jax_box(k0, 3, 2.0 / 3.0, 3.0 / 2.0),
                _jax_box(k1, 3, -0.2, 0.2))
    k = jax.random.split(key, 3)
    return (_jax_box(k[0], 3, 0.8, 1.2), _jax_angle(k[1], 3),
            _jax_box(k[2], 3, -0.1, 0.1))


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("script", ["train_shrec", "train_shapenet",
                                    "train_shapeseg"])
def test_augment_applies_jax_draws(script, normals):
    """SHREC's three rotations and offset, ShapeNet's scale and offset,
    ShapeSeg's scale, rotation about z and offset: the port's
    ``apply_augment`` of the JAX CLI's draws within 1e-6 of the JAX
    CLI's ``augment``; the labels pass through."""
    batch = _batch(np.random.default_rng(3), normals)
    key = jax.random.PRNGKey(7)
    want = _load(script).augment(
        key, {k: jnp.asarray(v) for k, v in batch.items()})
    got = PORT[script].apply_augment(
        {k: _t(v) for k, v in batch.items()},
        tuple(_t(d) for d in _jax_draws(script, key)))
    assert sorted(got) == sorted(want)
    _close(got["pos"], want["pos"])
    if normals:
        _close(got["normal"], want["normal"])
    assert torch.equal(got["label"], _t(batch["label"]))


def test_new_augments_draw_from_the_generator():
    batch = {k: _t(v) for k, v in _batch(np.random.default_rng(4),
                                         True).items()}
    for cli in (shrec, shapenet, shapeseg):
        a = cli.augment(torch.Generator().manual_seed(0), batch)
        b = cli.augment(torch.Generator().manual_seed(0), batch)
        c = cli.augment(torch.Generator().manual_seed(1), batch)
        assert torch.equal(a["pos"], b["pos"])
        assert not torch.equal(a["pos"], c["pos"])


def _io_fixtures():
    """``tests/test_torch_io.py``'s fixture writers."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    return importlib.import_module("test_torch_io")


def test_train_shrec_main_on_cpu(tmp_path, capsys):
    """Three classes of 13 training and 2 test meshes; ``--split_seed``
    keeps 10 a class for training."""
    os.makedirs(tmp_path / "shrec" / "raw")
    _io_fixtures()._shrec_zip(tmp_path / "shrec" / "raw" / "shrec_16.zip",
                              np.random.default_rng(2))
    _train_resume_evaluate(shrec, "shrec", _FAST + [
        "--split_seed", "0", "--data_root", str(tmp_path / "shrec")],
        tmp_path, capsys)


def test_train_and_vote_shapenet_main_on_cpu(tmp_path, capsys):
    """Three categories of 30-point clouds (so 16 points after the FPS):
    train, resume and evaluate; then ``test_shapenet`` votes twice on the
    run's checkpoints: its mIoU equals ``evaluate_voting`` on the
    restored weights, and a second call's."""
    from deltaconv_tpu_torch.training import (create_train_state,
                                              evaluate_voting, restore_any,
                                              sgd_momentum)

    root = tmp_path / "shapenet"
    _io_fixtures()._shapenet_raw(root, np.random.default_rng(5))
    argv = _FAST + ["--data_root", str(root)]
    argv[argv.index("--num_points") + 1] = "16"
    scalars = _train_resume_evaluate(shapenet, "shapenet", argv, tmp_path,
                                     capsys)
    assert sorted(scalars) == ["test accuracy", "test mIoU"]
    ckpts = os.path.join(_run_dir(str(tmp_path / "logs"), "shapenet"),
                         "checkpoints")
    voting = argv + ["--checkpoint", ckpts, "--num_votes", "2"]
    state, got = vote.main(voting)
    assert "Instance mIoU over 2 votes" in capsys.readouterr().out
    _, again = vote.main(voting)
    assert got == again and 0.0 <= got["test mIoU"] <= 1.0
    assert all(k == "test mIoU" or k.startswith("IoU ") for k in got)

    args = vote.build_parser().parse_args(voting)
    args = common.finish_args(args, "shapenet_test", "ShapeNet")
    _, test_ds, num_classes = shapenet.build_datasets_and_classes(args)
    model = shapenet.shapenet_model(args, num_classes)
    target = restore_any(ckpts, create_train_state(
        model, sgd_momentum(0.1), device="cpu"), params_only=True)
    from deltaconv_tpu_torch.data import BatchLoader

    want, _ = evaluate_voting(model, target, BatchLoader(
        test_ds, args.batch_size, shuffle=False, drop_last=False),
        shapenet.augment, num_votes=2, seed=args.seed)
    assert got["test mIoU"] == want
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, target.model.state_dict()[key]), key


def test_train_shapeseg_main_on_cpu(tmp_path, capsys, monkeypatch):
    """The miniature ShapeSeg archive (214 training meshes, cut 90/10,
    and 18 test meshes), two epochs: every best validation epoch saves
    its state as step 0 of the run's checkpoints, which restores to that
    state's bits; the evaluate-only run of it repeats the best epoch's
    test accuracy."""
    from deltaconv_tpu_torch import training

    raw = tmp_path / "shapeseg" / "raw"
    os.makedirs(raw)
    (raw / "shapeseg.zip").write_bytes(
        _io_fixtures()._shapeseg_archive(np.random.default_rng(7)))
    saved = []
    save = training.save_checkpoint

    def recording_save(ckpt_dir, state, step=None):
        saved.append({k: v.clone() for k, v in
                      state.model.state_dict().items()})
        return save(ckpt_dir, state, step=step)

    monkeypatch.setattr(training, "save_checkpoint", recording_save)
    argv = _FAST + ["--data_root", str(tmp_path / "shapeseg"),
                    "--batch_size", "16", "--epochs", "2"]
    logs = str(tmp_path / "logs")
    state, best = shapeseg.main(argv + ["--logdir", logs])
    out = capsys.readouterr().out
    assert "Test accuracy" in out and "Logging to" in out
    assert sorted(best) == ["test accuracy", "validation accuracy"]
    assert state.step == 2 * (int(214 * 0.9) // 16)
    ckpts = os.path.join(_run_dir(logs, "shapeseg"), "checkpoints")
    assert os.listdir(ckpts) == ["step_0"] and saved
    evaluated, scalars = shapeseg.main(argv + ["--checkpoint", ckpts])
    for key, value in evaluated.model.state_dict().items():
        assert torch.equal(value, saved[-1][key]), key
    assert scalars["test accuracy"] == best["test accuracy"]
