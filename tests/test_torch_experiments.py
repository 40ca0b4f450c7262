"""The port's experiments against the JAX package's on the CPU: the
anisotropic-diffusion study's Perona-Malik target and six image ResNets
on carried weights, and, at a tiny size, the synthetic convergence run
and the offline rehearsal.

Tolerances, and why: the diffusion target and the networks are f32
convolutions and products in another order (XLA's against torch's): the
target within 1e-6 x max after 5 steps (measured 1.2e-7), each network's
output within 1e-5 x max (measured up to 8.0e-7), its loss gradient in
every parameter within 1e-4 x max (measured up to 7.2e-7).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu_torch.experiments import offline_rehearsal
from deltaconv_tpu_torch.experiments import synthetic_convergence
from deltaconv_tpu_torch.experiments.anisotropic_diffusion import (
    architectures, diffusion, run_study)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "experiments", "anisotropic_diffusion"))
import architectures as jax_arch  # noqa: E402
import diffusion as jax_diffusion  # noqa: E402

torch.set_num_threads(1)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("c_func", ["exp", "inverse"])
def test_diffusion_target_matches_jax(c_func):
    """The normalized Sobel gradient, the Laplacian and 5 Perona-Malik
    steps of the test image (both conductances) against JAX's."""
    image = diffusion.make_test_image(32, seed=3)
    np.testing.assert_array_equal(image, jax_diffusion.make_test_image(32, 3))
    t, j = torch.from_numpy(image), jnp.asarray(image)
    for got, want in zip(diffusion.spatial_gradient(t),
                         jax_diffusion.spatial_gradient(j)):
        _close(got, want, 1e-6, "gradient")
    _close(diffusion.laplacian(t), jax_diffusion.laplacian(j), 1e-6,
           "laplacian")
    _close(diffusion.anisotropic_diffusion_nsteps(t, 5, c_func=c_func),
           jax_diffusion.anisotropic_diffusion_nsteps(j, 5, c_func=c_func),
           1e-6, "target")


@pytest.mark.parametrize("index", range(len(architectures.ALL_NETS)))
def test_architecture_matches_jax_on_carried_weights(index):
    """Each of the six networks (3 layers, width 6) on a 16 x 16 test
    image: the JAX network's initial parameters carried by
    ``state_dict_from_flax_study`` load strictly; outputs and the L1
    loss's parameter gradients match."""
    port_cls = architectures.ALL_NETS[index]
    jax_cls = jax_arch.ALL_NETS[index]
    assert port_cls.net_name() == jax_cls.net_name()
    image = diffusion.make_test_image(16, seed=4)
    target = jax_diffusion.anisotropic_diffusion_nsteps(
        jnp.asarray(image), 3)
    jmodel = jax_cls(num_layers=3, out_channels=6, in_channels=1)
    params = jmodel.init(jax.random.PRNGKey(index), jnp.asarray(image))

    def loss(p):
        return jnp.mean(jnp.abs(jmodel.apply(p, jnp.asarray(image)) - target))

    want = jmodel.apply(params, jnp.asarray(image))
    want_grad = architectures.state_dict_from_flax_study(
        jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))
    port = port_cls(num_layers=3, out_channels=6, in_channels=1)
    port.load_state_dict(architectures.state_dict_from_flax_study(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    got = port(torch.from_numpy(image))
    _close(got, want, 1e-5, "output")
    (got - torch.from_numpy(np.array(target))).abs().mean().backward()
    for key, p in port.named_parameters():
        _close(p.grad, want_grad[key].numpy(), 1e-4, key)


def test_study_trains_every_network(tmp_path):
    """``run_study.main`` at a tiny size on the CPU: one finite final L1
    per network, each below the untrained network's, and one JSON line
    each."""
    out = tmp_path / "study.jsonl"
    results = run_study.main(["--device", "cpu", "--iterations", "12",
                              "--size", "16", "--num_layers", "3",
                              "--width", "4", "--steps", "3",
                              "--out-jsonl", str(out)])
    assert [name for name, _ in results] == [
        n.net_name() for n in architectures.ALL_NETS]
    assert all(np.isfinite(l1) for _, l1 in results)
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [line["net"] for line in lines] == [name for name, _ in results]
    image = torch.from_numpy(diffusion.make_test_image(16))
    target = diffusion.anisotropic_diffusion_nsteps(image, 3)
    for (name, l1), cls in zip(results, architectures.ALL_NETS):
        _, untrained = run_study.train_net(cls, image, target, 0, 3, 4, 1e-3)
        assert l1 < untrained, name


@pytest.mark.parametrize("task", ["cls", "seg"])
def test_synthetic_convergence_runs(task, tmp_path, capsys):
    """``synthetic_convergence.run`` at a tiny size on the CPU: its curve
    in ``metrics.jsonl`` and the final JSON line with JAX's keys."""
    args = synthetic_convergence.build_args([
        "--device", "cpu", "--task", task, "--epochs", "2",
        "--train_size", "8", "--eval_size", "8", "--batch_size", "4",
        "--num_points", "64", "--k", "8", "--logdir", str(tmp_path),
        "--eval_precisions", "bfloat16"])
    best, hit, extras = synthetic_convergence.run(args)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == ({"task"} if task == "seg" else set()) | {
        "converged", "epochs", "best_accuracy", "target",
        "accuracy_bfloat16"}
    assert last["best_accuracy"] == round(best, 4)
    assert 0.0 <= best <= 1.0 and "accuracy_bfloat16" in extras
    tags = [json.loads(line)["tag"] for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert tags.count("training loss") == 2
    assert tags.count("test accuracy") == 2


def test_offline_rehearsal_passes_on_the_cpu(capsys):
    """The rehearsal's two legs (ModelNet10 ``.pt`` evaluation and the
    ShapeNet 2-vote evaluation) on the CPU."""
    assert offline_rehearsal.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        "offline rehearsal: OK")
