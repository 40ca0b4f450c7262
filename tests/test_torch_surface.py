"""The public surface of deltaconv_tpu_torch against the JAX package's:
every name a JAX subpackage exports, the version, the upstream exports
``ScalarVectorMLP`` and ``ScalarVectorIdentity`` on carried weights, and
``utils.Throughput`` / ``utils.trace``.

Tolerances: ``ScalarVectorMLP`` is the f32 ``MLP`` and ``VectorMLP`` in
another order of operations: 1e-5 x max for outputs and running
statistics, as ``tests/test_torch_train.py`` holds its layers.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu
import deltaconv_tpu_torch
from deltaconv_tpu.nn import ScalarVectorIdentity as JaxIdentity
from deltaconv_tpu.nn import ScalarVectorMLP as JaxSVMLP
from deltaconv_tpu.utils import Throughput as JaxThroughput
from deltaconv_tpu_torch import state_dict_from_flax
from deltaconv_tpu_torch.nn import ScalarVectorIdentity, ScalarVectorMLP
from deltaconv_tpu_torch.utils import Throughput, trace

torch.set_num_threads(1)

SUBPACKAGES = ["data", "geometry", "models", "nn", "ops", "parallel",
               "training", "transforms", "utils"]


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_every_jax_export_exists_in_the_port(name):
    """Each name in a JAX subpackage's ``__all__`` is in the matching port
    subpackage's ``__all__`` and is an attribute of it."""
    jax_mod = importlib.import_module(f"deltaconv_tpu.{name}")
    port = importlib.import_module(f"deltaconv_tpu_torch.{name}")
    missing = sorted(set(jax_mod.__all__) - set(port.__all__))
    assert not missing, f"{name}: {missing}"
    assert all(hasattr(port, n) for n in port.__all__)


def test_version_and_subpackages_as_jax():
    """``__version__``, ``version_info`` and the subpackages JAX's
    ``__init__`` imports."""
    assert deltaconv_tpu_torch.__version__ == deltaconv_tpu.__version__
    assert deltaconv_tpu_torch.version_info == deltaconv_tpu.version_info
    for name in ("geometry", "nn", "models", "transforms"):
        assert hasattr(deltaconv_tpu_torch, name), name
    assert {"__version__", "version_info"} <= set(deltaconv_tpu_torch.__all__)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("nonlin,vector_stream,train", [
    (True, True, False), (True, True, True), (False, True, True),
    (True, False, True)])
def test_scalar_vector_mlp_matches_jax(nonlin, vector_stream, train):
    """``ScalarVectorMLP([5, 8, 6])`` on an ``(x, v)`` tuple (or ``x``
    alone without the vector stream): the parameter names
    (``scalar_mlp.*``, ``vector_mlp.*``) carry JAX's weights strictly,
    outputs and, in train mode, the running statistics match."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 20, 5)).astype(np.float32)
    v = rng.standard_normal((3, 20, 2, 5)).astype(np.float32)
    xv = (x, v) if vector_stream else x
    layer = JaxSVMLP((8, 6), nonlin=nonlin, vector_stream=vector_stream)
    variables = layer.init(jax.random.PRNGKey(0), xv)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
            np.float32), dict(variables["batch_stats"]))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    want, mutated = layer.apply({"params": params, "batch_stats": stats}, xv,
                                train=train, mutable=["batch_stats"])
    port = ScalarVectorMLP([5, 8, 6], nonlin=nonlin,
                           vector_stream=vector_stream)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    assert all(k.startswith(("scalar_mlp.", "vector_mlp."))
               for k in port.state_dict())
    port.train(train)
    txv = (torch.from_numpy(x), torch.from_numpy(v)) if vector_stream else (
        torch.from_numpy(x))
    got = port(txv)
    if vector_stream:
        _close(got[0], want[0], "x")
        _close(got[1], want[1], "v")
    else:
        _close(got, want, "x")
    new = state_dict_from_flax(params, jax.tree_util.tree_map(
        np.asarray, dict(mutated["batch_stats"])))
    for key, b in port.named_buffers():
        _close(b, new[key].numpy(), key)
    if vector_stream:
        with pytest.raises(ValueError, match="tuple"):
            port(torch.from_numpy(x))


def test_scalar_vector_identity_returns_its_input():
    x, v = torch.ones(2, 3), torch.zeros(2, 2, 3)
    got = ScalarVectorIdentity()((x, v))
    want = JaxIdentity().apply({}, (jnp.ones((2, 3)), jnp.zeros((2, 2, 3))))
    assert got[0] is x and got[1] is v and len(want) == 2


@pytest.mark.parametrize("warmup", [0, 1, 2, 3])
def test_throughput_counts_as_jax(warmup, monkeypatch):
    """Five ticks of 7, 8, 9, 10, 11 items on a fake clock: the port's
    meter starts and counts where JAX's does, and ``sync`` takes a
    tensor, a dict or a tuple of them."""
    clock = iter(float(t) for t in range(100))
    import time as time_mod
    monkeypatch.setattr(time_mod, "perf_counter", lambda: next(clock))
    rates = []
    for meter, sync in ((JaxThroughput(warmup), jnp.zeros(2)),
                        (Throughput(warmup), {"a": (torch.zeros(2),)})):
        for items in range(7, 12):
            meter.tick(items, sync=sync)
        rates.append((meter._start, meter._items, meter.rate()))
    assert rates[0][1] == rates[1][1]
    assert (rates[0][0] is None) == (rates[1][0] is None)
    assert rates[0][2] > 0 or warmup == 0
    assert (rates[1][2] > 0) == (rates[0][2] > 0)


def test_trace_writes_a_trace_file(tmp_path):
    """``trace(logdir)`` records the block's operators and writes one
    ``*.pt.trace.json`` into ``logdir`` that names them."""
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    assert "aten::mm" in (logdir / files[0]).read_text()
