"""deltaconv_tpu_torch as a package: it imports without JAX, its kernel
wrappers dispatch on the device of their inputs, and the serving
surface rejects what the port does not have yet."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deltaconv_tpu_torch import (DeltaNetClassification, InferenceEngine,
                                 KERNEL_OPS, PLAIN_OPS, launch_counts,
                                 reset_launch_counts)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.models import build_operators

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

_NO_JAX = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "deltaconv_tpu"):
    sys.modules[name] = None  # any import of them now fails
import deltaconv_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    deltaconv_tpu_torch.__path__, "deltaconv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "flax", "deltaconv_tpu")
               for m, mod in sys.modules.items() if mod is not None)
print(len(names))
"""


def test_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported


def _inputs(rng, b=2, n=32, k=6, c=5):
    h = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(np.int32))
    mask = torch.from_numpy(rng.random((b, n, k)) > 0.2)
    return h, idx, mask


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    h, idx, mask = _inputs(rng)
    reset_launch_counts()
    torch.testing.assert_close(ops.gather_max(h, idx, mask),
                               ops.gather_max_plain(h, idx, mask),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.gather_rows(h, idx),
                               ops.gather_rows_plain(h, idx), rtol=0, atol=0)
    assert launch_counts() == {"gather_rows": 0, "wls": 0, "densify": 0,
                               "gather_max": 0}
    assert KERNEL_OPS.gather_max is ops.gather_max
    assert PLAIN_OPS.gather_max is ops.gather_max_plain


def test_kernels_refuse_other_devices():
    """A wrapper runs its kernel only on CUDA tensors: anything that is
    neither CPU nor CUDA raises before a launch. (The dtype, shape,
    contiguity and autograd checks are tested on the card,
    tests/test_torch_gpu.py.)"""
    rng = np.random.default_rng(1)
    h, idx, mask = _inputs(rng)
    meta = torch.device("meta")
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_max(h.to(meta), idx.to(meta), mask.to(meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_rows(h.to(meta), idx.to(meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.densify_coefs(idx.to(meta), torch.zeros(2, 32, 6, 2, device=meta),
                          torch.zeros(2, 32, 6, 2, device=meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.wls(torch.zeros(2, 12, 6, 32, device=meta), 1.0, 1e-3)
    assert sum(launch_counts().values()) == 0


def test_precision_modes():
    model = DeltaNetClassification(4, conv_channels=(8, 8), embedding_size=16,
                                   num_neighbors=4)
    for precision in (None, "float32"):
        InferenceEngine(model, num_points=16, precision=precision)
    for precision in ("bfloat16", "int8"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            InferenceEngine(model, num_points=16, precision=precision)
    with pytest.raises(ValueError, match="unknown precision"):
        InferenceEngine(model, num_points=16, precision="fp8")


def test_engine_rejects_oversized_and_mismatched_clouds():
    model = DeltaNetClassification(4, conv_channels=(8, 8), embedding_size=16,
                                   num_neighbors=4)
    engine = InferenceEngine(model, num_points=16, batch_size=2)
    cloud = np.zeros((17, 3), np.float32)
    with pytest.raises(ValueError, match="num_points"):
        engine.predict([cloud], [cloud])
    with pytest.raises(ValueError, match="normals"):
        engine.predict([cloud[:8]], [cloud[:7]])


def test_normal_estimation_not_ported():
    pos = torch.zeros((1, 8, 3))
    with pytest.raises(NotImplementedError, match="estimate_basis"):
        build_operators(pos, 4)


def test_seeded_init_is_reproducible():
    def make(seed):
        return DeltaNetClassification(
            4, conv_channels=(8, 8), embedding_size=16, num_neighbors=4,
            generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(0), make(0), make(1)
    w = "deltanet_base.convs.0.s_mlp.0.0.weight"
    torch.testing.assert_close(a[w], b[w], rtol=0, atol=0)
    assert not torch.equal(a[w], c[w])
    assert a[w].abs().max() <= 1.0 / np.sqrt(a[w].shape[1])
