"""deltaconv_tpu_torch's CUDA kernels against their plain versions, on
the card. Skipped where there is no CUDA device. On a GPU machine
(which has no JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Shapes are small and include widths the serving path never uses (N not
a multiple of 4, C not a multiple of 32) so that every branch of the
kernels' indexing runs.
"""

import numpy as np
import pytest
import torch

from deltaconv_tpu_torch import (PLAIN_OPS, DeltaNetClassification,
                                 InferenceEngine, launch_counts,
                                 reset_launch_counts)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.geometry import build_tangent_basis, knn
from deltaconv_tpu_torch.ops.gather_max import NEG
from deltaconv_tpu_torch.ops.wls_fused import edge_planes

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cloud_batch(rng, b, n, dev):
    d = rng.standard_normal((b, n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axes = rng.uniform(0.5, 1.5, (b, 1, 3)).astype(np.float32)
    nrm = d / axes
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return (torch.from_numpy(d * axes).to(dev),
            torch.from_numpy(nrm).to(dev))


def _graph(pos, k, masked):
    pm = None
    if masked:
        pm = torch.ones(pos.shape[:2], dtype=torch.bool, device=pos.device)
        pm[0, pos.shape[1] // 2:] = False
    idx, mask = knn(pos, k, pm)
    if pm is not None:
        mask = mask & pm[:, :, None]
    return idx, mask


@pytest.mark.parametrize("n", [100, 256])
def test_gather_rows_kernel_exact(cuda, n):
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.standard_normal((2, n, 9)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(
        rng.integers(0, n, (2, n, 7)).astype(np.int32)).to(cuda)
    got = ops.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.gather_rows_plain(table, idx))


@pytest.mark.parametrize("masked", [False, True])
def test_wls_kernel_matches_plain(cuda, masked):
    """atol 1e-5: FMA contraction and the order of the K sums."""
    rng = np.random.default_rng(1)
    pos, nrm = _cloud_batch(rng, 2, 200, cuda)
    idx, mask = _graph(pos, 12, masked)
    xb, yb = build_tangent_basis(nrm)
    pm = mask.any(dim=2).to(torch.float32)
    edges = edge_planes(pos, nrm, xb, yb, idx, mask, pm)
    for got, want in zip(ops.wls(edges, 1.0, 1e-3),
                         ops.wls_plain(edges, 1.0, 1e-3)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,masked", [(96, False), (102, True)])
def test_densify_kernel_matches_plain(cuda, n, masked):
    rng = np.random.default_rng(2)
    k = 8
    idx = rng.integers(0, n, (2, n, k)).astype(np.int32)
    idx[:, :, 0] = np.arange(n)
    gc = rng.standard_normal((2, n, k, 2)).astype(np.float32)
    dc = rng.standard_normal((2, n, k, 2)).astype(np.float32)
    if masked:  # padded slots clamped to self with zero coefficients
        idx[:, :, -3:] = np.arange(n)[None, :, None]
        gc[:, :, -3:] = 0.0
        dc[:, :, -3:] = 0.0
    args = [torch.from_numpy(a).to(cuda) for a in (idx, gc, dc)]
    got = ops.densify_coefs(*args)
    want = ops.densify_coefs_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("c", [3, 64, 300])
def test_gather_max_kernel_exact(cuda, c):
    rng = np.random.default_rng(3)
    n, k = 150, 9
    h = torch.from_numpy(
        rng.standard_normal((2, n, c)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(
        rng.integers(0, n, (2, n, k)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((2, n, k)) > 0.3).to(cuda)
    mask[0, 4] = False  # no valid neighbour: -3e38
    got = ops.gather_max(h, idx, mask)
    assert torch.equal(got, ops.gather_max_plain(h, idx, mask))
    assert bool((got[0, 4] == NEG).all())


def test_kernel_inputs_are_checked(cuda):
    h = torch.zeros((2, 16, 4), device=cuda)
    idx = torch.zeros((2, 16, 3), dtype=torch.int32, device=cuda)
    mask = torch.ones((2, 16, 3), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        ops.gather_max(h.double(), idx, mask)
    with pytest.raises(TypeError):
        ops.gather_max(h, idx.long(), mask)
    with pytest.raises(ValueError, match="shape"):
        ops.gather_max(h, idx, mask[:, :, :2])
    with pytest.raises(ValueError, match="contiguous"):
        ops.gather_max(h.transpose(0, 1).contiguous().transpose(0, 1), idx,
                       mask)
    with pytest.raises(ValueError, match="forward only"):
        ops.gather_max(h.clone().requires_grad_(), idx, mask)


def test_model_kernels_match_plain(cuda):
    """The narrow model served through the kernels and through the plain
    versions on the card; every kernel is launched."""
    rng = np.random.default_rng(4)
    model = DeltaNetClassification(
        5, conv_channels=(8, 8, 16, 16), embedding_size=32, num_neighbors=8,
        generator=torch.Generator().manual_seed(0)).to(cuda)
    engine = InferenceEngine(model, num_points=128, batch_size=4)
    plain = InferenceEngine(model, num_points=128, batch_size=4,
                            ops=PLAIN_OPS)
    pos, nrm = _cloud_batch(rng, 5, 128, "cpu")
    clouds = [p[:s].numpy() for p, s in zip(pos, [128, 128, 90, 128, 60])]
    normals = [q[:s].numpy() for q, s in zip(nrm, [128, 128, 90, 128, 60])]
    reset_launch_counts()
    got = engine.predict(clouds, normals)
    assert all(n > 0 for n in launch_counts().values())
    want = plain.predict(clouds, normals)
    np.testing.assert_allclose(got, want, atol=1e-4)
