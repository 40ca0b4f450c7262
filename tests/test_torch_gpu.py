"""deltaconv_tpu_torch's CUDA kernels against their plain versions, on
the card. Skipped where there is no CUDA device. On a GPU machine
(which has no JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Shapes are small and include widths the model never uses (N not a
multiple of 4, C not a multiple of 32) so that every branch of the
kernels' indexing runs. ``scatter_add_`` adds in any order on the
card, so a scatter against it is held to 1e-5 x max|dh|;
``scatter_rows`` adds in a fixed order, and the winner-routed
``gather_max_bwd`` and ``gather_minmax_bwd``, the neighbour sum's
``gather_sum_bwd`` and ``edge_delta_mlp_bwd``'s ``dy`` sum exactly in
f64 and round once, so these are held bit-equal to themselves across
calls and to their plain versions where both see the same addends.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from deltaconv_tpu_torch import (KERNEL_OPS, PLAIN_OPS,
                                 DeltaNetClassification,
                                 DeltaNetSegmentation, InferenceEngine,
                                 launch_counts, reset_launch_counts)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.geometry import build_tangent_basis, knn
from deltaconv_tpu_torch.models import build_operators
from deltaconv_tpu_torch.ops.gather_max import NEG
from deltaconv_tpu_torch.ops.wls_fused import edge_planes
from deltaconv_tpu_torch.training import (create_train_state,
                                          make_train_step, sgd_momentum)

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


@pytest.mark.parametrize("c", [9, 3])
@pytest.mark.parametrize("n", [100, 101, 256, 8195])
def test_gather_rows_kernel_exact(cuda, n, c):
    """Bit-equal to the plain version with the table staged in shared
    memory (N up to 256) or read through the read-only path (N=8195, a
    table above 96 KB), N % 4 != 0 (scalar stores) and a last partial
    tile."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.standard_normal((2, n, c)).astype(np.float32)).to(cuda)
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
    # Differentiated, the neighbour max and the gather are autograd
    # Functions whose backward is a kernel; the raw kernels and the build
    # kernels without a backward refuse a tensor that requires grad.
    hg = h.clone().requires_grad_()
    reset_launch_counts()
    ops.gather_max(hg, idx, mask).sum().backward()
    ops.gather_rows(hg, idx).sum().backward()
    assert launch_counts()["gather_max_win"] == 1
    assert launch_counts()["gather_max_bwd"] == 1
    assert launch_counts()["gather_rows"] == 1
    assert launch_counts()["scatter_rows"] == 1
    assert launch_counts()["inverse_adjacency"] == 1
    assert hg.grad.shape == h.shape
    with pytest.raises(ValueError, match="requires grad"):
        ops.gather_max_win(hg, idx, mask)
    coef = torch.zeros((2, 16, 3, 2), device=cuda)
    with pytest.raises(TypeError):
        ops.coef_apply_grad(h.half(), coef, idx)
    with pytest.raises(ValueError, match="shape"):
        ops.coef_apply_grad(h, coef[:, :, :2], idx)
    with pytest.raises(ValueError, match="shape"):
        ops.coef_apply_div(h, coef, idx)
    with pytest.raises(TypeError):
        ops.scatter_rows(torch.zeros((2, 4, 3, 16), device=cuda).double(),
                         idx, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.scatter_rows(torch.zeros((2, 4, 3, 16), device=cuda),
                         idx.transpose(1, 2).contiguous().transpose(1, 2), 16)
    # The build's WLS solve and assembly are autograd Functions too (their
    # backward kernels wls_bwd and densify_bwd); the fused eval build is
    # forward only.
    edges = torch.rand((2, 12, 3, 16), device=cuda).requires_grad_()
    coef = torch.zeros((2, 16, 3, 2), device=cuda, requires_grad=True)
    reset_launch_counts()
    sum(t.sum() for t in ops.wls(edges, 1.0, 1e-3)).backward()
    sum(t.sum() for t in ops.densify_coefs(idx, coef, coef)).backward()
    assert launch_counts()["wls_bwd"] == 1
    assert launch_counts()["densify_bwd"] == 1
    assert edges.grad.shape == edges.shape and coef.grad.shape == coef.shape
    p3 = torch.zeros((2, 16, 3), device=cuda)
    with pytest.raises(ValueError, match="forward only"):
        ops.fused_gather_wls(p3.clone().requires_grad_(), p3, p3, p3, idx,
                             mask, torch.ones(2, device=cuda))


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
    counts = launch_counts()
    assert all(counts[name] > 0
               for name in ("gather_rows", "wls", "densify", "gather_max"))
    want = plain.predict(clouds, normals)
    np.testing.assert_allclose(got, want, atol=1e-4)


def _rand_graph(rng, n, k, dev):
    idx = torch.from_numpy(
        rng.integers(0, n, (2, n, k)).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((2, n, k)) > 0.3).to(dev)
    mask[0, 4] = False  # no valid neighbour
    return idx, mask


def _close_to_max(got, want, rtol):
    tol = rtol * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def _bwd_exact(kernel, plain, args, got=None):
    """A winner-routed backward bit-equal to its plain version and to a
    second call of itself."""
    got = kernel(*args) if got is None else got
    want = plain(*args)
    assert got.dtype == torch.float32
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(kernel(*args), got)


@pytest.mark.parametrize("b,n,k", [(2, 100, 9), (2, 150, 9), (2, 1024, 20),
                                   (2, 1027, 20), (3, 5, 40), (1, 12500, 20)])
def test_adjacency_kernel_exact(cuda, b, n, k):
    """Bit-equal to ``scatter_add_`` of the mask (counts are exact): rows
    that do not start on a 16-byte boundary (N % 4 != 0), repeated and
    masked slots, more slots than a warp's lanes (K=40 > 32), and an N
    above 12,288, the row a 48 KB shared-memory design could stage."""
    rng = np.random.default_rng(60)
    idx = torch.from_numpy(
        rng.integers(0, n, (b, n, k)).astype(np.int32)).to(cuda)
    idx[:, :, 1] = idx[:, :, 0]  # every row counts one column twice
    mask = torch.from_numpy(rng.random((b, n, k)) > 0.3).to(cuda)
    mask[0, 4] = False  # no valid neighbour
    reset_launch_counts()
    got = ops.adjacency(idx, mask)
    torch.cuda.synchronize()
    assert launch_counts()["adjacency"] == 1
    assert got.shape == (b, n, n) and got.dtype == torch.float32
    assert torch.equal(got, ops.adjacency_plain(idx, mask))


@pytest.mark.parametrize("c", [3, 64, 300])
def test_gather_max_win_and_bwd_kernels(cuda, c):
    """Forward with winners bit-equal (ties from repeated indices and
    rounded values included); the winner-routed scatter bit-equal to the
    plain version and across two calls."""
    rng = np.random.default_rng(5)
    n, k = 150, 9
    h = torch.from_numpy(np.round(
        rng.standard_normal((2, n, c)) * 8).astype(np.float32)).to(cuda)
    idx, mask = _rand_graph(rng, n, k, cuda)
    out, win = ops.gather_max_win(h, idx, mask)
    out_p, win_p = ops.gather_max_win_plain(h, idx, mask)
    assert torch.equal(out, out_p) and torch.equal(win, win_p)
    assert not win[0, 4].any()
    g = torch.randn((2, n, c), device=cuda)
    _bwd_exact(ops.gather_max_bwd, ops.gather_max_bwd_plain,
               (idx, win, g, n))


@pytest.mark.parametrize("n,c", [(100, 3), (150, 64), (77, 300)])
def test_gather_sum_kernels(cuda, n, c):
    """Adjacency and the streaming sum (both in slot order) bit-equal,
    its scatter (f64 sums rounded once) bit-equal to the plain version
    and across two calls; the differentiable sum on both routes (the
    streaming one bit-equal)."""
    rng = np.random.default_rng(6)
    idx, mask = _rand_graph(rng, n, 9, cuda)
    assert torch.equal(ops.adjacency(idx, mask),
                       ops.adjacency_plain(idx, mask))
    h = torch.randn((2, n, c), device=cuda)
    g = torch.randn((2, n, c), device=cuda)
    reset_launch_counts()
    assert torch.equal(ops.gather_sum_fwd(h, idx, mask),
                       ops.gather_sum_fwd_plain(h, idx, mask))
    assert launch_counts()["gather_sum"] == 1  # route S at these shapes
    _bwd_exact(ops.gather_sum_bwd, ops.gather_sum_bwd_plain, (idx, mask, g))
    gs = importlib.import_module("deltaconv_tpu_torch.ops.gather_sum")
    budget = gs._DENSE_ADJ_MAX_BYTES
    try:
        for cutoff in (budget, 0):  # dense route, then streaming
            gs._DENSE_ADJ_MAX_BYTES = cutoff
            grads = []
            for fn in (ops.gather_sum, ops.gather_sum_plain):
                hg = h.clone().requires_grad_()
                (fn(hg, idx, mask) * g).sum().backward()
                grads.append(hg.grad)
            _close_to_max(grads[0], grads[1], 1e-5)
            if cutoff == 0:
                assert torch.equal(grads[0], grads[1])
    finally:
        gs._DENSE_ADJ_MAX_BYTES = budget


@pytest.mark.parametrize("b,n,c,k,route", [
    (2, 100, 3, 9, None), (2, 150, 64, 9, None), (2, 77, 300, 9, None),
    (4, 8192, 128, 20, None),        # the large-cloud step: 16-byte rows
    (32, 1024, 128, 20, None),       # 128-byte rows
    (1, 14527, 16, 20, None),        # above every slice: route D
    (2, 150, 8, 0, None),            # no slot: route D
    (4, 8192, 128, 20, (0, 0)),      # forced route D
    (2, 150, 64, 9, (0, 0)),
    (2, 150, 64, 9, (4, 3)),         # every row width, split tasks
    (2, 150, 64, 9, (8, 1)), (2, 150, 64, 9, (16, 2)),
    (2, 77, 301, 9, (32, 5)),        # an odd width: outputs one by one
])
def test_gather_sum_routes_exact(cuda, b, n, c, k, route):
    """The streaming forward's two routes (S, the staged slice, by shape or
    forced; D, ``gather_sum_direct``) bit-equal to the plain version (slots
    summed in slot order from +0.0) and to a second call, one launch of the
    route each; a masked slot, an id outside [0, N) and a row with no valid
    slot add nothing."""
    gs = importlib.import_module("deltaconv_tpu_torch.ops.gather_sum")
    rng = np.random.default_rng(60)
    idx = torch.from_numpy(
        rng.integers(0, n, (b, n, k)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((b, n, k)) > 0.3).to(cuda)
    if k:
        mask[0, 4] = False  # no valid neighbour
        idx[0, 5, 0], idx[-1, 6, k - 1] = -1, n  # outside the cloud
        mask[0, 5, 0] = mask[-1, 6, k - 1] = True
    h = torch.randn((b, n, c), device=cuda)
    inside = (idx >= 0) & (idx < n)
    want = ops.gather_sum_fwd_plain(h, torch.where(inside, idx, 0),
                                    mask & inside)
    if route is None:
        cs = gs.sum_slice(b, n, c, k, torch.cuda.get_device_properties(
            0).multi_processor_count)[0]
    else:
        cs = route[0]
    name = "gather_sum" if cs else "gather_sum_direct"
    reset_launch_counts()
    got = gs._gather_sum_fwd(h, idx, mask, route)
    again = gs._gather_sum_fwd(h, idx, mask, route)
    torch.cuda.synchronize()
    assert {m: v for m, v in launch_counts().items() if v} == {name: 2}
    assert torch.equal(got, want) and torch.equal(again, got)


def _train_step_params(batch, ops_, seed=0):
    model = DeltaNetClassification(
        5, conv_channels=(8, 8, 16, 16), embedding_size=32, num_neighbors=8,
        dropout=0.0, generator=torch.Generator().manual_seed(seed))
    model = model.to(batch["pos"].device)
    state = create_train_state(model, sgd_momentum(0.01))
    loss = float(make_train_step(model, ops=ops_)(state, batch, None)["loss"])
    return loss, model


@pytest.mark.parametrize("streaming", [False, True])
def test_train_step_kernels_match_plain(cuda, streaming):
    """One narrow-model train step through the kernels and through the
    plain versions on the card, ragged batch; with the gather-sum
    budget at 0 the streaming kernels run inside the step."""
    rng = np.random.default_rng(7)
    pos, nrm = _cloud_batch(rng, 4, 128, cuda)
    batch = {"pos": pos, "normal": nrm,
             "label": torch.tensor([0, 1, 2, 3], device=cuda),
             "point_mask": torch.arange(128, device=cuda)[None, :]
             < torch.tensor([[128], [90], [128], [60]], device=cuda)}
    gs = importlib.import_module("deltaconv_tpu_torch.ops.gather_sum")
    budget = gs._DENSE_ADJ_MAX_BYTES
    gs._DENSE_ADJ_MAX_BYTES = 0 if streaming else budget
    try:
        reset_launch_counts()
        loss_k, model_k = _train_step_params(batch, KERNEL_OPS)
        counts = launch_counts()
        loss_p, model_p = _train_step_params(batch, PLAIN_OPS)
    finally:
        gs._DENSE_ADJ_MAX_BYTES = budget
    used = (("gather_sum", "gather_sum_bwd") if streaming
            else ("adjacency",))
    assert all(counts[name] > 0 for name in
               ("gather_max_win", "gather_max_bwd") + used), counts
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    params_p = dict(model_p.named_parameters())
    for name, p in model_k.named_parameters():
        _close_to_max(p.grad, params_p[name].grad, 1e-3)
        _close_to_max(p.detach(), params_p[name].detach(), 1e-3)
    bufs_p = dict(model_p.named_buffers())
    for name, b in model_k.named_buffers():
        _close_to_max(b, bufs_p[name], 1e-4)


# -- the bf16 serving slice ---------------------------------------------------


def _bf16_ulps(a, b):
    def ordered(t):
        u = t.contiguous().view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

    return (ordered(a) - ordered(b)).abs()


def _bits(t):
    return t.view(torch.int16)


def _knn_cloud(rng, b, n, cloud):
    """``[b, n, 3]`` f32 numpy positions: ``"gauss"`` with a duplicate
    point (one exact tie), or ``"grid"``, a coarse 9^3 grid with many
    duplicates, where equal scores and equal quantized keys abound."""
    if cloud == "grid":
        return (rng.integers(-4, 5, (b, n, 3)) * 0.25).astype(np.float32)
    pos = rng.standard_normal((b, n, 3)).astype(np.float32)
    pos[0, 5 % n] = pos[0, 2 % n]
    return pos


# (B, N, K): the register-path and recomputing shapes of the earlier
# kernel, the model shapes (N = 1024, 2048, 8192), N just above the
# kernel's 8192-point staging tile and above two tiles, K = 1, each list
# capacity (20, 32, 64), and K = 80 (> 64: the rounds route, N <= 1024
# and above); K = 10, the normal graph of a cloud without normals, at the
# ScanObjectNN recipe's B=32, N=1024 and at a ragged N.
KNN_TOPK_CASES = [(2, 77, 20), (2, 1024, 20), (2, 1500, 20), (2, 2048, 30),
                  (2, 4096, 20), (1, 8192, 20), (2, 2049, 20), (1, 8193, 30),
                  (1, 16400, 20), (2, 300, 1), (2, 300, 32), (2, 1100, 64),
                  (2, 300, 80), (1, 1500, 80), (32, 1024, 10), (2, 77, 10)]


@pytest.mark.parametrize("cloud", ["gauss", "grid"])
@pytest.mark.parametrize("b,n,k", KNN_TOPK_CASES)
@pytest.mark.parametrize("quantized", [True, False])
def test_knn_topk_kernel_exact(cuda, b, n, k, cloud, quantized):
    """Bit-equal indices, order included, self in slot 0, on a Gaussian
    cloud with a duplicate point and on a tie-heavy grid; one launch of
    the selection kernel (``knn_topk``) up to K = 64, of the rounds kernel
    (``knn_topk_rounds``) above."""
    rng = np.random.default_rng(10)
    pos = torch.from_numpy(_knn_cloud(rng, b, n, cloud)).to(cuda)
    reset_launch_counts()
    got = ops.knn_topk(pos, k, quantized)
    torch.cuda.synchronize()
    counts = launch_counts()
    rounds = k > 64
    assert (counts["knn_topk"], counts["knn_topk_rounds"]) == (
        (0, 1) if rounds else (1, 0))
    want = ops.knn_topk_plain(pos, k, quantized)
    assert torch.equal(got, want)
    assert torch.equal(got[:, :, 0].long(),
                       torch.arange(n, device=cuda).expand(b, n))


@pytest.mark.parametrize("n,masked", [(96, False), (102, True)])
def test_densify_bf16_kernel_exact(cuda, n, masked):
    """Bit-equal to f32 scatter_add_ then the bf16 cast, on neighbour
    lists as the kNN makes them (distinct columns, clamped zero slots)."""
    rng = np.random.default_rng(11)
    k = 8
    idx = np.stack([np.stack([np.concatenate(
        [[i], rng.permutation(np.delete(np.arange(n), i))[:k - 1]])
        for i in range(n)]) for _ in range(2)]).astype(np.int32)
    gc = rng.standard_normal((2, n, k, 2)).astype(np.float32)
    dc = rng.standard_normal((2, n, k, 2)).astype(np.float32)
    if masked:
        idx[:, :, -3:] = np.arange(n)[None, :, None]
        gc[:, :, -3:] = 0.0
        dc[:, :, -3:] = 0.0
    args = [torch.from_numpy(a).to(cuda) for a in (idx, gc, dc)]
    got = ops.densify_coefs(*args, torch.bfloat16)
    want = ops.densify_coefs_plain(*args, torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("c", [3, 64, 300])
@pytest.mark.parametrize("sub_self", [False, True])
def test_gather_max_affine_kernel_exact(cuda, c, sub_self):
    rng = np.random.default_rng(12)
    n, k = 150, 9
    h = torch.randn((2, n, c), device=cuda).to(torch.bfloat16)
    idx, mask = _rand_graph(rng, n, k, cuda)
    inv = torch.randn(c, device=cuda)
    aff = (torch.where(inv >= 0, 1.0, -1.0), inv, torch.randn(c, device=cuda),
           torch.randn(c, device=cuda))
    got = ops.gather_max_affine(h, idx, mask, aff, sub_self)
    want = ops.gather_max_affine_plain(h, idx, mask, aff, sub_self)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert not got[0, 4].float().any()  # no valid neighbour: 0


def _mm_max_held(got, x, w, idx, mask):
    """A matmul max (bf16 ``got``, the max of ``x[idx_k] @ w`` over valid
    slots) held element by element: within one bf16 ulp of the plain
    version, or within the f32 summation bound ``C_in * 2^-24 * (|x| @
    |w|)`` (the largest over the row's valid slots) plus the bf16 rounding
    (half an ulp, at most ``2^-8 |got|``) of the exact max, an f64
    product. Near zero one bf16 ulp is finer than two f32 sums of the
    same terms in another order (the tensor cores', cuBLAS's) can agree:
    there the ulp bound alone fails on correct sums. Returns the outputs
    beyond one ulp as ``|exact| / max(|x| @ |w|)`` ratios, and the count
    of valid outputs."""
    ulps = _bf16_ulps(got, ops.gather_matmul_max_plain(x, w, idx, mask))
    xd, wd = x.double(), w.double()
    exact = ops.gather_max_plain(xd @ wd, idx, mask)
    mag = ops.gather_max_plain(xd.abs() @ wd.abs(), idx, mask)
    gd = got.double()
    tol = x.shape[-1] * 2.0 ** -24 * mag + 2.0 ** -8 * gd.abs()
    held = (ulps <= 1) | ((gd - exact).abs() <= tol)
    valid = mask.any(dim=-1, keepdim=True).expand_as(got)
    assert bool(held[valid].all()), (
        f"{int((~held & valid).sum())} elements beyond both bounds")
    far = (ulps > 1) & valid
    return (exact.abs() / mag)[far].tolist(), int(valid.sum())


@pytest.mark.parametrize("c_in,c_out", [(128, 256), (24, 40)])
def test_gather_matmul_max_kernel(cuda, c_in, c_out):
    """Within one bf16 ulp of the plain version, or near zero within the
    f32 summation bound of the exact max (``_mm_max_held``); bit-equal on
    inputs whose sums are exact in any order; the epilogue bit-equal to
    its replay on the kernel's own max. Inputs from a seeded generator."""
    rng = np.random.default_rng(13)
    gen = torch.Generator(device=cuda).manual_seed(13)
    n, k = 150, 9
    idx, mask = _rand_graph(rng, n, k, cuda)
    inv = torch.randn(c_out, device=cuda, generator=gen)
    aff = (torch.where(inv >= 0, 1.0, -1.0), inv,
           torch.randn(c_out, device=cuda, generator=gen),
           torch.randn(c_out, device=cuda, generator=gen))
    x = torch.randn((2, n, c_in), device=cuda, generator=gen).to(
        torch.bfloat16)
    w = (torch.randn((c_in, c_out), device=cuda, generator=gen) / 8).to(
        torch.bfloat16)
    raw = ops.gather_matmul_max(x, w, idx, mask)
    _mm_max_held(raw, x, w, idx, mask)
    assert bool((raw[0, 4].float() == torch.tensor(NEG).to(
        torch.bfloat16).float()).all())
    fused = ops.gather_matmul_max(x, w, idx, mask, aff)
    replay = ops.bn_lrelu_epilogue(raw.float(), aff,
                                   mask.any(dim=-1, keepdim=True))
    assert torch.equal(_bits(fused), _bits(replay))
    xe = (torch.randint(-32, 33, (2, n, c_in), device=cuda, generator=gen)
          / 8.0).to(torch.bfloat16)
    we = (torch.randint(-16, 17, (c_in, c_out), device=cuda, generator=gen)
          / 16.0).to(torch.bfloat16)
    for a in (None, aff):
        assert torch.equal(
            _bits(ops.gather_matmul_max(xe, we, idx, mask, a)),
            _bits(ops.gather_matmul_max_plain(xe, we, idx, mask, a)))


@pytest.mark.parametrize("quantized", [False, True])
def test_matmul_max_seed_sweep(cuda, quantized):
    """Both matmul maxes over 200 seeds at the shapes of
    ``test_gather_matmul_max_kernel[128-256]`` (x ~ N(0, 1), w ~ N(0,
    1/64) in bf16; ``quantized``: x through ``int8_quantize`` into
    ``gather_matmul_max_int8``), each held by ``_mm_max_held``. Every
    output more than one bf16 ulp from the plain version is a max near
    zero: within 1e-4 of its row's ``max(|x| @ |w|)``, where the f32 sums
    of the tensor cores and of cuBLAS may disagree by more than an ulp.
    Prints the counts (``pytest -s``)."""
    n, k, c_in, c_out = 150, 9, 128, 256
    ratios, outputs, seeds = [], 0, []
    for seed in range(200):
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=cuda).manual_seed(seed)
        idx, mask = _rand_graph(rng, n, k, cuda)
        x = torch.randn((2, n, c_in), device=cuda, generator=gen)
        w = (torch.randn((c_in, c_out), device=cuda, generator=gen) / 8).to(
            torch.bfloat16)
        if quantized:
            x, _ = ops.int8_quantize(x)
            got = ops.gather_matmul_max_int8(x, w, idx, mask)
        else:
            x = x.to(torch.bfloat16)
            got = ops.gather_matmul_max(x, w, idx, mask)
        far, valid = _mm_max_held(got, x, w, idx, mask)
        ratios += far
        outputs += valid
        seeds += [seed] if far else []
    print(f"\n{'gather_matmul_max_int8' if quantized else 'gather_matmul_max'}"
          f": {len(ratios)} of {outputs} outputs beyond one bf16 ulp, in "
          f"{len(seeds)} of 200 seeds, largest |exact| / max(|x| @ |w|) "
          f"{max(ratios, default=0.0)}")
    assert max(ratios, default=0.0) <= 1e-4


def test_bf16_model_kernels_match_plain(cuda):
    """The narrow model at the production config (approximate kNN, bf16)
    served through the kernels and through the plain versions on the
    card, uniform and ragged; every kernel of the path is launched."""
    rng = np.random.default_rng(14)
    model = DeltaNetClassification(
        5, conv_channels=(8, 16, 16, 136), embedding_size=32,
        num_neighbors=8, knn_method="approx",
        generator=torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, num_points=128, batch_size=4,
                             precision="bfloat16")
    plain = InferenceEngine(model, num_points=128, batch_size=4,
                            precision="bfloat16", ops=PLAIN_OPS)
    pos, nrm = _cloud_batch(rng, 5, 128, "cpu")
    for sizes in ([128] * 5, [128, 128, 90, 128, 60]):
        clouds = [p[:s].numpy() for p, s in zip(pos, sizes)]
        normals = [q[:s].numpy() for q, s in zip(nrm, sizes)]
        reset_launch_counts()
        got = engine.predict(clouds, normals)
        counts = launch_counts()
        want = plain.predict(clouds, normals)
        np.testing.assert_allclose(got, want,
                                   atol=1e-2 * float(np.abs(want).max()))
    assert all(counts[name] > 0 for name in
               ("densify_bf16", "gather_max_affine", "gather_matmul_max"))
    reset_launch_counts()
    engine.predict([p.numpy() for p in pos], [q.numpy() for q in nrm])
    assert launch_counts()["knn_topk"] > 0


@pytest.mark.parametrize("precision", [None, "bfloat16"])
def test_model_without_normals_kernels_match_plain(cuda, precision):
    """The narrow model on clouds without normals (frames estimated on a
    10-NN graph), served through the kernels and through the plain
    versions on the card, uniform and ragged; a uniform approximate
    forward launches knn_topk twice (the K=8 graph and the normal
    graph)."""
    rng = np.random.default_rng(16)
    model = DeltaNetClassification(
        5, conv_channels=(8, 16, 16, 136), embedding_size=32,
        num_neighbors=8, knn_method="approx",
        generator=torch.Generator().manual_seed(0))
    kw = dict(num_points=128, batch_size=4, precision=precision)
    engine = InferenceEngine(model, **kw)
    plain = InferenceEngine(model, ops=PLAIN_OPS, **kw)
    pos, _ = _cloud_batch(rng, 4, 128, "cpu")
    for sizes in ([128] * 4, [128, 90, 128, 60]):
        clouds = [p[:s].numpy() for p, s in zip(pos, sizes)]
        reset_launch_counts()
        got = engine.predict(clouds)
        counts = launch_counts()
        want = plain.predict(clouds)
        assert np.isfinite(got).all()
        rel = 1e-3 if precision is None else 1e-2
        np.testing.assert_allclose(got, want,
                                   atol=rel * float(np.abs(want).max()))
        assert counts["knn_topk"] == (2 if sizes[1] == 128 else 0)
        assert counts["wls"] == 1 and counts["gather_rows"] > 0


# -- the bf16 train slice -------------------------------------------------------


@pytest.mark.parametrize("c", [3, 64, 300])
def test_gather_max_win_bf16_and_bwd_kernels(cuda, c):
    """bf16 in, bf16 out: values and winners equal (ties from repeated
    indices and coarse values included; odd C takes the one-channel
    loads), values as numbers: where +0 and -0 tie the kernel keeps the
    first slot's and the plain ``amax`` either; the bf16-cotangent
    scatter bit-equal to the plain version and across two calls."""
    rng = np.random.default_rng(15)
    n, k = 150, 9
    h = torch.from_numpy(np.round(rng.standard_normal((2, n, c)) * 8).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    idx, mask = _rand_graph(rng, n, k, cuda)
    out, win = ops.gather_max_win(h, idx, mask)
    out_p, win_p = ops.gather_max_win_plain(h, idx, mask)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, out_p), int((out != out_p).sum())
    assert torch.equal(win, win_p), int((win != win_p).sum())
    assert not win[0, 4].any()
    g = torch.randn((2, n, c), device=cuda).to(torch.bfloat16)
    _bwd_exact(ops.gather_max_bwd, ops.gather_max_bwd_plain,
               (idx, win, g, n))


@pytest.mark.parametrize("c_in,c_out", [(128, 256), (24, 40)])
def test_gather_matmul_max_win_kernel(cuda, c_in, c_out):
    """Bit-equal values and winners on inputs whose sums are exact in any
    order; on random inputs within one bf16 ulp, and a winner that
    differs only where the plain products at the two slots are within
    two ulps (each product may sit one ulp off); -3e38 and winner 0
    where no slot is valid."""
    rng = np.random.default_rng(16)
    gen = torch.Generator(device=cuda).manual_seed(16)
    n, k = 150, 9
    idx, mask = _rand_graph(rng, n, k, cuda)
    xe = (torch.randint(-32, 33, (2, n, c_in), device=cuda) / 8.0).to(
        torch.bfloat16)
    we = (torch.randint(-16, 17, (c_in, c_out), device=cuda) / 16.0).to(
        torch.bfloat16)
    out, win = ops.gather_matmul_max_win(xe, we, idx, mask)
    out_p, win_p = ops.gather_matmul_max_win_plain(xe, we, idx, mask)
    assert torch.equal(out, out_p), int((out != out_p).sum())
    assert torch.equal(win, win_p), int((win != win_p).sum())
    x = torch.randn((2, n, c_in), device=cuda, generator=gen).to(
        torch.bfloat16)
    w = (torch.randn((c_in, c_out), device=cuda, generator=gen) / 8).to(
        torch.bfloat16)
    out, win = ops.gather_matmul_max_win(x, w, idx, mask)
    out_p, win_p = ops.gather_matmul_max_win_plain(x, w, idx, mask)
    torch.cuda.synchronize()
    assert int(_bf16_ulps(out, out_p).max()) <= 1
    y = torch.matmul(x.float(), w.float()).to(torch.bfloat16)
    rows = torch.gather(idx.long(), 2, win.long())  # the kernel's winners
    rows_p = torch.gather(idx.long(), 2, win_p.long())
    at = torch.gather(y, 1, rows)
    at_p = torch.gather(y, 1, rows_p)
    assert int(_bf16_ulps(at, at_p).max()) <= 2
    assert bool((out[0, 4].float() == torch.tensor(NEG).to(
        torch.bfloat16).float()).all())
    assert not win[0, 4].any()


_GM = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")


def _mm_exact(rng, b, n, c_in, c_out, dev):
    """bf16 inputs whose products and sums are exact in f32 in any order
    (x in steps of 1/8 up to 4, w in steps of 1/16 up to 1)."""
    x = torch.from_numpy(rng.integers(-32, 33, (b, n, c_in)) / 8.0)
    w = torch.from_numpy(rng.integers(-16, 17, (c_in, c_out)) / 16.0)
    return (x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16))


def _mm_random(rng, b, n, c_in, c_out, dev):
    x = torch.from_numpy(rng.standard_normal((b, n, c_in)).astype(np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((c_in, c_out)) / 8).astype(np.float32))
    return x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16)


def _mm_graph(rng, b, n, k, dev):
    """Random neighbours, 30% masked, and rows with no valid slot: point 4
    of the first cloud and the last point of every cloud."""
    idx = torch.from_numpy(
        rng.integers(0, n, (b, n, k)).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((b, n, k)) > 0.3).to(dev)
    mask[0, 4] = False
    mask[:, -1] = False
    return idx, mask


def _win_held(out, win, win_p, x, w, idx, mask):
    """The train form on random inputs, held as ``_mm_max_held`` holds the
    eval form (its values are the bf16-rounded max: rounding is
    monotone): values within one bf16 ulp of the plain version or, near
    zero, within the f32 summation bound of the exact max; where a winner
    differs from the plain version's, the exact (f64) products at the two
    slots within the summation bounds of both plus one bf16 ulp of the
    larger (two f32 sums in another order may rank them either way)."""
    _mm_max_held(out, x, w, idx, mask)
    xd, wd = x.double(), w.double()
    y, mag = xd @ wd, xd.abs() @ wd.abs()

    def at(t, winner):
        return torch.gather(t, 1, torch.gather(idx.long(), 2, winner.long()))

    flip = win != win_p
    a, a_p = at(y, win)[flip], at(y, win_p)[flip]
    tol = (x.shape[-1] * 2.0 ** -24 * (at(mag, win) + at(mag, win_p))[flip]
           + 2.0 ** -7 * torch.maximum(a.abs(), a_p.abs()))
    assert bool(((a - a_p).abs() <= tol).all())


def _mm_both(x, w, idx, mask, aff, cs):
    """Both bf16 matmul maxes through the route of column slice ``cs``
    (0: the K-fold kernels), with the launches they made."""
    reset_launch_counts()
    raw = _GM._gather_matmul_max(x, w, idx, mask, None, cs)
    fused = _GM._gather_matmul_max(x, w, idx, mask, aff, cs)
    out, win = _GM._gather_matmul_max_win(x, w, idx, mask, cs)
    torch.cuda.synchronize()
    return raw, fused, out, win, launch_counts()


def _route_launched(counts, cs):
    """The eval form twice and the train form once, on ``cs``'s route."""
    sfx = "" if cs else "_kfold"
    other = "_kfold" if cs else ""
    assert counts[f"gather_matmul_max{sfx}"] == 2, counts
    assert counts[f"gather_matmul_max_win{sfx}"] == 1, counts
    assert counts[f"gather_matmul_max{other}"] == 0, counts
    assert counts[f"gather_matmul_max_win{other}"] == 0, counts


@pytest.mark.parametrize("n", [150, 1000])
@pytest.mark.parametrize("c_in,c_out,cs", [
    (128, 256, 64), (128, 256, 32), (128, 256, 16), (128, 256, 8),
    (128, 256, 0), (24, 40, 16), (24, 40, 8), (24, 40, 0), (200, 256, 32),
    (200, 40, 8)])
def test_matmul_max_routes(cuda, n, c_in, c_out, cs):
    """Both bf16 matmul maxes through each route (every column slice of
    the one-product-a-row kernels, and the K-fold kernels) at ragged N
    (not a multiple of the 128-row tile), C_out = 40 zero-padded to 48,
    C_in = 200 (padded to 208: 13 k-steps, above the 8 whose B fragments
    the kernel keeps in registers), rows with no valid slot: on
    exact-sum inputs values, winners and the
    epilogue bit-equal to the plain versions; on random inputs held as
    ``test_gather_matmul_max_kernel`` and
    ``test_gather_matmul_max_win_kernel`` hold them; the launches show the
    route."""
    rng = np.random.default_rng(30 + n + cs)
    b, k = 2, 9
    idx, mask = _mm_graph(rng, b, n, k, cuda)
    aff = tuple(torch.from_numpy(a).to(cuda) for a in (
        np.where(rng.standard_normal(c_out) >= 0, 1.0, -1.0).astype(
            np.float32),
        rng.standard_normal(c_out).astype(np.float32),
        rng.standard_normal(c_out).astype(np.float32),
        rng.standard_normal(c_out).astype(np.float32)))
    x, w = _mm_exact(rng, b, n, c_in, c_out, cuda)
    raw, fused, out, win, counts = _mm_both(x, w, idx, mask, aff, cs)
    _route_launched(counts, cs)
    assert torch.equal(_bits(raw), _bits(ops.gather_matmul_max_plain(
        x, w, idx, mask)))
    assert torch.equal(_bits(fused), _bits(ops.gather_matmul_max_plain(
        x, w, idx, mask, aff)))
    out_p, win_p = ops.gather_matmul_max_win_plain(x, w, idx, mask)
    assert torch.equal(_bits(out), _bits(out_p))
    assert torch.equal(win, win_p), int((win != win_p).sum())
    neg = torch.tensor(NEG).to(torch.bfloat16).float()
    for r in (raw, out):
        assert bool((r[0, 4].float() == neg).all())
        assert bool((r[:, -1].float() == neg).all())
    assert not win[:, -1].any() and not fused[:, -1].float().any()

    x, w = _mm_random(rng, b, n, c_in, c_out, cuda)
    raw, fused, out, win, _ = _mm_both(x, w, idx, mask, aff, cs)
    _mm_max_held(raw, x, w, idx, mask)
    assert torch.equal(_bits(fused), _bits(ops.bn_lrelu_epilogue(
        raw.float(), aff, mask.any(dim=-1, keepdim=True))))
    _win_held(out, win, ops.gather_matmul_max_win_plain(x, w, idx, mask)[1],
              x, w, idx, mask)


@pytest.mark.parametrize("cs", [64, 8, 0])
def test_matmul_max_routes_nan(cuda, cs):
    """A NaN in x (row 7 of the first cloud: a NaN row of y) takes the
    NaN rules of the slower max: the max is NaN wherever a valid slot
    gathers that row, the winner there the plain version's (0), and every
    other value and winner bit-equal on exact-sum inputs."""
    rng = np.random.default_rng(41)
    b, n, k, c_in, c_out = 2, 150, 9, 128, 256
    idx, mask = _mm_graph(rng, b, n, k, cuda)
    x, w = _mm_exact(rng, b, n, c_in, c_out, cuda)
    x[0, 7, 5] = float("nan")
    raw, _, out, win, counts = _mm_both(x, w, idx, mask, None, cs)
    _route_launched(counts, cs)
    raw_p = ops.gather_matmul_max_plain(x, w, idx, mask)
    out_p, win_p = ops.gather_matmul_max_win_plain(x, w, idx, mask)
    hit = ((idx[0] == 7) & mask[0]).any(dim=-1)
    assert bool(hit.any())
    for got, want in ((raw, raw_p), (out, out_p)):
        nan = torch.isnan(got.float())
        assert torch.equal(nan, torch.isnan(want.float()))
        assert bool(nan[0][hit].all()) and int(nan[0][~hit].sum()) == 0
        assert not nan[1].any()
        assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])
    assert torch.equal(win, win_p), int((win != win_p).sum())


@pytest.mark.parametrize("b,n", [(32, 1024), (4, 8192)])
def test_matmul_max_model_shapes(cuda, b, n):
    """The model shapes, 128 -> 256, K=20 (classification conv3 at B=32,
    N=1024; the large clouds at B=4, N=8192): the route by shape is the
    one-product-a-row kernels (no K-fold launch), and the K-fold route
    gives the same bits: exact-sum inputs bit-equal to the plain
    versions, random inputs held by ``_mm_max_held`` and ``_win_held``
    and bit-equal across the two routes."""
    rng = np.random.default_rng(b + n)
    k, c_in, c_out = 20, 128, 256
    assert _GM.mm_slice(b, n, c_in, c_out, k, 132) == (64 if n == 1024
                                                       else 8)
    idx, mask = _mm_graph(rng, b, n, k, cuda)
    aff = (torch.ones(c_out, device=cuda),
           torch.full((c_out,), 0.5, device=cuda),
           torch.zeros(c_out, device=cuda), torch.zeros(c_out, device=cuda))
    x, w = _mm_exact(rng, b, n, c_in, c_out, cuda)
    want = (ops.gather_matmul_max_plain(x, w, idx, mask),
            ops.gather_matmul_max_plain(x, w, idx, mask, aff),
            *ops.gather_matmul_max_win_plain(x, w, idx, mask))
    for cs in (None, 0):
        *got, counts = _mm_both(x, w, idx, mask, aff, cs)
        _route_launched(counts, cs is None)
        for g, v in zip(got, want):
            assert torch.equal(g.view(torch.int16) if g.dtype ==
                               torch.bfloat16 else g,
                               v.view(torch.int16) if v.dtype ==
                               torch.bfloat16 else v)
    x, w = _mm_random(rng, b, n, c_in, c_out, cuda)
    got = _mm_both(x, w, idx, mask, aff, None)[:4]
    raw, _, out, win = got
    _mm_max_held(raw, x, w, idx, mask)
    _win_held(out, win, ops.gather_matmul_max_win_plain(x, w, idx, mask)[1],
              x, w, idx, mask)
    # The two routes run the same tensor-core sums in the same order (k in
    # steps of 16 from zero): the same bits on random inputs too.
    for g, v in zip(got, _mm_both(x, w, idx, mask, aff, 0)[:4]):
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16
                           else g, v.view(torch.int16) if v.dtype ==
                           torch.bfloat16 else v)


def test_matmul_max_above_the_rows_limit(cuda):
    """One cloud above the one-product-a-row kernels' limit (10,038
    points at C_in = 128, where an 8-column slice of y no longer fits a
    block beside two ring stages): the wrappers, and
    ``gather_matmul_max_train`` with its backward, take the K-fold route,
    bit-equal to the plain versions on exact-sum inputs."""
    rng = np.random.default_rng(43)
    b, n, k, c_in, c_out = 1, 10100, 20, 128, 256
    assert _GM.mm_slice(b, n, c_in, c_out, k, 132) == 0
    assert _GM.mm_slice(b, 10038, c_in, c_out, k, 132) == 8
    assert _GM.mm_slice(b, 10039, c_in, c_out, k, 132) == 0
    idx, mask = _mm_graph(rng, b, n, k, cuda)
    x, w = _mm_exact(rng, b, n, c_in, c_out, cuda)
    reset_launch_counts()
    raw = ops.gather_matmul_max(x, w, idx, mask)
    out, win = ops.gather_matmul_max_win(x, w, idx, mask)
    xg = x.clone().requires_grad_()
    ops.gather_matmul_max_train(xg, w, idx, mask).float().sum().backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["gather_matmul_max_kfold"] == 1, counts
    assert counts["gather_matmul_max_win_kfold"] == 2, counts
    assert counts["gather_matmul_max"] == counts[
        "gather_matmul_max_win"] == 0, counts
    assert counts["gather_max_bwd_bf16"] == 1, counts
    assert torch.equal(_bits(raw), _bits(ops.gather_matmul_max_plain(
        x, w, idx, mask)))
    out_p, win_p = ops.gather_matmul_max_win_plain(x, w, idx, mask)
    assert torch.equal(_bits(out), _bits(out_p))
    assert torch.equal(win, win_p)


def test_bf16_autograd_round_trip_launches(cuda):
    """The differentiable bf16 maxes and dense applies on the card: each
    forward and backward launches its kernel once, and the gradients
    equal those of the plain route (same winners: exact inputs)."""
    rng = np.random.default_rng(17)
    n, k = 96, 8
    idx, mask = _rand_graph(rng, n, k, cuda)
    h = torch.randn((2, n, 64), device=cuda).to(torch.bfloat16)
    x = (torch.randint(-32, 33, (2, n, 32), device=cuda) / 8.0).to(
        torch.bfloat16)
    w = (torch.randint(-16, 17, (32, 48), device=cuda) / 16.0).to(
        torch.bfloat16)
    g = torch.randn((2, n, 64), device=cuda).to(torch.bfloat16)
    g2 = torch.randn((2, n, 48), device=cuda).to(torch.bfloat16)
    grads = []
    for maxed, mm in ((ops.gather_max, ops.gather_matmul_max_train),
                      (ops.gather_max_plain,
                       ops.gather_matmul_max_train_plain)):
        reset_launch_counts()
        hg = h.clone().requires_grad_()
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        ((maxed(hg, idx, mask).float() * g.float()).sum()
         + (mm(xg, wg, idx, mask).float() * g2.float()).sum()).backward()
        grads.append((hg.grad, xg.grad, wg.grad))
        counts = launch_counts()
        if maxed is ops.gather_max:
            assert counts["gather_max_win_bf16"] == 1, counts
            assert counts["gather_matmul_max_win"] == 1, counts
            assert counts["gather_matmul_max_win_kfold"] == 0, counts
            # The backward is unchanged: the winner-routed scatter at
            # C_out (one launch for each max) and two torch matmuls.
            assert counts["gather_max_bwd_bf16"] == 2, counts
            assert sum(counts.values()) == 4, counts
        else:
            assert sum(counts.values()) == 0, counts
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16
        _close_to_max(got.float(), want.float(), 2.0 ** -8)

    pos, nrm = _cloud_batch(rng, 2, 128, cuda)
    gd = build_operators(pos, 8, nrm, operator_dtype="bfloat16")
    gd_cpu = dataclasses.replace(
        gd, nbr_idx=gd.nbr_idx.cpu(), nbr_mask=gd.nbr_mask.cpu(),
        w_grad=gd.w_grad.cpu(), w_div=gd.w_div.cpu())
    v = torch.randn((2, 128, 2, 16), device=cuda).to(torch.bfloat16)
    ct = torch.randn((2, 128, 16), device=cuda).to(torch.bfloat16)
    outs = []
    for op, vv, cc in ((gd, v, ct), (gd_cpu, v.cpu(), ct.cpu())):
        vg = vv.clone().requires_grad_()
        out = op.div(vg)
        out.backward(cc)
        outs.append((out.float().cpu(), vg.grad.float().cpu()))
    for got, want in zip(*outs):  # f32 sums over N in another order
        _close_to_max(got, want, 2.0 ** -8)


def _bf16_step(batch, ops_, seed=0):
    model = DeltaNetClassification(
        5, conv_channels=(8, 136, 272), embedding_size=32, num_neighbors=8,
        dropout=0.0, compute_dtype="bfloat16", operator_dtype="bfloat16",
        knn_method="approx", generator=torch.Generator().manual_seed(seed))
    model = model.to(batch["pos"].device)
    state = create_train_state(model, sgd_momentum(0.01))
    loss = float(make_train_step(model, ops=ops_)(state, batch, None)["loss"])
    return loss, model


@pytest.mark.parametrize("ragged", [False, True])
def test_bf16_train_step_kernels_match_plain(cuda, ragged):
    """One narrow bf16 train step (approximate kNN, every PointMaxMLP
    lane-narrower) through the kernels and through the plain versions on
    the card: every kernel of the path is launched, the losses agree to
    1e-3, the running statistics to 1e-2 x max (measured up to 1.7e-3:
    a one-ulp difference in a bf16 activation moves the 4-row head
    BatchNorm's statistics), and the gradients are finite (winner flips
    at bf16 near-ties move single entries)."""
    rng = np.random.default_rng(18)
    pos, nrm = _cloud_batch(rng, 4, 128, cuda)
    batch = {"pos": pos, "normal": nrm,
             "label": torch.tensor([0, 1, 2, 3], device=cuda)}
    if ragged:
        batch["point_mask"] = torch.arange(128, device=cuda)[None, :] < (
            torch.tensor([[128], [90], [128], [60]], device=cuda))
    reset_launch_counts()
    loss_k, model_k = _bf16_step(batch, KERNEL_OPS)
    counts = launch_counts()
    loss_p, model_p = _bf16_step(batch, PLAIN_OPS)
    used = ["gather_rows", "wls", "densify_bf16", "adjacency",
            "gather_max_win_bf16", "gather_max_bwd_bf16",
            "gather_matmul_max_win"] + ([] if ragged else ["knn_topk"])
    assert all(counts[name] > 0 for name in used), counts
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    for p in model_k.parameters():
        assert p.dtype == torch.float32 and bool(p.grad.isfinite().all())
    bufs_p = dict(model_p.named_buffers())
    for name, b in model_k.named_buffers():
        _close_to_max(b, bufs_p[name], 1e-2)


# -- the segmentation serving slice ---------------------------------------------


@pytest.mark.parametrize("c", [3, 64, 300])
def test_gather_max_bf16_kernel_exact(cuda, c):
    """The bf16 max without winners: the values of the plain version (a
    bf16 max is lossless; +0 and -0 tie), and no winner kernel runs."""
    rng = np.random.default_rng(19)
    h = torch.randn((2, 150, c), device=cuda).to(torch.bfloat16)
    idx, mask = _rand_graph(rng, 150, 9, cuda)
    reset_launch_counts()
    got = ops.gather_max(h, idx, mask)
    counts = launch_counts()
    want = ops.gather_max_plain(h, idx, mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), want.float())
    assert counts["gather_max_bf16"] == 1 and counts["gather_max_win_bf16"] == 0


def _mlp_case(rng, widths, n, dev, exact=False):
    """Inputs of gather_mlp_max: bf16 x, weights, intermediate affines,
    an epilogue. ``exact``: x and the weights on coarse grids and the
    affine ``y + 64`` (no negative slope is taken), so that every sum of
    a two-layer MLP is exact in f32 in any order."""
    def draw(shape, scale, grid):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        a = a * scale
        return (torch.round(a * grid) / grid if exact else a).to(dev)

    x = draw((2, n, widths[0]), 1.0, 8).to(torch.bfloat16)
    ws = [draw((a, b), 1 / np.sqrt(a), 16) for a, b in
          zip(widths[:-1], widths[1:])]
    affines = [(torch.ones(c, device=dev), torch.full((c,), 64.0, device=dev))
               if exact else (draw(c, 1.0, 4), draw(c, 0.2, 16))
               for c in widths[1:-1]]
    inv = torch.randn(widths[-1], device=dev)
    epi = (torch.where(inv >= 0, 1.0, -1.0), inv,
           torch.randn(widths[-1], device=dev) * 0.2,
           torch.randn(widths[-1], device=dev) * 0.2)
    return x, ws, affines, epi


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("widths,centralized", [
    ((3, 64, 64), True), ((128, 256, 256), False), ((24, 40, 16, 8), False),
    ((5, 24), True), ((24, 40, 16, 8), True), ((12, 136), False),
    ((3, 64, 72), True), ((3, 200, 200), True)],
    ids=["conv0", "conv2", "three-layers", "centralized-one-layer",
         "centralized-three-layers", "one-layer", "centralized-two-rounds",
         "centralized-wide"])
def test_gather_mlp_max_kernel(cuda, widths, centralized, masked):
    """At the segmentation convs' widths, and at depths 1 and 3 with
    widths that are not multiples of 16 (a centralized last layer wider
    than one register round of 64 columns, and one whose packed weights,
    93 KB, are read from L2 instead of shared memory): the best values equal
    to the plain version's on >= 99% of the elements and within 1e-2 x
    max on all (the tensor cores sum in another order, and a one-ulp
    product carries through the next layer); bit-equal on two-layer
    inputs whose sums are exact in any order; the self slot and the
    epilogue bit-equal to their replay on the kernel's own best values.
    B N = 300 is not a multiple of a warp's 16 points or 32 rows; the
    masked graph has rows with no valid slot. Centralized calls run the
    fused kernel, the others ``mlp_rows`` and ``gather_max_merge``."""
    rng = np.random.default_rng(20)
    n, k = 150, 9
    pos, _ = _cloud_batch(rng, 2, n, cuda)
    idx, mask = _graph(pos, k, masked)
    x, ws, affines, epi = _mlp_case(rng, widths, n, cuda)
    args = (x, ws, affines, idx, mask, centralized)
    reset_launch_counts()
    raw = ops.gather_mlp_max(*args, False)
    counts = launch_counts()
    raw_p = ops.gather_mlp_max_plain(*args, False)
    torch.cuda.synchronize()
    assert counts["gather_mlp_max"] == int(centralized)
    assert counts["mlp_rows"] == counts["gather_max_merge"] == int(
        not centralized)
    live = raw_p > NEG / 2  # rows with a valid slot
    assert torch.equal(raw > NEG / 2, live)
    assert float((raw != raw_p).float().mean()) <= 0.01
    _close_to_max(raw[live], raw_p[live], 1e-2)
    if masked:
        assert bool((raw[0, n // 2:] == NEG).all())
    z0 = (ops.mlp_chain(torch.zeros((1, widths[0]), device=cuda), ws,
                        affines)[0]
          if centralized else ops.mlp_chain(x, ws, affines))
    best = ops.gather_mlp_max(*args, True)
    z0b = z0.expand_as(best) if centralized else z0
    merged = torch.maximum(best, torch.where(mask[..., :1], z0b, NEG))
    assert torch.equal(ops.gather_mlp_max(*args, True, z0), merged)
    o = (epi[0] * merged - epi[2]) * epi[1] + epi[3]
    o = torch.where(mask.any(dim=-1, keepdim=True),
                    torch.where(o >= 0, o, 0.2 * o), 0.0)
    fused = ops.gather_mlp_max(*args, True, z0, epi)
    assert torch.equal(_bits(fused), _bits(o.to(torch.bfloat16)))
    if len(widths) != 3:
        return
    xe, we, ae, _ = _mlp_case(rng, widths, n, cuda, exact=True)
    for z, e in ((None, None), (z0, epi)):
        got = ops.gather_mlp_max(xe, we, ae, idx, mask, centralized, True, z,
                                 e)
        want = ops.gather_mlp_max_plain(xe, we, ae, idx, mask, centralized,
                                        True, z, e)
        assert torch.equal(got.float(), want.float())


@pytest.mark.parametrize("widths", [(24, 40), (128, 256, 256),
                                    (24, 40, 16, 8), (3, 64, 64)],
                         ids=["one-layer", "conv2", "three-layers", "conv0"])
def test_mlp_rows_kernel(cuda, widths):
    """The MLP of every row (300 rows: not a multiple of a warp's 32)
    against the plain chain: equal on >= 99% of the outputs and within
    1e-2 x max on all (the tensor cores' sum order, carried through the
    next layer); bit-equal on inputs whose sums are exact in any
    order."""
    rng = np.random.default_rng(22)
    x, ws, affines, _ = _mlp_case(rng, widths, 150, cuda)
    reset_launch_counts()
    got = ops.mlp_rows(x, ws, affines)
    assert launch_counts()["mlp_rows"] == 1
    want = ops.mlp_rows_plain(x, ws, affines)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert float((got != want).float().mean()) <= 0.01
    _close_to_max(got.float(), want.float(), 1e-2)
    if len(widths) == 3:
        xe, we, ae, _ = _mlp_case(rng, widths, 150, cuda, exact=True)
        assert _bits(ops.mlp_rows(xe, we, ae)).equal(
            _bits(ops.mlp_rows_plain(xe, we, ae)))


@pytest.mark.parametrize("c", [24, 64, 256, 520])
@pytest.mark.parametrize("k0,z0_kind,epilogue", [
    (0, None, False), (1, None, False), (1, "row", False), (1, "rows", True),
    (0, "rows", False), (1, "row", True), (1, "bf16-rows", True)])
def test_gather_max_merge_kernel_exact(cuda, c, k0, z0_kind, epilogue):
    """The masked max of bf16 rows with the self slot and the epilogue:
    bit-equal to the plain version, covered slots from k0 = 0 or 1, z0
    none, a [C] f32 row or [B, N, C] bf16 rows, with and without the
    epilogue; C = 24 (padded to 8s), 64 (4 points a warp), 256 (a warp a
    point), 520 (two passes of 256 channels); a masked graph with rows
    that have no valid slot, B N = 300. The self rows come in f32 (the
    kernel rounds them to bf16) or bf16."""
    rng = np.random.default_rng(23)
    n, k = 150, 9
    pos, _ = _cloud_batch(rng, 2, n, cuda)
    idx, mask = _graph(pos, k, True)
    mask[1, :7, 0] = False  # rows whose self slot is masked
    rows = torch.randn((2, n, c), device=cuda).to(torch.bfloat16)
    z0 = {None: None, "row": torch.randn(c, device=cuda),
          "rows": torch.randn((2, n, c), device=cuda),
          "bf16-rows": torch.randn((2, n, c), device=cuda).to(
              torch.bfloat16)}[z0_kind]
    epi = None
    if epilogue:
        inv = torch.randn(c, device=cuda)
        epi = (torch.where(inv >= 0, 1.0, -1.0), inv,
               torch.randn(c, device=cuda) * 0.2,
               torch.randn(c, device=cuda) * 0.2)
    reset_launch_counts()
    got = ops.gather_max_merge(rows, idx, mask, k0, z0, epi)
    assert launch_counts()["gather_max_merge"] == 1
    want = ops.gather_max_merge_plain(rows, idx, mask, k0, z0, epi)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == (2, n, c)
    assert _bits(got).equal(_bits(want)) if epilogue else torch.equal(
        got, want)
    if not epilogue and z0 is None:
        assert bool((got[0, n // 2:] == NEG).all())


def test_seg_model_kernels_match_plain(cuda):
    """A narrow segmentation model with categories served in f32 and at
    the production config through the kernels and through the plain
    versions on the card, uniform and ragged; every kernel of the bf16
    path is launched: gather_mlp_max once a forward (the centralized first
    conv), mlp_rows and gather_max_merge once (the last)."""
    rng = np.random.default_rng(21)
    model = DeltaNetSegmentation(
        6, conv_channels=(8, 16, 136), embedding_size=32, num_neighbors=8,
        categorical_vector=True, knn_method="approx",
        generator=torch.Generator().manual_seed(0))
    pos, nrm = _cloud_batch(rng, 5, 128, "cpu")
    cats = [0, 3, 15, 7, 1]
    for precision, rel in ((None, 1e-4), ("bfloat16", 1e-2)):
        engine = InferenceEngine(model, num_points=128, batch_size=4,
                                 precision=precision)
        plain = InferenceEngine(model, num_points=128, batch_size=4,
                                precision=precision, ops=PLAIN_OPS)
        for sizes in ([128] * 5, [128, 128, 90, 128, 60]):
            clouds = [p[:s].numpy() for p, s in zip(pos, sizes)]
            normals = [q[:s].numpy() for q, s in zip(nrm, sizes)]
            reset_launch_counts()
            got = engine.predict(clouds, normals, categories=cats)
            counts = launch_counts()
            want = plain.predict(clouds, normals, categories=cats)
            assert [g.shape for g in got] == [(s, 6) for s in sizes]
            got, want = np.concatenate(got), np.concatenate(want)
            np.testing.assert_allclose(got, want,
                                       atol=rel * float(np.abs(want).max()))
            if precision:
                for name in ("gather_mlp_max", "mlp_rows",
                             "gather_max_merge"):
                    assert counts[name] == 2  # 2 batches
                assert counts["gather_max_bf16"] > 0


# -- the int8 serving slice ---------------------------------------------------


def _knn_like(rng, n, k, masked, b=2):
    """Neighbour lists of ``b`` clouds as the kNN makes them: self in
    slot 0, distinct columns; ``masked`` clamps the last 3 slots of every
    row to self (their coefficients are zero)."""
    idx = np.stack([np.stack([np.concatenate(
        [[i], rng.permutation(np.delete(np.arange(n), i))[:k - 1]])
        for i in range(n)]) for _ in range(b)]).astype(np.int32)
    if masked:
        idx[:, :, -3:] = np.arange(n)[None, :, None]
    return idx


def _int8_coefs(rng, b, n, k, masked, zero_cloud=False):
    """Coefficients for ``densify_int8``: cloud 0's grad scale 128 (so
    ``p / 128 * 127`` is exact and +-64 lands on the ties +-63.5); the
    last 3 slots zero where ``masked`` (clamped padded slots); with
    ``zero_cloud`` the last cloud's div coefficients all zero (its scale
    the 1e-30 floor), the others' random."""
    gc = rng.standard_normal((b, n, k, 2)).astype(np.float32)
    dc = rng.standard_normal((b, n, k, 2)).astype(np.float32)
    gc[0] = np.clip(gc[0], -100.0, 100.0)
    gc[0, 0, 0, 0] = 128.0
    gc[0, 1, 1:3, 0] = (64.0, -64.0)
    if masked:
        gc[:, :, -3:] = 0.0
        dc[:, :, -3:] = 0.0
    if zero_cloud:
        dc[-1] = 0.0
    return gc, dc


@pytest.mark.parametrize("n,k,masked", [(96, 8, False), (102, 8, True),
                                         (128, 8, True), (1024, 20, True),
                                         (2048, 30, True), (77, 30, False)])
def test_densify_int8_kernel_exact(cuda, n, k, masked):
    """Bit-equal planes and equal scales, across two calls too: the kernel
    quantizes as torch does (the division, then the product, rounded half
    to even; ties at +-63.5 included), adds a column's quantized values
    (a clamped padded slot adds 0), forms the scales from ``absmax``'s
    maxima (a third cloud's all-zero div coefficients at the 1e-30
    floor, beside two random clouds) and writes them as
    ``s / 127`` on the card. N=96, 128, 1024 and 2048 take whole 16-byte
    stores, N=102 and 77 also the bytes before and after each run's
    16-byte boundaries; N <= 1024 puts several rows in a block. Three
    launches: ``absmax`` twice, ``densify_int8`` once."""
    rng = np.random.default_rng(40)
    idx = _knn_like(rng, n, k, masked, b=3)
    gc, dc = _int8_coefs(rng, 3, n, k, masked, zero_cloud=True)
    args = [torch.from_numpy(a).to(cuda) for a in (idx, gc, dc)]
    reset_launch_counts()
    got = ops.densify_coefs_int8(*args)
    again = ops.densify_coefs_int8(*args)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["absmax"] == 4 and counts["densify_int8"] == 2, counts
    assert sum(counts.values()) == 6, counts
    want = ops.densify_coefs_int8_plain(*args)
    assert got[0].dtype == got[1].dtype == torch.int8
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, g)
    assert int(got[0][0, 0, 1, idx[0, 1, 1]]) == 64  # 63.5 to even
    assert int(got[0][0, 0, 1, idx[0, 1, 2]]) == -64
    assert not got[1][-1].any() and got[1][:-1].any()
    assert float(got[3][-1]) == float(torch.tensor([1e-30], device=cuda)
                                      / 127.0)


@pytest.mark.parametrize("n,k", [(8200, 4), (16411, 3)])
def test_densify_int8_kernel_wide_clouds(cuda, n, k):
    """Above the 8192-byte image a task builds one row in chunks of 8192
    columns (the last one short, N % 16 != 0 at 16,411): bit-equal to
    the plain version on random neighbour ids (duplicates in a row sum)
    and ids that land in every chunk."""
    rng = np.random.default_rng(n)
    idx = rng.integers(0, n, (1, n, k)).astype(np.int32)
    idx[0, :, 0] = np.arange(n)
    idx[0, :5, 1] = n - 1
    gc, dc = _int8_coefs(rng, 1, n, k, False)
    args = [torch.from_numpy(a).to(cuda) for a in (idx, gc, dc)]
    got = ops.densify_coefs_int8(*args)
    want = ops.densify_coefs_int8_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("c", [3, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_max_int8_kernel_exact(cuda, c, dtype):
    """Bit-equal to the plain version (the int max times the cloud's
    scale, one f32 rounding, then h's dtype); 0 on a row with no valid
    neighbour."""
    rng = np.random.default_rng(41)
    gen = torch.Generator(device=cuda).manual_seed(41)
    n, k = 150, 9
    h = torch.randn((2, n, c), device=cuda, generator=gen).to(dtype)
    idx, mask = _rand_graph(rng, n, k, cuda)
    got = ops.gather_max_int8(h, idx, mask)
    want = ops.gather_max_int8_plain(h, idx, mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert not got[0, 4].float().any()


@pytest.mark.parametrize("c_in,c_out", [(128, 256), (24, 40)])
def test_gather_matmul_max_int8_kernel(cuda, c_in, c_out):
    """Held as the bf16 matmul max (one bf16 ulp, or the f32 summation
    bound near zero); bit-equal on inputs whose sums are exact in any
    order; -3e38 on a row with no valid neighbour."""
    rng = np.random.default_rng(42)
    gen = torch.Generator(device=cuda).manual_seed(42)
    n, k = 150, 9
    idx, mask = _rand_graph(rng, n, k, cuda)
    xq = torch.randint(-127, 128, (2, n, c_in), device=cuda, generator=gen,
                       dtype=torch.int8)
    w = (torch.randn((c_in, c_out), device=cuda, generator=gen) / 64).to(
        torch.bfloat16)
    got = ops.gather_matmul_max_int8(xq, w, idx, mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (2, n, c_out)
    _mm_max_held(got, xq, w, idx, mask)
    assert bool((got[0, 4].float() == torch.tensor(NEG).to(
        torch.bfloat16).float()).all())
    we = (torch.randint(-16, 17, (c_in, c_out), device=cuda, generator=gen)
          / 16.0).to(torch.bfloat16)
    assert torch.equal(
        _bits(ops.gather_matmul_max_int8(xq, we, idx, mask)),
        _bits(ops.gather_matmul_max_int8_plain(xq, we, idx, mask)))


def test_int8_model_kernels_match_plain(cuda):
    """Narrow classification and segmentation models served at
    precision="int8" through the kernels and through the plain versions
    on the card, uniform and ragged: within 1e-2 x max|logit| (a one-ulp
    bf16 difference before a quantization can move a value by a step);
    densify_int8 once a forward, gather_max_int8 and (classification, a
    lane-narrower last conv) gather_matmul_max_int8 launched."""
    rng = np.random.default_rng(43)
    pos, nrm = _cloud_batch(rng, 5, 128, "cpu")
    cats = [0, 3, 15, 7, 1]
    models = (
        DeltaNetClassification(5, conv_channels=(8, 16, 16, 136),
                               embedding_size=32, num_neighbors=8,
                               knn_method="approx",
                               generator=torch.Generator().manual_seed(0)),
        DeltaNetSegmentation(6, conv_channels=(8, 16, 136),
                             embedding_size=32, num_neighbors=8,
                             categorical_vector=True, knn_method="approx",
                             generator=torch.Generator().manual_seed(0)))
    for model in models:
        seg = isinstance(model, DeltaNetSegmentation)
        kw = dict(num_points=128, batch_size=4, precision="int8")
        engine = InferenceEngine(model, **kw)
        plain = InferenceEngine(model, ops=PLAIN_OPS, **kw)
        extra = {"categories": cats} if seg else {}
        for sizes in ([128] * 5, [128, 128, 90, 128, 60]):
            clouds = [p[:s].numpy() for p, s in zip(pos, sizes)]
            normals = [q[:s].numpy() for q, s in zip(nrm, sizes)]
            reset_launch_counts()
            got = engine.predict(clouds, normals, **extra)
            counts = launch_counts()
            want = plain.predict(clouds, normals, **extra)
            if seg:
                got, want = np.concatenate(got), np.concatenate(want)
            np.testing.assert_allclose(got, want,
                                       atol=1e-2 * float(np.abs(want).max()))
            assert counts["densify_int8"] == 2  # 2 batches
            assert counts["gather_max_int8"] > 0
            assert counts["gather_matmul_max_int8"] == (0 if seg else 2)
            assert counts["densify_bf16"] == counts["densify"] == 0


# -- the large-cloud coefficient-operator slice ----------------------------------


def _coef_operators(rng, n, k, dev, masked):
    """Random neighbour lists (self in slot 0) and coefficients;
    ``masked`` clamps the last 3 slots of every other point to self with
    zero coefficients, as masked edges are."""
    idx = rng.integers(0, n, (2, n, k)).astype(np.int32)
    idx[:, :, 0] = np.arange(n)
    gc = rng.standard_normal((2, n, k, 2)).astype(np.float32)
    dc = rng.standard_normal((2, n, k, 2)).astype(np.float32)
    if masked:
        idx[:, ::2, -3:] = np.arange(0, n, 2)[None, :, None]
        gc[:, ::2, -3:] = 0.0
        dc[:, ::2, -3:] = 0.0
    return (torch.from_numpy(a).to(dev) for a in (idx, gc, dc))


def _bits_equal(got, want):
    assert got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got, want)


def _off_aligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _plan_route(t, plan):
    """Whether an apply of ``t`` with ``plan`` takes route B."""
    rb = t.shape[-1] * t.element_size()
    return (plan is not None and rb % 16 == 0 and rb >= 256
            and t.data_ptr() % 16 == 0)


def _applies_exact(x, v, gc, dc, idx, plan, want_g, want_d):
    """Both applies through ``plan`` (None: route A) bit-equal to the
    plain results, each launching the route its shape selects once."""
    for name, fn, feat, coef, want in (
            ("coef_apply_grad", ops.coef_apply_grad, x, gc, want_g),
            ("coef_apply_div", ops.coef_apply_div, v, dc, want_d)):
        reset_launch_counts()
        _bits_equal(fn(feat, coef, idx, plan), want)
        counts = launch_counts()
        planned = _plan_route(feat, plan)
        assert counts[name + "_plan"] == int(planned), counts
        assert counts[name] == int(not planned), counts


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 9, 20, 30])
@pytest.mark.parametrize("c", [3, 6, 24, 70, 128, 192, 256, 301])
def test_coef_apply_kernels_exact(cuda, c, k, dtype, masked):
    """Both applies bit-equal to their plain versions (the same f32
    products and sums, each rounded, slot by slot) on every route: route
    A on 16-byte aligned tables and on tables one channel off that
    boundary (narrower vectors), route B with a plan of random positions
    where the rows allow it (route A elsewhere), at the model's widths
    (3, 6, 70, 128, 192, 256) and others (24; odd 301: bf16 without
    channel pairs), K = 1, 9, 20 and 30 (a second chunk of staged
    slots)."""
    rng = np.random.default_rng(50)
    n = 150
    idx, gc, dc = _coef_operators(rng, n, k, cuda, masked)
    plan = ops.coef_plan(torch.randn((2, n, 3), device=cuda), idx)
    x = torch.randn((2, n, c), device=cuda).to(dtype)
    v = torch.randn((2, n, 2, c), device=cuda).to(dtype)
    want_g = ops.coef_apply_grad_plain(x, gc, idx)
    want_d = ops.coef_apply_div_plain(v, dc, idx)
    for xs, vs in ((x, v), (_off_aligned(x), _off_aligned(v))):
        for p in (None, plan):
            _applies_exact(xs, vs, gc, dc, idx, p, want_g, want_d)


@pytest.mark.parametrize("c", [6, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coef_apply_out_of_range_ids_gather_zero(cuda, c, dtype):
    """An id outside [0, N) gathers 0 on both routes: bit-equal to the
    plain versions with those slots' coefficients zeroed (adding a
    signed zero leaves an f32 sum that started at +0 as it was)."""
    rng = np.random.default_rng(55)
    n, k = 150, 20
    idx, gc, dc = _coef_operators(rng, n, k, cuda, False)
    bad = torch.from_numpy(rng.random((2, n, k)) < 0.1).to(cuda)
    bad[:, :, 0] = False
    far = torch.where(torch.rand((2, n, k), device=cuda) < 0.5, -3, n + 7)
    idx_bad = torch.where(bad, far.int(), idx)
    keep = (~bad)[..., None]
    x = torch.randn((2, n, c), device=cuda).to(dtype)
    v = torch.randn((2, n, 2, c), device=cuda).to(dtype)
    idx_ok = torch.where(bad, 0, idx)
    want_g = ops.coef_apply_grad_plain(x, gc * keep, idx_ok)
    want_d = ops.coef_apply_div_plain(v, dc * keep, idx_ok)
    plan = ops.coef_plan(torch.randn((2, n, 3), device=cuda), idx_bad)
    assert int((plan.run_rows == -1).sum()) > 0
    for p in (None, plan):
        _applies_exact(x, v, gc, dc, idx_bad, p, want_g, want_d)


def _plan_equal(got, want):
    assert got.run == want.run
    for name in ("order", "run_rows", "run_count", "local_slot"):
        a, w = getattr(got, name), getattr(want, name)
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, w), name


@pytest.mark.parametrize("b,n,k", [(2, 150, 9), (3, 1000, 20), (1, 77, 30),
                                   (2, 40, 1), (4, 8192, 20), (1, 10000, 20)])
@pytest.mark.parametrize("masked", [False, True])
def test_coef_plan_kernels_exact(cuda, b, n, k, masked):
    """The gather plan's kernels (the Morton order: chunks of 1024 points
    sorted, then ranked against each other; then the runs) equal the
    plain builder entry by entry, on surface clouds with padded points
    (last in every run order), runs and chunks cut short at a cloud's
    end (10,000 points), ids outside [0, N) and duplicate ids in a list;
    the plan is deterministic, and a neighbour list of more than 1024
    slots has none (its applies take route A)."""
    rng = np.random.default_rng(56)
    pos, _ = _cloud_batch(rng, b, n, cuda)
    pos = pos.contiguous()
    idx = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(
        np.int32)).to(cuda)
    idx[0, :5, -1] = n + 2
    pm = None
    if masked:
        pm = torch.ones((b, n), dtype=torch.bool, device=cuda)
        pm[-1, (2 * n) // 3:] = False
    reset_launch_counts()
    got = ops.coef_plan(pos, idx, pm)
    counts = launch_counts()
    assert counts["coef_plan_order"] == counts["coef_plan_runs"] == 1
    _plan_equal(got, ops.coef_plan_plain(pos, idx, pm))
    _plan_equal(ops.coef_plan(pos, idx, pm), got)
    if masked:
        tail = got.order[-1, (2 * n) // 3:].long()
        assert bool((tail >= (2 * n) // 3).all())
    wide = torch.zeros((1, 8, 1025), dtype=torch.int32, device=cuda)
    assert ops.coef_plan(pos[:1, :8], wide) is None
    assert ops.coef_plan_plain(pos[:1, :8], wide) is None


def _edge_major(g):
    """``g [B, C, K, N]`` as the coefficient VJPs hand it: the same values
    in edge-major rows ``[B, N, K, C]``, viewed as ``[B, C, K, N]``."""
    return g.permute(0, 3, 2, 1).contiguous().permute(0, 3, 2, 1)


def _scatter_held(g, idx, n_out):
    """``scatter_rows`` on ``g`` and on its edge-major view, each
    bit-equal across two calls (no float atomics), the two layouts
    bit-equal (the same sums in the same order), within 1e-5 x max of
    ``scatter_add_`` (whose atomics on the card add in any order)."""
    want = ops.scatter_rows_plain(g, idx, n_out)
    outs = []
    for layout in (g, _edge_major(g)):
        reset_launch_counts()
        got = ops.scatter_rows(layout, idx, n_out)
        again = ops.scatter_rows(layout, idx, n_out)
        torch.cuda.synchronize()
        assert launch_counts()["scatter_rows"] == 2
        assert launch_counts()["inverse_adjacency"] == 2
        assert got.shape == (g.shape[0], n_out, g.shape[1])
        assert torch.equal(got, again)
        _close_to_max(got, want, 1e-5)
        outs.append(got)
    assert torch.equal(*outs)


@pytest.mark.parametrize("n_out,c", [(150, 5), (150, 70), (170, 512),
                                     (120, 33), (150, 9), (150, 12),
                                     (150, 18), (150, 20)])
def test_scatter_rows_kernel(cuda, n_out, c):
    """Component-major and edge-major ``g``: the sum's vector widths 1, 2
    and 4 and lane groups of 8, 16 and 32 lanes a row, with repeated
    indices and a hub row that takes every point's second slot; indices
    outside ``[0, n_out)`` add nothing."""
    rng = np.random.default_rng(51)
    n, k = 150, 9
    idx = torch.from_numpy(
        rng.integers(0, 150, (2, n, k)).astype(np.int32)).to(cuda)
    idx[:, :, 1] = 3  # one row takes every point's second slot
    g = torch.randn((2, c, k, n), device=cuda)
    _scatter_held(g, idx, n_out)
    # Strides of any kind: a broadcast cotangent (all strides 0).
    ones = torch.ones((), device=cuda).expand(2, c, k, n)
    torch.testing.assert_close(ops.scatter_rows(ones, idx, n_out),
                               ops.scatter_rows_plain(ones, idx, n_out),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,n_out", [(150, 150), (150, 120), (150, 170)])
def test_inverse_adjacency_kernel_exact(cuda, n, n_out):
    """Offsets and edge lists equal to the plain stable ``argsort``: each
    in-range edge listed once, ascending, under its row; a hub row; edges
    outside ``[0, n_out)`` (negative ones included) listed as -1."""
    rng = np.random.default_rng(61)
    idx = torch.from_numpy(
        rng.integers(-2, 152, (3, n, 9)).astype(np.int32)).to(cuda)
    idx[:, :, 1] = 3
    reset_launch_counts()
    got = ops.inverse_adjacency(idx, n_out)
    torch.cuda.synchronize()
    assert launch_counts()["inverse_adjacency"] == 1
    want = ops.inverse_adjacency_plain(idx, n_out)
    for a, w in zip(got, want):
        assert a.dtype == torch.int32
        assert torch.equal(a, w)


def test_coef_kernels_at_the_large_cloud_shapes(cuda):
    """B=4 clouds of N=8192, K=20 on the clouds' own coefficients: the
    applies bit-equal at conv1's widths (grad 192, div 128), bf16 and f32,
    through ``GradDiv`` (route B on its plan) and route A,
    the scatter of conv0's grad cotangent (70) and of conv3's div
    cotangent (512) held by ``_scatter_held`` on both layouts, then again
    with a hub row (every point's second slot), and the inverse adjacency
    equal to its plain version."""
    rng = np.random.default_rng(52)
    pos, nrm = _cloud_batch(rng, 4, 8192, cuda)
    gd = build_operators(pos, 20, nrm, knn_method="approx",
                         dense_operators=False)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((4, 8192, 192), device=cuda).to(dtype)
        v = torch.randn((4, 8192, 2, 128), device=cuda).to(dtype)
        want_g = ops.coef_apply_grad_plain(x, gd.grad_coef, gd.nbr_idx)
        want_d = ops.coef_apply_div_plain(v, gd.div_coef, gd.nbr_idx)
        _bits_equal(ops.coef_apply_grad(x, gd.grad_coef, gd.nbr_idx),
                    want_g)
        _bits_equal(ops.coef_apply_div(v, gd.div_coef, gd.nbr_idx), want_d)
        reset_launch_counts()
        _bits_equal(gd.grad(x), want_g)
        _bits_equal(gd.div(v), want_d)
        counts = launch_counts()
        assert counts["coef_apply_grad_plan"] == 1, counts
        assert counts["coef_apply_div_plan"] == 1, counts
    hub = gd.nbr_idx.clone()
    hub[:, :, 1] = 3
    for idx in (gd.nbr_idx, hub):
        for a, w in zip(ops.inverse_adjacency(idx, 8192),
                        ops.inverse_adjacency_plain(idx, 8192)):
            assert torch.equal(a, w)
        for c in (70, 512):
            _scatter_held(torch.randn((4, c, 20, 8192), device=cuda), idx,
                          8192)


def test_coef_backward_launches_only_what_is_asked(cuda):
    """Differentiated applies launch their forward kernel once and, in the
    backward, ``scatter_rows`` only for features that require grad and
    ``coef_cotangent`` only for coefficients that do; the gradients equal
    the plain route's (the scatter within 1e-5 x max; the coefficients'
    within one f32 ulp, two f64 sum orders). The differentiable gather's
    backward is one ``scatter_rows``."""
    rng = np.random.default_rng(53)
    n, k, c = 128, 8, 24
    idx, gc, _ = _coef_operators(rng, n, k, cuda, True)
    x = torch.randn((2, n, c), device=cuda)
    ct = torch.randn((2, n, 2, c), device=cuda)
    for needs_x, needs_c in ((True, False), (False, True), (True, True)):
        grads = []
        for fn in (ops.coef_apply_grad, ops.coef_apply_grad_plain):
            reset_launch_counts()
            xg = x.clone().requires_grad_(needs_x)
            cg = gc.clone().requires_grad_(needs_c)
            fn(xg, cg, idx).backward(ct)
            counts = launch_counts()
            if fn is ops.coef_apply_grad:
                assert counts["coef_apply_grad"] == 1, counts
                assert counts["scatter_rows"] == int(needs_x), counts
                assert counts["inverse_adjacency"] == int(needs_x), counts
                assert counts["coef_cotangent"] == int(needs_c), counts
                assert counts["gather_rows"] == 0, counts
            else:
                assert sum(counts.values()) == 0, counts
            grads.append((xg.grad, cg.grad))
        for got, want in zip(*grads):
            assert (got is None) == (want is None)
            if got is not None:
                _close_to_max(got, want, 1e-5)
    reset_launch_counts()
    table = torch.randn((2, n, 9), device=cuda, requires_grad=True)
    ops.gather_rows(table, idx).sum().backward()
    assert launch_counts()["gather_rows"] == 1
    assert launch_counts()["scatter_rows"] == 1
    assert launch_counts()["inverse_adjacency"] == 1


def _cotangent_held(got, feat, ct, idx):
    """Each entry within one f32 ulp of the plain version or the f64
    summation bound ``C 2^-52 sum_c |x_c ct_c|`` (the kernel's f64 order
    against the einsum's); returns how many entries differ at all."""
    want = ops.coef_cotangent_plain(feat, ct, idx).double()
    scale = ops.coef_cotangent_plain(feat.abs(), ct.abs(), idx).double()
    w32 = want.abs().float()
    ulp = (torch.nextafter(w32, torch.full_like(w32, float("inf")))
           - w32).double()
    err = (got.double() - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= ulp + feat.shape[-1] * 2.0 ** -52 * scale).all())
    return int((got.double() != want).sum())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n", [(32, 1024), (4, 8192), (2, 77)])
@pytest.mark.parametrize("mode", ["grad", "div"])
def test_coef_cotangent_kernel(cuda, mode, b, n, masked):
    """``coef_cotangent`` against its plain version at the dense path's
    shape (B=32, N=1024), the coefficient form's (B=4, N=8192) and a
    small one, on kNN graphs (``masked``: half of the first cloud's points
    padded) and at one forward's apply widths, both routes (narrow rows:
    grad C=3, div C=6; wide: the rest, C not a multiple of 4 included):
    held by :func:`_cotangent_held`, a second call bit-equal; the grad
    mode read through the strides of the transposed ``[B, 2, N, C]``
    cotangent bit-equal to its contiguous copy, and the points walked in
    another order (``order``, a permutation of each cloud's) bit-equal;
    indices outside ``[0, N)`` give 0; one launch a call."""
    rng = np.random.default_rng(61)
    pos, _ = _cloud_batch(rng, b, n, cuda)
    idx, _ = _graph(pos, 20, masked)
    order = torch.argsort(torch.rand((b, n), device=cuda), dim=1).int()
    widths = (3, 70, 192, 256) if mode == "grad" else (6, 70, 128, 256)
    for c in widths:
        feat = torch.randn((b, n, c) if mode == "grad" else (b, n, 2, c),
                           device=cuda)
        planes = torch.randn((b, 2, n, c) if mode == "grad" else (b, n, c),
                             device=cuda)
        ct = planes.transpose(1, 2) if mode == "grad" else planes
        reset_launch_counts()
        got = ops.coef_cotangent(feat, ct, idx)
        torch.cuda.synchronize()
        assert launch_counts()["coef_cotangent"] == 1
        _cotangent_held(got, feat, ct, idx)
        _bits_equal(ops.coef_cotangent(feat, ct, idx), got)
        _bits_equal(ops.coef_cotangent(feat, ct, idx, order), got)
        if mode == "grad":
            _bits_equal(ops.coef_cotangent(feat, ct.contiguous(), idx), got)
    bad = idx.clone()
    bad[:, ::3, 1] = -1
    bad[:, 1::3, 2] = n
    got = ops.coef_cotangent(feat, ct, bad)
    _cotangent_held(got, feat, ct, bad)
    assert bool((got[:, ::3, 1] == 0).all())
    assert bool((got[:, 1::3, 2] == 0).all())


def _coef_step(batch, ops_, compute_dtype=None):
    model = DeltaNetClassification(
        5, conv_channels=(8, 8, 16, 16), embedding_size=32, num_neighbors=8,
        dropout=0.0, compute_dtype=compute_dtype, knn_method="approx",
        dense_operators=False, generator=torch.Generator().manual_seed(0))
    model = model.to(batch["pos"].device)
    state = create_train_state(model, sgd_momentum(0.01))
    loss = float(make_train_step(model, ops=ops_)(state, batch, None)["loss"])
    return loss, model


def _frob_all(ma, mb):
    """Relative Frobenius deviation of ``ma``'s gradients from ``mb``'s,
    over all tensors at once."""
    grads_b = dict(mb.named_parameters())
    num = den = 0.0
    for name, p in ma.named_parameters():
        q = grads_b[name].grad.double()
        num += float(((p.grad.double() - q) ** 2).sum())
        den += float((q ** 2).sum())
    return (num / max(den, 1e-60)) ** 0.5


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_coef_model_kernels_match_plain(cuda, compute_dtype):
    """A narrow coefficient-form model on the card: one train step through
    the kernels launches 4 grad and 4 div applies and 6 scatters, each
    with its inverse adjacency (the positions' grad and conv0's div of it
    take no backward), and none of the dense assembly. Against the same
    step with only the applies (and their scatters) on the plain route:
    the forward is bit-equal (loss and running statistics equal), and the
    gradients differ only by the order of the sums (``scatter_add_``'s
    atomics against the kernel's fixed edge order; f32: 1e-3 x each
    tensor's max, as chip_smoke.py's
    same-build step; bf16, where a one-ulp cast moves a max winner: 2e-2
    relative Frobenius over all tensors). Served, the logits of the kernel
    path and the whole plain path agree within 1e-4 (f32) or 1e-2 (bf16) x
    max|logit|."""
    rng = np.random.default_rng(54)
    pos, nrm = _cloud_batch(rng, 4, 128, cuda)
    batch = {"pos": pos, "normal": nrm,
             "label": torch.tensor([0, 1, 2, 3], device=cuda)}
    reset_launch_counts()
    loss_k, model_k = _coef_step(batch, KERNEL_OPS, compute_dtype)
    counts = launch_counts()
    plain_applies = KERNEL_OPS._replace(
        coef_apply_grad=ops.coef_apply_grad_plain,
        coef_apply_div=ops.coef_apply_div_plain)
    loss_p, model_p = _coef_step(batch, plain_applies, compute_dtype)
    assert counts["coef_apply_grad"] == counts["coef_apply_div"] == 4, counts
    assert counts["scatter_rows"] == counts["inverse_adjacency"] == 6, counts
    assert counts["densify"] == counts["densify_bf16"] == 0, counts
    assert loss_k == loss_p
    bufs_p = dict(model_p.named_buffers())
    for name, b in model_k.named_buffers():
        assert torch.equal(b, bufs_p[name]), name
    params_p = dict(model_p.named_parameters())
    for name, p in model_k.named_parameters():
        assert bool(p.grad.isfinite().all())
        if compute_dtype is None:
            _close_to_max(p.grad, params_p[name].grad, 1e-3)
    if compute_dtype is not None:
        assert _frob_all(model_k, model_p) <= 2e-2
    f32 = compute_dtype is None
    precision = "bfloat16" if compute_dtype else None
    clouds = [p.cpu().numpy() for p in pos]
    normals = [q.cpu().numpy() for q in nrm]
    kw = dict(num_points=128, batch_size=4, precision=precision)
    got = InferenceEngine(model_k, **kw).predict(clouds, normals)
    want = InferenceEngine(model_k, ops=PLAIN_OPS, **kw).predict(clouds,
                                                                 normals)
    np.testing.assert_allclose(got, want, rtol=0, atol=(
        1e-4 if f32 else 1e-2) * float(np.abs(want).max()))


# -- point-sharded serving: the table and bucketed kNN ----------------------


def _surface(rng, n, dev, shift=0.0):
    pos, _ = _cloud_batch(rng, 1, n, dev)
    return pos[0] + shift


@pytest.mark.parametrize("c", [9, 3])
@pytest.mark.parametrize("n_t,n", [(300, 77), (300, 80), (65536, 1001)])
def test_gather_rows_kernel_longer_table(cuda, n_t, n, c):
    """A table longer than the query rows (the sharded build's): staged
    (300 rows) or read through the read-only path (65,536), N % 4 != 0
    and not."""
    rng = np.random.default_rng(60)
    table = torch.from_numpy(
        rng.standard_normal((1, n_t, c)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(
        rng.integers(0, n_t, (1, n, 10)).astype(np.int32)).to(cuda)
    got = ops.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert got.shape == (1, c, 10, n)
    assert torch.equal(got, ops.gather_rows_plain(table, idx))


def _table_cloud(rng, n, dev, cloud):
    """A surface cloud, or a tie-heavy 9^3 grid (``"grid"``)."""
    if cloud == "grid":
        return torch.from_numpy(
            (rng.integers(-4, 5, (n, 3)) * 0.25).astype(np.float32)).to(dev)
    return _surface(rng, n, dev)


@pytest.mark.parametrize("cloud", ["surface", "grid"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n_q,n_t,k,tile_c", [
    (300, 700, 11, 128), (300, 5000, 20, 2048), (8192, 8192, 30, 2048),
    (8192, 8192, 20, 2048), (100, 2049, 32, 2048), (77, 4100, 1, 1024),
    (8192, 8192, 10, 2048)])
def test_knn_table_kernel_exact(cuda, n_q, n_t, k, tile_c, quantized,
                                masked, cloud):
    """Ids equal to the plain version (order included), rows offset into
    the table, 10% of it masked, on a surface and on a tie-heavy grid; at
    the shard shapes (N=8192, K = 20 and 30), at K = 1 and 32, and with
    Nt not a multiple of tile_c (the last tile padded)."""
    rng = np.random.default_rng(61)
    pos_t = _table_cloud(rng, n_t, cuda, cloud)
    off = (n_t - n_q) // 2
    pm = None
    if masked:
        pm = torch.rand(n_t, device=cuda) > 0.1
        pm[off:off + n_q] = True
    args = (pos_t[off:off + n_q], pos_t, k, off, pm, tile_c, quantized)
    reset_launch_counts()
    got = ops.knn_topk_table(*args)
    torch.cuda.synchronize()
    name = "knn_topk_table_q" if quantized else "knn_topk_table"
    assert launch_counts()[name] == 1
    assert torch.equal(got, ops.knn_topk_table_plain(*args))
    assert torch.equal(got[:, 0].long(),
                       off + torch.arange(n_q, device=cuda))


@pytest.mark.parametrize("cloud", ["surface", "grid"])
@pytest.mark.parametrize("quantized", [False, True])
def test_knn_table_kernel_starved_and_row_ids(cuda, quantized, cloud):
    """Rows with fewer valid columns than K (masked fillers, lowest
    first), masked query rows (the exact body scores a masked self -2e30,
    the quantized one keeps it as self), and scattered ``row_ids`` (the
    repair pass): ids equal."""
    rng = np.random.default_rng(62)
    pos_t = _table_cloud(rng, 3000, cuda, cloud)
    pm = torch.zeros(3000, dtype=torch.bool, device=cuda)
    pm[:5] = True
    pm[100:108] = True
    args = (pos_t[100:108], pos_t, 20, 100, pm, 2048, quantized)
    got = ops.knn_topk_table(*args)
    assert torch.equal(got, ops.knn_topk_table_plain(*args))
    pm = torch.rand(3000, device=cuda) > 0.5
    args = (pos_t[90:400], pos_t, 20, 90, pm, 1024, quantized)
    got = ops.knn_topk_table(*args)
    assert torch.equal(got, ops.knn_topk_table_plain(*args))
    ids = torch.randperm(3000, device=cuda)[:700].int()
    kw = dict(row_ids=ids, quantized=quantized)
    got = ops.knn_topk_table(pos_t[ids.long()], pos_t, 20, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.knn_topk_table_plain(pos_t[ids.long()],
                                                      pos_t, 20, **kw))
    assert torch.equal(got[:, 0], ids)


@pytest.mark.parametrize("cloud", ["surface", "grid"])
@pytest.mark.parametrize("quantized", [False, True])
def test_knn_table_kernel_repair_shape(cuda, quantized, cloud):
    """The bucketed kNN's repair form: 2048 scattered ``row_ids`` against
    65,536 columns (32 tiles a row), 10% masked: ids equal."""
    rng = np.random.default_rng(68)
    pos_t = _table_cloud(rng, 65536, cuda, cloud)
    pm = torch.rand(65536, device=cuda) > 0.1
    ids = torch.randperm(65536, device=cuda)[:2048].int()
    kw = dict(point_mask=pm, row_ids=ids, quantized=quantized)
    got = ops.knn_topk_table(pos_t[ids.long()], pos_t, 20, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.knn_topk_table_plain(pos_t[ids.long()],
                                                      pos_t, 20, **kw))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_knn_bucketed_kernel_normal_graph(cuda, masked, quantized):
    """K = 10, the sharded normal graph of a cloud without normals, at the
    bench's N=65,536 (10% masked or none): ids equal to the plain
    version's, self first, masked columns never taken."""
    rng = np.random.default_rng(69)
    pos = _surface(rng, 65536, cuda)
    pm = torch.rand(65536, device=cuda) > 0.1 if masked else None
    args = (pos, pos, 10, 0, pm)
    kw = dict(quantized=quantized)
    reset_launch_counts()
    got = ops.knn_topk_bucketed(*args, **kw)
    torch.cuda.synchronize()
    name = "knn_topk_bucketed_q" if quantized else "knn_topk_bucketed"
    assert launch_counts()[name] == 1
    assert torch.equal(got, ops.knn_topk_bucketed_plain(*args, **kw))
    rows = torch.arange(65536, device=cuda)
    valid = rows >= 0 if pm is None else pm
    assert torch.equal(got[valid, 0].long(), rows[valid])
    if masked:
        assert bool(pm[got[valid].long()].all())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n,m_tiles,masked,shift", [
    (3000, 4, False, 0.0), (3000, 10, True, 0.0), (3000, 4, False, 100.0),
    (65536, None, True, 0.0)])
def test_knn_bucketed_kernel_exact(cuda, n, m_tiles, masked, shift,
                                   quantized):
    """The candidate sweep's kernel in the whole bucketed kNN: ids equal
    to the plain version's (fast, repair and full branches; a cloud 100
    units from the origin; the bench's N=65,536 with 10% masked)."""
    rng = np.random.default_rng(63)
    pos = _surface(rng, n, cuda, shift)
    pm = None
    if masked:
        pm = torch.rand(n, device=cuda) > 0.1
    args = (pos, pos, 20, 0, pm)
    kw = dict(m_tiles=m_tiles, quantized=quantized, repair_rows=512)
    reset_launch_counts()
    got = ops.knn_topk_bucketed(*args, **kw)
    torch.cuda.synchronize()
    name = "knn_topk_bucketed_q" if quantized else "knn_topk_bucketed"
    assert launch_counts()[name] == 1
    assert torch.equal(got, ops.knn_topk_bucketed_plain(*args, **kw))
    rows = torch.arange(n, device=cuda)
    valid = rows >= 0 if pm is None else pm
    assert torch.equal(got[valid, 0].long(), rows[valid])
    if masked:
        assert bool(pm[got[valid].long()].all())


def test_knn_bucketed_kernel_starved_rows(cuda):
    """Only 6 valid points: every filler is the marker (>= N), in both
    bodies, as in the plain version."""
    rng = np.random.default_rng(64)
    pos = _surface(rng, 512, cuda)
    pm = torch.zeros(512, dtype=torch.bool, device=cuda)
    pm[:6] = True
    for quantized in (False, True):
        args = (pos[:6], pos, 9, 0, pm)
        kw = dict(quantized=quantized, m_tiles=4)
        got = ops.knn_topk_bucketed(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ops.knn_topk_bucketed_plain(*args, **kw))
        assert bool((got[:, 6:] >= 512).all())


def _bucketed_case(case, dev):
    """``(pos_q, pos_t, k, row_offset, point_mask, keywords)`` of a hard
    case of the candidate sweep."""
    rng = np.random.default_rng(66)
    if case == "ties":  # 8 distinct positions: every score ties 375 ways
        pos = _surface(rng, 8, dev).repeat(375, 1)
        return pos, pos, 20, 0, None, {}
    if case == "k33":  # K - 1 = 32, the list's capacity
        pos = _surface(rng, 3000, dev)
        # Every bucket visited: no exactness certificate, so no repair by
        # the table kNN (which takes K <= 32).
        return pos, pos, 33, 0, None, dict(m_tiles=16)
    if case == "starved":  # 20 valid points for K - 1 = 32
        pos = _surface(rng, 3000, dev)
        pm = torch.zeros(3000, dtype=torch.bool, device=dev)
        pm[torch.randperm(3000, device=dev)[:20]] = True
        return pos, pos, 33, 0, pm, dict(m_tiles=16)
    if case == "one-bucket":  # clusters of 24: winners in the home bucket
        centres = _surface(rng, 125, dev) * 10.0
        offs = torch.from_numpy(rng.standard_normal((125, 24, 3)).astype(
            np.float32)).to(dev) * 1e-3
        pos = (centres[:, None] + offs).reshape(-1, 3)
        return pos, pos, 20, 0, None, dict(m_tiles=4)
    if case == "coarse":  # a 6^3 grid: many equal quantized keys
        pos = torch.from_numpy(rng.integers(0, 6, (4000, 3)).astype(
            np.float32)).to(dev)
        return pos, pos, 20, 0, None, dict(m_tiles=4)
    # "lane-limit": m * tile_c = 255 * 257 = 65,535 lanes, the quantized
    # key's limit, in buckets of 257 columns (padded to 260 for the copies)
    pos = _surface(rng, 65600, dev)
    return (pos[1000:3048], pos, 20, 1000, None,
            dict(m_tiles=255, tile_c=257))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("case", ["ties", "k33", "starved", "one-bucket",
                                  "coarse", "lane-limit"])
def test_knn_bucketed_kernel_cases(cuda, case, quantized):
    """The candidate sweep on its hard cases: duplicate points (every
    score ties: lowest id, or lowest lane, first), K = 33 (K - 1 = 32),
    rows with fewer valid candidates than K - 1 (marker fillers), rows
    whose winners all lie in one bucket, equal quantized keys, and m x
    tile_c = 65,535 candidate lanes in buckets of a width that is not a
    multiple of 4: ids equal to the plain version's, and two calls give
    the same bits."""
    pos_q, pos_t, k, off, pm, kw = _bucketed_case(case, cuda)
    args = (pos_q, pos_t, k, off, pm)
    kw = dict(kw, quantized=quantized)
    got = ops.knn_topk_bucketed(*args, **kw)
    again = ops.knn_topk_bucketed(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, ops.knn_topk_bucketed_plain(*args, **kw))
    if case == "starved":
        assert bool((got[pm[off:off + len(pos_q)]][:, 20:]
                     >= len(pos_t)).all())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("cloud", ["uniform", "masked", "shifted", "ties"])
def test_knn_bucketed_sweep_exact(cuda, cloud, quantized):
    """The candidate sweep alone on the inputs the bucketed kNN gives it:
    ids and scores bit-equal to its plain version (the kernel skips
    buckets by their boxes; a cloud 100 units from the origin stretches
    the rounding margin of that test, and duplicate points tie)."""
    from deltaconv_tpu_torch.ops import knn_bucketed as kb

    rng = np.random.default_rng(67)
    n = 20000
    pos = _surface(rng, n, cuda, 100.0 if cloud == "shifted" else 0.0)
    if cloud == "ties":
        pos = pos[:2500].repeat(8, 1)
    pm = (torch.rand(n, device=cuda) > 0.1) if cloud == "masked" else None
    captured = {}

    def spy(*args):
        captured["args"] = args
        return kb._cand_kernel(*args)

    kb._bucketed(pos, pos, 20, 0, pm, 64, 256, 24 if quantized else 32,
                 quantized, 512, spy, ops.knn_topk_table)
    got = kb._cand_kernel(*captured["args"])
    want = kb._cand_plain(*captured["args"])
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("precision", [None, "bfloat16"])
def test_predict_sharded_kernels_match_plain(cuda, precision):
    """``predict_sharded`` of a 20,000-point cloud (the bucketed route)
    through the kernels and through the plain versions: f32 within 1e-4,
    bf16 within 1e-2 x max|logit|."""
    rng = np.random.default_rng(65)
    pos, nrm = _cloud_batch(rng, 1, 20000, "cpu")
    model = DeltaNetClassification(
        4, conv_channels=(16, 16, 32), embedding_size=32, num_neighbors=20,
        dense_operators=False, knn_method="approx",
        generator=torch.Generator().manual_seed(0))
    kw = dict(num_points=20000, batch_size=1, precision=precision)
    reset_launch_counts()
    got = InferenceEngine(model, **kw).predict_sharded(pos[0], nrm[0])
    counts = launch_counts()
    want = InferenceEngine(model, ops=PLAIN_OPS, **kw).predict_sharded(
        pos[0], nrm[0])
    assert counts["knn_topk_bucketed_q"] == 1
    rel = 1e-4 if precision is None else 1e-2
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# -- segmentation training: the fused centralized edge MLP ------------------


def _edge_mlp_inputs(rng, n, k, c0, c1, masked, dev):
    """bf16 ``y``, f32 ``a0, b0, w1``, the self slot ``z0`` as the layer
    makes it, and a graph (masked: the kNN's padding, slots clamped to
    self), from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    idx = rng.integers(0, n, (2, n, k)).astype(np.int32)
    idx[:, :, 0] = np.arange(n)
    if masked:
        drop = rng.random((2, n, k)) < 0.3
        drop[1, n // 2:] = True
        drop[:, :, 0] = False
        idx = np.where(drop, np.arange(n, dtype=np.int32)[None, :, None], idx)
    y = torch.randn((2, n, c0), device=dev, generator=gen).to(torch.bfloat16)
    a0 = torch.randn(c0, device=dev, generator=gen)
    b0 = 0.3 * torch.randn(c0, device=dev, generator=gen)
    w1 = torch.randn((c0, c1), device=dev, generator=gen) / c0 ** 0.5
    lb = torch.where(b0 >= 0, b0, 0.2 * b0)
    z0 = lb.to(torch.bfloat16).float() @ w1.to(torch.bfloat16).float()
    return y, a0, b0, w1, z0, torch.from_numpy(idx).to(dev)


def _edge_fwd_held(got, y, a0, b0, w1, z0, idx):
    """The edge MLP's output held element by element: slot 0 equal to
    ``bf16(z0)``; every other within one bf16 ulp of the plain version,
    or within the f32 summation bound ``C0 * 2^-24 * (|h| @ |w1|)`` plus
    half a bf16 ulp of the exact product (f64) of the same bf16 ``h``
    (the rule of the matmul maxes, ``_mm_max_held``)."""
    from deltaconv_tpu_torch.ops.edge_mlp import _edges, _leaky

    want = ops.edge_mlp_fwd_plain(y, a0, b0, w1, z0, idx)
    assert torch.equal(_bits(got[:, 0]), _bits(want[:, 0]))
    _, pre = _edges(y, a0, b0, idx)
    h = _leaky(pre[:, :, 1:]).to(torch.bfloat16).double()
    wd = w1.to(torch.bfloat16).double()
    exact = (h @ wd).permute(0, 2, 1, 3)
    mag = (h.abs() @ wd.abs()).permute(0, 2, 1, 3)
    gd = got[:, 1:].double()
    tol = y.shape[-1] * 2.0 ** -24 * mag + 2.0 ** -8 * gd.abs()
    held = (_bf16_ulps(got[:, 1:], want[:, 1:]) <= 1) | (
        (gd - exact).abs() <= tol)
    assert bool(held.all()), f"{int((~held).sum())} elements beyond both"


def _dy0_ulp(y, a0, b0, w1, idx, g):
    """One bf16 ulp of the largest edge term ``|dy0|`` of ``dy``: a term
    whose f32 sum ran in another order may round to its bf16 neighbour."""
    from deltaconv_tpu_torch.ops.edge_mlp import _edges

    _, pre = _edges(y, a0, b0, idx)
    g1 = g[:, 1:].float().permute(0, 2, 1, 3)
    dh = g1 @ w1.to(torch.bfloat16).float().t()
    dy0 = dh * torch.where(pre[:, :, 1:] >= 0, 1.0, 0.2) * a0
    return 2.0 ** -8 * float(dy0.abs().max())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("c0,c1", [(12, 12), (64, 64)])
def test_edge_mlp_kernels_match_plain(cuda, c0, c1, masked):
    """``edge_delta_mlp`` forward (``_edge_fwd_held``) and backward against
    their plain versions at N=150 (a ragged last tile of 16 points) and
    K=11 (the forward's 4 warps over 10 slots, 2 of them with one fewer):
    ``dy``
    within 1e-5 x max plus one bf16 ulp of the largest edge term (the f32
    sums of ``dh`` run in another order, so an edge term may round to its
    bf16 neighbour),
    ``dw1`` and ``(da0, db0)`` within 1e-5 x max."""
    rng = np.random.default_rng(90 + c0)
    n, k = 150, 11
    y, a0, b0, w1, z0, idx = _edge_mlp_inputs(rng, n, k, c0, c1, masked,
                                              cuda)
    out = ops.edge_mlp_fwd(y, a0, b0, w1, z0, idx)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (2, k, n, c1)
    _edge_fwd_held(out, y, a0, b0, w1, z0, idx)

    gen = torch.Generator(device=cuda).manual_seed(7)
    g = torch.randn((2, k, n, c1), device=cuda, generator=gen).to(
        torch.bfloat16)
    dy, dw1, dab = ops.edge_mlp_bwd(y, a0, b0, w1, idx, g)
    torch.cuda.synchronize()
    dy_p, dw1_p, dab_p = ops.edge_mlp_bwd_plain(y, a0, b0, w1, idx, g)
    flip = _dy0_ulp(y, a0, b0, w1, idx, g)
    torch.testing.assert_close(dy, dy_p, rtol=0, atol=1e-5 * float(
        dy_p.abs().max()) + flip)
    _close_to_max(dw1, dw1_p, 1e-5)
    _close_to_max(dab, dab_p, 1e-5)


def test_edge_delta_mlp_autograd_on_the_card(cuda):
    """The autograd Function through the kernels: one forward and one
    backward launch; values held as above, the gradients as the raw
    backward's (``dy`` in bf16: one bf16 ulp more), ``dz0`` the sum of
    slot 0's cotangent within 1e-5 x max."""
    rng = np.random.default_rng(95)
    n, k, c0, c1 = 150, 11, 64, 64
    y, a0, b0, w1, z0, idx = _edge_mlp_inputs(rng, n, k, c0, c1, True, cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    g = torch.randn((2, k, n, c1), device=cuda, generator=gen).to(
        torch.bfloat16)
    grads = []
    reset_launch_counts()
    for fn in (ops.edge_delta_mlp, ops.edge_delta_mlp_plain):
        leaves = [t.clone().requires_grad_() for t in (y, a0, b0, w1, z0)]
        out = fn(*leaves, idx)
        out.backward(g)
        grads.append([t.grad for t in leaves])
        if fn is ops.edge_delta_mlp:
            _edge_fwd_held(out.detach(), y, a0, b0, w1, z0, idx)
            counts = launch_counts()
    assert counts["edge_delta_mlp"] == counts["edge_delta_mlp_bwd"] == 1
    (dy, da0, db0, dw1, dz0), (dy_p, da0_p, db0_p, dw1_p, dz0_p) = grads
    assert dy.dtype == torch.bfloat16 and dw1.dtype == torch.float32
    flip = _dy0_ulp(y, a0, b0, w1, idx, g)
    torch.testing.assert_close(dy.float(), dy_p.float(), rtol=2.0 ** -8,
                               atol=1e-5 * float(dy_p.abs().max()) + flip)
    for got, want in ((da0, da0_p), (db0, db0_p), (dw1, dw1_p),
                      (dz0, dz0_p)):
        _close_to_max(got, want, 1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_seg_train_step_kernels_match_plain(cuda, fused, monkeypatch):
    """A narrow segmentation model at the production config (bf16,
    approximate kNN, categories), one train step with per-point labels:
    with ``_EDGE_FUSED_TRAIN`` the step launches ``edge_delta_mlp`` and
    its backward once each, without it neither. Against the same step with
    the edge MLP on its plain version: loss rtol 1e-3, running statistics
    1e-3 x max, gradients 2e-2 relative Frobenius over all tensors (a
    one-ulp product moves a max winner)."""
    dc = importlib.import_module("deltaconv_tpu_torch.nn.deltaconv")
    monkeypatch.setattr(dc, "_EDGE_FUSED_TRAIN", fused)
    rng = np.random.default_rng(96)
    pos, nrm = _cloud_batch(rng, 4, 160, cuda)
    batch = {"pos": pos, "normal": nrm,
             "label": torch.from_numpy(rng.integers(0, 6, (4, 160))).to(cuda),
             "category": torch.eye(16, device=cuda)[[1, 4, 4, 9]]}

    def step(ops_):
        model = DeltaNetSegmentation(
            6, conv_channels=(16, 32, 64), embedding_size=32,
            categorical_vector=True, num_neighbors=10, dropout=0.0,
            compute_dtype="bfloat16", operator_dtype="bfloat16",
            knn_method="approx", generator=torch.Generator().manual_seed(0))
        model = model.to(cuda)
        state = create_train_state(model, sgd_momentum(0.01))
        metrics = make_train_step(model, smoothing=0.0, per_point=True,
                                  ops=ops_)(state, batch, None)
        return float(metrics["loss"]), model

    reset_launch_counts()
    loss_k, model_k = step(KERNEL_OPS)
    counts = launch_counts()
    assert counts["edge_delta_mlp"] == counts["edge_delta_mlp_bwd"] == int(
        fused), counts
    loss_p, model_p = step(KERNEL_OPS._replace(
        edge_delta_mlp=ops.edge_delta_mlp_plain))
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    bufs_p = dict(model_p.named_buffers())
    for name, b in model_k.named_buffers():
        _close_to_max(b, bufs_p[name], 1e-3)
    for p in model_k.parameters():
        assert bool(p.grad.isfinite().all())
    assert _frob_all(model_k, model_p) <= 2e-2


# The operator build's backward (wls_bwd, densify_bwd), the fused eval
# build (fused_gather_wls) and knn_topk's mean distances.


def _edges(rng, n, k, masked, flat, dev):
    pos, nrm = _cloud_batch(rng, 2, n, dev)
    if flat:  # a nearly flat neighbourhood: the patch fit's small heights
        pos[1, :, 2] *= 1e-3
        nrm[1] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    idx, mask = _graph(pos, k, masked)
    xb, yb = build_tangent_basis(nrm)
    return edge_planes(pos, nrm, xb, yb, idx, mask,
                       mask.any(dim=2).to(torch.float32))


@pytest.mark.parametrize("n,k,masked,flat", [
    (200, 12, False, False), (200, 12, True, True), (1024, 20, True, False)])
def test_wls_bwd_kernel_matches_plain(cuda, n, k, masked, flat):
    """Each of the 12 planes' cotangents within 1e-4 x that plane's max of
    the plain version's (autograd through ``_wls_math``): the same math
    in another order of operations (FMA contraction, the K sums, the
    reverse Cholesky's accumulators)."""
    rng = np.random.default_rng(50)
    edges = _edges(rng, n, k, masked, flat, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    ctg = torch.randn((2, 2, k, n), device=cuda, generator=gen)
    ctd = torch.randn((2, 2, k, n), device=cuda, generator=gen)
    reset_launch_counts()
    got = ops.wls_bwd(edges, ctg, ctd, 1.0, 1e-3)
    assert launch_counts()["wls_bwd"] == 1
    want = ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3)
    assert bool(torch.isfinite(got).all())
    for p in range(12):
        _close_to_max(got[:, p], want[:, p], 1e-4)


def _wls_hard_edges(rng, n, k, case, dev):
    """Edge planes of two ellipsoid clouds: ``uniform``; ``masked``
    (cloud 0's second half padded, and cloud 1's point 3 with every edge
    masked: its weight sum at the 1e-5 clamp); ``duplicate`` (neighbours
    at distance 0 of their point); ``flat`` (cloud 1 nearly flat)."""
    pos, nrm = _cloud_batch(rng, 2, n, dev)
    if case == "flat":
        pos[1, :, 2] *= 1e-3
        nrm[1] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    if case == "duplicate":
        pos[0, 1] = pos[0, 0]
        pos[1, 5:9] = pos[1, 4]
    idx, mask = _graph(pos, k, case == "masked")
    if case == "masked":
        mask[1, 3] = False
    xb, yb = build_tangent_basis(nrm)
    return edge_planes(pos, nrm, xb, yb, idx, mask,
                       mask.any(dim=2).to(torch.float32))


def _wls_held(edges, slices, name):
    """``wls`` and ``wls_bwd`` through the route of ``slices`` (None: by
    shape) against their plain versions: the forward within 1e-5, each of
    the VJP's planes within 1e-4 x its max (a point whose weight sum sits
    at the clamp, its cotangents ~1 / 1e-5, within 1e-4 x its own), the
    two calls launching ``name`` and its backward (``wls_bwd`` or
    ``wls_bwd_direct``) once each, and second calls bit-equal."""
    wf = importlib.import_module("deltaconv_tpu_torch.ops.wls_fused")
    b, _, k, n = edges.shape
    gen = torch.Generator(device=edges.device).manual_seed(0)
    ctg = torch.randn((b, 2, k, n), device=edges.device, generator=gen)
    ctd = torch.randn((b, 2, k, n), device=edges.device, generator=gen)
    bwd_name = name.replace("wls", "wls_bwd")
    reset_launch_counts()
    got = wf._wls_kernel(edges, 1.0, 1e-3, slices)
    de = wf._wls_bwd(edges, ctg, ctd, 1.0, 1e-3, slices)
    torch.cuda.synchronize()
    counts = {m: c for m, c in launch_counts().items() if c}
    assert counts == {name: 1, bwd_name: 1}, counts
    for a, w in zip(got, ops.wls_plain(edges, 1.0, 1e-3)):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)
    want = ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3)
    assert bool(torch.isfinite(de).all())
    clamped = edges[:, 4].sum(dim=1) == 0  # [B, N]: no valid edge
    for p in range(12):
        for part in (~clamped, clamped):
            if part.any():
                _close_to_max(de[:, p].transpose(1, 2)[part],
                              want[:, p].transpose(1, 2)[part], 1e-4)
    again = wf._wls_kernel(edges, 1.0, 1e-3, slices)
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    assert torch.equal(wf._wls_bwd(edges, ctg, ctd, 1.0, 1e-3, slices), de)


@pytest.mark.parametrize("n,k,case", [
    (1024, 20, "uniform"),   # the classification shape
    (2048, 30, "uniform"),   # segmentation
    (1000, 20, "masked"),    # N not a multiple of 32, a clamped point
    (77, 30, "masked"),
    (150, 13, "uniform"),    # K not a multiple of the warps
    (200, 7, "uniform"),
    (96, 1, "uniform"),      # one edge
    (200, 20, "duplicate"),  # neighbours at distance 0
    (200, 30, "flat"),
])
def test_wls_split_kernels_match_plain(cuda, n, k, case):
    """The split route (by shape: ``wls_split``) of ``wls`` and
    ``wls_bwd`` against the plain versions, bit-equal across two calls."""
    wf = importlib.import_module("deltaconv_tpu_torch.ops.wls_fused")
    assert wf.wls_split(k)[0]
    edges = _wls_hard_edges(np.random.default_rng(56), n, k, case, cuda)
    _wls_held(edges, None, "wls")


@pytest.mark.parametrize("k", [20, 30])
def test_wls_split_every_warp_count(cuda, k):
    """Every number of warps whose slots hold K edges (E up to the most a
    warp holds), at the model's K, on a masked graph."""
    wf = importlib.import_module("deltaconv_tpu_torch.ops.wls_fused")
    edges = _wls_hard_edges(np.random.default_rng(57), 300, k, "masked",
                            cuda)
    for s in range(-(-k // wf.WLS_EDGES), wf.WLS_MAX_SLICES + 1):
        _wls_held(edges, s, "wls")


@pytest.mark.parametrize("k,slices", [(41, None), (64, None), (20, 0)])
def test_wls_direct_route(cuda, k, slices):
    """The direct route: by shape above the split route's edges (each
    call launching ``wls_direct`` and ``wls_bwd_direct`` once, and the
    split kernels never), and forced at the model's K."""
    edges = _wls_hard_edges(np.random.default_rng(58), 300, k, "masked",
                            cuda)
    _wls_held(edges, slices, "wls_direct")
    reset_launch_counts()
    ops.wls(edges, 1.0, 1e-3)
    assert launch_counts()["wls" if slices == 0 else "wls_direct"] == 1


@pytest.mark.parametrize("n,masked", [(96, False), (102, True),
                                      (1024, True)])
def test_densify_bwd_kernel_exact(cuda, n, masked):
    """Bit-equal to ``torch.gather``: the VJP reads one entry an edge and
    plane, with duplicate (clamped) columns and bf16 cotangents read as
    f32."""
    rng = np.random.default_rng(51)
    idx = torch.from_numpy(_knn_like(rng, n, 8, masked)).to(cuda)
    dwg = torch.randn((2, 2, n, n), device=cuda)
    dwd = torch.randn((2, 2, n, n), device=cuda)
    for cast in (torch.float32, torch.bfloat16):
        got = ops.densify_bwd(idx, dwg.to(cast), dwd.to(cast))
        want = ops.densify_bwd_plain(idx, dwg.to(cast), dwd.to(cast))
        for g, w in zip(got, want):
            assert g.shape == (2, n, 8, 2) and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_densify_planes_layout_exact(cuda, dtype):
    """``planes=True`` ([B, 2, N, K] coefficients) gives the operators of
    the stacked layout bit for bit."""
    rng = np.random.default_rng(52)
    n = 128
    idx = torch.from_numpy(_knn_like(rng, n, 8, True)).to(cuda)
    gc = torch.randn((2, 2, n, 8), device=cuda)
    dc = torch.randn((2, 2, n, 8), device=cuda)
    got = ops.densify_coefs(idx, gc, dc, dtype, planes=True)
    want = ops.densify_coefs(idx, gc.permute(0, 2, 3, 1).contiguous(),
                             dc.permute(0, 2, 3, 1).contiguous(), dtype)
    for g, w in zip(got, want):
        assert torch.equal(g.float(), w.float())


@pytest.mark.parametrize("slices", [None, 0], ids=["split", "direct"])
@pytest.mark.parametrize("n,k,masked", [(128, 12, False), (256, 20, True),
                                        (1024, 20, False), (1000, 30, True),
                                        (2048, 30, False), (77, 40, True)])
def test_fused_gather_wls_kernel_matches_plain(cuda, n, k, masked, slices):
    """Both routes (split, by shape; direct, forced): coefficients within
    1e-5 x max and row norms within 1e-5 relative of the plain version (the
    same f32 gather; FMA contraction and the K sums' order), and of the
    unfused ``edge_planes`` + ``wls`` with the same ``avg``, unnormalized;
    a second call bit-equal; one launch of the route a call."""
    fb = importlib.import_module("deltaconv_tpu_torch.ops.fused_build")
    rng = np.random.default_rng(53)
    pos, nrm = _cloud_batch(rng, 2, n, cuda)
    xb, yb = build_tangent_basis(nrm)
    idx, md = ops.knn_topk(pos, k, True, return_mean_dist=True)
    mask = torch.ones(idx.shape, dtype=torch.bool, device=cuda)
    if masked:
        mask[:, :, k // 2:] = torch.rand((2, n, k - k // 2),
                                         device=cuda) > 0.3
    avg = md.mean(dim=1)
    reset_launch_counts()
    got = fb._fused_gather_wls(pos, nrm, xb, yb, idx, mask, avg,
                               slices=slices)
    again = fb._fused_gather_wls(pos, nrm, xb, yb, idx, mask, avg,
                                 slices=slices)
    torch.cuda.synchronize()
    name = "fused_gather_wls" + ("_direct" if slices == 0 else "")
    assert {m: v for m, v in launch_counts().items() if v} == {name: 2}
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    want = ops.fused_gather_wls_plain(pos, nrm, xb, yb, idx, mask, avg)
    for g, w in zip(got[:2], want[:2]):
        _close_to_max(g, w, 1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    edges = edge_planes(pos, nrm, xb, yb, idx, mask,
                        torch.ones((2, n), device=cuda))
    edges[:, 11] = avg[:, None, None]
    g, d = ops.wls(edges, 1.0, 1e-3)
    _close_to_max(got[0], g.transpose(2, 3), 1e-5)
    _close_to_max(got[1], d.transpose(2, 3), 1e-5)


@pytest.mark.parametrize("cloud", ["gauss", "grid"])
@pytest.mark.parametrize("b,n,k", [(2, 77, 20), (2, 1024, 20),
                                   (2, 1500, 20), (2, 2048, 30),
                                   (1, 8192, 20), (1, 8193, 20),
                                   (2, 2049, 1),
                                   (2, 300, 64), (2, 300, 80)])
@pytest.mark.parametrize("quantized", [True, False])
def test_knn_topk_mean_dist_kernel_exact(cuda, b, n, k, cloud, quantized):
    """The mean distances bit-equal to the plain version's (the same
    rounding of every term, summed in round order) and the ids equal to
    the kernel without them, at the model shapes, K = 1, the largest
    list (64) and the rounds route (80), on both clouds."""
    rng = np.random.default_rng(54)
    pos = torch.from_numpy(_knn_cloud(rng, b, n, cloud)).to(cuda)
    reset_launch_counts()
    idx, md = ops.knn_topk(pos, k, quantized, return_mean_dist=True)
    name = "knn_topk_rounds" if k > 64 else "knn_topk_mean_dist"
    assert launch_counts()[name] == 1
    want_idx, want_md = ops.knn_topk_plain(pos, k, quantized, True)
    assert torch.equal(idx, want_idx) and torch.equal(md, want_md)
    assert torch.equal(idx, ops.knn_topk(pos, k, quantized))


@pytest.mark.parametrize("dense,train", [(True, False), (True, True),
                                         (False, False)])
def test_position_gradients_kernels_match_plain(cuda, dense, train):
    """``d loss / d pos`` and ``d loss / d normal`` of a narrow f32 model
    through the kernels and through the plain versions on the card, within
    1e-3 x max (the train steps' gradient bound), the loss at rtol 1e-5;
    the build's backward kernels launch once each and ``coef_cotangent``
    once an apply (8), dense or coefficient form; ``densify_bwd`` never
    (the dense operators carry no graph)."""
    rng = np.random.default_rng(55)
    model = DeltaNetClassification(
        5, conv_channels=(8, 8, 16, 16), embedding_size=32, num_neighbors=8,
        dropout=0.0, dense_operators=dense,
        generator=torch.Generator().manual_seed(0)).to(cuda)
    model.train(train)
    pos, nrm = _cloud_batch(rng, 4, 128, cuda)
    labels = torch.tensor([0, 1, 2, 3], device=cuda)
    out = {}
    for route in (KERNEL_OPS, PLAIN_OPS):
        p = pos.clone().requires_grad_()
        q = nrm.clone().requires_grad_()
        reset_launch_counts()
        loss = torch.nn.functional.cross_entropy(
            model(p, q, ops=route), labels)
        loss.backward()
        out[route is KERNEL_OPS] = (float(loss), p.grad, q.grad,
                                    launch_counts())
    loss, gp, gn, counts = out[True]
    assert counts["wls_bwd"] == 1
    assert counts["coef_cotangent"] == 8
    assert counts["densify_bwd"] == 0
    assert sum(out[False][3].values()) == 0
    assert loss == pytest.approx(out[False][0], rel=1e-5)
    _close_to_max(gp, out[False][1], 1e-3)
    _close_to_max(gn, out[False][2], 1e-3)


# -- the neighbour min/max (gather_minmax #10, gather_matmul_minmax #13) -------


def _minmax_graph(rng, n, k, dev):
    """``_rand_graph`` plus a row with one valid slot (1, 7), where the max
    and the min win at the same slot."""
    idx, mask = _rand_graph(rng, n, k, dev)
    mask[1, 7] = False
    mask[1, 7, 2] = True
    return idx, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 64, 300])
def test_gather_minmax_kernels_exact(cuda, c, dtype):
    """``gather_minmax`` and ``gather_minmax_win`` (the ``_bf16`` bodies for
    bf16, odd C on one-channel loads): values, in the input's dtype, and
    first winners equal to the plain versions, ties from repeated indices
    and coarse values included; (-3e38, +3e38) and winners 0 where no slot
    is valid; the one-slot row's two winners the same slot."""
    rng = np.random.default_rng(60)
    n, k = 150, 9
    h = torch.from_numpy(np.round(rng.standard_normal((2, n, c)) * 8).astype(
        np.float32)).to(cuda).to(dtype)
    idx, mask = _minmax_graph(rng, n, k, cuda)
    got = ops.gather_minmax(h, idx, mask)
    want = ops.gather_minmax_plain(h, idx, mask)
    got_w = ops.gather_minmax_win(h, idx, mask)
    want_w = ops.gather_minmax_win_plain(h, idx, mask)
    torch.cuda.synchronize()
    for g, w in zip(got + got_w, want + want_w):
        assert g.dtype == w.dtype
        assert torch.equal(g, w), int((g != w).sum())
    assert got[0].dtype == dtype
    sentinels = torch.tensor([NEG, -NEG], device=cuda).to(dtype)
    assert bool((got[0][0, 4] == sentinels[0]).all())
    assert bool((got[1][0, 4] == sentinels[1]).all())
    assert not got_w[2][0, 4].any() and not got_w[3][0, 4].any()
    assert torch.equal(got_w[2][1, 7], got_w[3][1, 7])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 64, 300])
def test_gather_minmax_bwd_kernel(cuda, c, dtype):
    """The two-map backward (``gather_minmax_bwd``, ``_bf16`` for bf16
    cotangents) bit-equal to the plain version and across two calls (the
    f64 sums do not depend on the atomics' order), and equal to two
    one-map backwards summed within 1e-5 x max (each of those rounds on
    its own)."""
    rng = np.random.default_rng(61)
    n, k = 150, 9
    h = torch.from_numpy(np.round(rng.standard_normal((2, n, c)) * 8).astype(
        np.float32)).to(cuda)
    idx, mask = _minmax_graph(rng, n, k, cuda)
    _, _, wmx, wmn = ops.gather_minmax_win_plain(h, idx, mask)
    gmx = torch.randn((2, n, c), device=cuda).to(dtype)
    gmn = torch.randn((2, n, c), device=cuda).to(dtype)
    reset_launch_counts()
    dh = ops.gather_minmax_bwd(idx, wmx, gmx, wmn, gmn, n)
    name = "gather_minmax_bwd" + ("_bf16" if dtype == torch.bfloat16 else "")
    assert launch_counts()[name] == 1
    assert dh.dtype == torch.float32
    _bwd_exact(ops.gather_minmax_bwd, ops.gather_minmax_bwd_plain,
               (idx, wmx, gmx, wmn, gmn, n), dh)
    _close_to_max(dh, ops.gather_max_bwd(idx, wmx, gmx, n)
                  + ops.gather_max_bwd(idx, wmn, gmn, n), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_minmax_autograd_launches(cuda, dtype):
    """Differentiated, ``ops.gather_minmax`` launches ``gather_minmax_win``
    and ``gather_minmax_bwd`` once each (the ``_bf16`` bodies for bf16),
    without grad ``gather_minmax`` once; the gradient equals the plain
    route's (integer cotangents: exact sums in any order) and is in
    ``h``'s dtype."""
    rng = np.random.default_rng(62)
    n, k, c = 120, 8, 40
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    h = torch.randn((2, n, c), device=cuda).to(dtype)
    idx, mask = _minmax_graph(rng, n, k, cuda)
    g1 = torch.randint(-4, 5, (2, n, c), device=cuda).to(dtype)
    g2 = torch.randint(-4, 5, (2, n, c), device=cuda).to(dtype)
    grads = []
    for fn in (ops.gather_minmax, ops.gather_minmax_plain):
        reset_launch_counts()
        hg = h.clone().requires_grad_()
        torch.autograd.backward(fn(hg, idx, mask), (g1, -2 * g2))
        counts = {name: c for name, c in launch_counts().items() if c}
        if fn is ops.gather_minmax:
            assert counts == {f"gather_minmax_win{suffix}": 1,
                              f"gather_minmax_bwd{suffix}": 1}, counts
        else:
            assert counts == {}, counts
        assert hg.grad.dtype == dtype
        grads.append(hg.grad)
    assert torch.equal(*grads)
    reset_launch_counts()
    ops.gather_minmax(h, idx, mask)
    assert {k_: v for k_, v in launch_counts().items() if v} == {
        f"gather_minmax{suffix}": 1}


def _mm_minmax_held(got, x, w, idx, mask):
    """Both outputs of the matmul min/max held by ``_mm_max_held``: the
    max as it is, the min as the max of ``x @ (-w)`` negated (negating
    bf16 values is exact). Returns the far ratios and valid counts."""
    far_mx, valid = _mm_max_held(got[0], x, w, idx, mask)
    far_mn, _ = _mm_max_held(-got[1], x, -w, idx, mask)
    return far_mx + far_mn, 2 * valid


@pytest.mark.parametrize("c_in,c_out", [(128, 256), (24, 40)])
def test_gather_matmul_minmax_kernel(cuda, c_in, c_out):
    """Each output within one bf16 ulp of the plain version, or near zero
    within the f32 summation bound of the exact (f64) value
    (``_mm_minmax_held``); bit-equal on inputs whose sums are exact in
    any order; (-3e38, +3e38) rounded to bf16 where no slot is valid;
    ``C_out`` = 40 pads to 48 and is cut back. Forward only: an input
    that requires grad is refused."""
    rng = np.random.default_rng(63)
    gen = torch.Generator(device=cuda).manual_seed(63)
    n, k = 150, 9
    idx, mask = _minmax_graph(rng, n, k, cuda)
    x = torch.randn((2, n, c_in), device=cuda, generator=gen).to(
        torch.bfloat16)
    w = (torch.randn((c_in, c_out), device=cuda, generator=gen) / 8).to(
        torch.bfloat16)
    reset_launch_counts()
    got = ops.gather_matmul_minmax(x, w, idx, mask)
    assert launch_counts()["gather_matmul_minmax"] == 1
    assert all(g.shape == (2, n, c_out) and g.dtype == torch.bfloat16
               for g in got)
    _mm_minmax_held(got, x, w, idx, mask)
    sentinels = torch.tensor([NEG, -NEG], device=cuda).to(torch.bfloat16)
    assert bool((got[0][0, 4] == sentinels[0]).all())
    assert bool((got[1][0, 4] == sentinels[1]).all())
    xe = (torch.randint(-32, 33, (2, n, c_in), device=cuda, generator=gen)
          / 8.0).to(torch.bfloat16)
    we = (torch.randint(-16, 17, (c_in, c_out), device=cuda, generator=gen)
          / 16.0).to(torch.bfloat16)
    for g, wv in zip(ops.gather_matmul_minmax(xe, we, idx, mask),
                     ops.gather_matmul_minmax_plain(xe, we, idx, mask)):
        assert torch.equal(_bits(g), _bits(wv))
    with pytest.raises(ValueError, match="forward only"):
        ops.gather_matmul_minmax(x.clone().requires_grad_(), w, idx, mask)


def test_matmul_minmax_seed_sweep(cuda):
    """``gather_matmul_minmax`` over 200 seeds at the shapes of
    ``test_matmul_max_seed_sweep`` (x ~ N(0, 1), w ~ N(0, 1/64) in bf16),
    both outputs held by ``_mm_minmax_held``: every output more than one
    bf16 ulp from the plain version is an extreme near zero, within 1e-4
    of its row's ``max(|x| @ |w|)``. Prints the counts (``pytest -s``)."""
    n, k, c_in, c_out = 150, 9, 128, 256
    ratios, outputs, seeds = [], 0, []
    for seed in range(200):
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=cuda).manual_seed(seed)
        idx, mask = _rand_graph(rng, n, k, cuda)
        x = torch.randn((2, n, c_in), device=cuda, generator=gen).to(
            torch.bfloat16)
        w = (torch.randn((c_in, c_out), device=cuda, generator=gen) / 8).to(
            torch.bfloat16)
        far, valid = _mm_minmax_held(ops.gather_matmul_minmax(x, w, idx, mask),
                                     x, w, idx, mask)
        ratios += far
        outputs += valid
        seeds += [seed] if far else []
    print(f"\ngather_matmul_minmax: {len(ratios)} of {outputs} outputs beyond "
          f"one bf16 ulp, in {len(seeds)} of 200 seeds, largest |exact| / "
          f"max(|x| @ |w|) {max(ratios, default=0.0)}")
    assert max(ratios, default=0.0) <= 1e-4


@pytest.mark.parametrize("dense", [True, False])
def test_minmax_hooks_kernels_match_plain(cuda, dense):
    """The hooks on an operator object built on the card (one cloud
    padded): ``nbr_minmax`` f32 and bf16 and its gradient, and
    ``nbr_matmul_minmax``, through the kernels and through the plain
    versions (``dataclasses.replace`` of ``ops``): values equal, the
    gradient within 1e-5 x max (atomics), the matmul form held by
    ``_mm_minmax_held``; one launch of each kernel a call."""
    rng = np.random.default_rng(64)
    pos, nrm = _cloud_batch(rng, 2, 128, cuda)
    pm = torch.ones((2, 128), dtype=torch.bool, device=cuda)
    pm[1, 90:] = False
    gd = build_operators(pos, 10, nrm, pm, dense_operators=dense)
    gp = dataclasses.replace(gd, ops=PLAIN_OPS)
    for dt in (torch.float32, torch.bfloat16):
        h = torch.randn((2, 128, 48), device=cuda).to(dt)
        reset_launch_counts()
        got = gd.nbr_minmax(h)
        suffix = "_bf16" if dt == torch.bfloat16 else ""
        assert launch_counts()[f"gather_minmax{suffix}"] == 1
        for g, w in zip(got, gp.nbr_minmax(h)):
            assert torch.equal(g, w)
    h = torch.randn((2, 128, 48), device=cuda)
    g1, g2 = torch.randn((2, 2, 128, 48), device=cuda)
    grads = []
    for op in (gd, gp):
        hg = h.clone().requires_grad_()
        torch.autograd.backward(op.nbr_minmax(hg), (g1, g2))
        grads.append(hg.grad)
    _close_to_max(*grads, 1e-5)
    x = torch.randn((2, 128, 64), device=cuda)
    w = torch.randn((64, 96), device=cuda) / 8
    got = gd.nbr_matmul_minmax(x, w)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    _mm_minmax_held(got, xb, wb, gd.nbr_idx, gd.nbr_mask)
    for g, wv in zip(gp.nbr_matmul_minmax(x, w),
                     ops.gather_matmul_minmax_plain(xb, wb, gd.nbr_idx,
                                                    gd.nbr_mask)):
        assert torch.equal(g, wv)


# -- the min/max's routes: #10's S and D, #13's rows and K-fold ---------------


# (b, n, c, k, off, dtype): the hooks' widths at the classification shape
# (f32 C = 64, 128, 256; bf16 64, 128: 128-byte rows, split tasks at C=64),
# odd widths (one-by-one stores), a view one element past a 16-byte
# boundary (narrower copies), the large clouds' 16-byte rows, and both
# sides of route S's last cloud (14,526 points).
MINMAX_ROUTE_CASES = [
    (4, 1024, 64, 20, 0, torch.float32), (4, 1024, 128, 20, 0, torch.float32),
    (4, 1024, 256, 20, 0, torch.float32), (4, 1024, 64, 20, 0, torch.bfloat16),
    (4, 1024, 128, 20, 0, torch.bfloat16), (2, 150, 3, 9, 0, torch.float32),
    (2, 150, 301, 9, 0, torch.bfloat16), (2, 150, 70, 20, 1, torch.float32),
    (2, 150, 70, 30, 1, torch.bfloat16), (1, 8192, 64, 20, 0, torch.float32),
    (1, 14526, 64, 20, 0, torch.bfloat16),
    (1, 14527, 64, 20, 0, torch.float32)]


@pytest.mark.parametrize("graph", ["knn", "hard"])
@pytest.mark.parametrize("winners", [False, True])
@pytest.mark.parametrize("b,n,c,k,off,dtype", MINMAX_ROUTE_CASES)
def test_gather_minmax_routes_exact(cuda, b, n, c, k, off, dtype, winners,
                                    graph):
    """``gather_minmax`` (and with winners ``gather_minmax_win``) through
    the route by shape (route S, the staged min/max, up to 14,526 points)
    and route D (forced), on a kNN graph and on hard rows (no valid slot, a
    masked slot 0, valid ids outside the cloud in slot 0 and in the last
    slot, a row whose slots all read one row, a NaN feature): values and
    winners bit-equal to the plain version (a NaN's payload aside), route
    S to route D, and a second call to the first; (-3e38, +3e38) and
    winners 0 where no slot is valid; the launches show the route."""
    rng = np.random.default_rng(n + c + k + off)
    pos, _ = _cloud_batch(rng, b, n, cuda)
    idx, mask = knn(pos, k)
    vals = torch.from_numpy(np.round(rng.standard_normal((b, n, c)) * 4)
                            .astype(np.float32)).to(cuda, dtype)
    store = torch.empty(b * n * c + off, dtype=dtype, device=cuda)
    h = store[off:].view(b, n, c)
    h.copy_(vals)
    if graph == "hard":
        mask[0, 4] = False  # no valid slot
        mask[0, 6, 0] = False  # a masked slot 0
        idx[0, 5, 0] = n + 3  # valid, outside the cloud
        idx[-1, 6, k - 1], mask[-1, 6, k - 1] = -1, True
        idx[-1, 8], mask[-1, 8] = 7, True  # every slot one row: all tie
        h[0, 7, c // 2] = float("nan")
    name = ("gather_minmax_win" if winners else "gather_minmax") + (
        "_bf16" if dtype == torch.bfloat16 else "")
    staged = _GM.max_slice(b, n, c, h.element_size(), k, 132, winners)[0] > 0
    assert staged == (n <= 14526)
    want = _zero_row_want(ops.gather_minmax_win_plain, h, idx, mask)
    got = {}
    for route, launched in ((None, name if staged else f"{name}_direct"),
                            ((0, 0), f"{name}_direct")):
        runs = []
        for _ in range(2):
            reset_launch_counts()
            runs.append(_GM._gather_minmax_win(h, idx, mask, route)
                        if winners else _GM._minmax(h, idx, mask, route))
            torch.cuda.synchronize()
            counts = {m: v for m, v in launch_counts().items() if v}
            assert counts == {launched: 1}, counts
        for first, again in zip(*runs):  # the same bits, NaN included
            raw = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
            assert torch.equal(first.view(raw.get(first.dtype, first.dtype)),
                               again.view(raw.get(again.dtype, again.dtype)))
        got[route] = runs[0]
    for outs in got.values():
        assert len(outs) == (4 if winners else 2)
        for o, w in zip(outs[:2], want[:2]):
            assert o.dtype == dtype
            _same_values(o, w)
        if winners:
            assert torch.equal(outs[2], want[2]), int((outs[2] != want[2])
                                                      .sum())
            assert torch.equal(outs[3], want[3]), int((outs[3] != want[3])
                                                      .sum())
    for s_out, d_out in zip(*got.values()):
        _same_values(s_out, d_out)
    mx, mn = got[None][:2]
    sentinels = torch.tensor([NEG, -NEG]).to(dtype).float()
    if graph == "hard":
        assert bool((mx[0, 4].float() == sentinels[0]).all())
        assert bool((mn[0, 4].float() == sentinels[1]).all())
        if winners:
            wmx, wmn = got[None][2:]
            assert not wmx[0, 4].any() and not wmn[0, 4].any()
            assert not wmx[-1, 8].any() and not wmn[-1, 8].any()
            num = ~torch.isnan(mx[0, 6].float())  # the NaN's winner is 0
            assert bool((wmx[0, 6][num] > 0).all())
            assert bool((wmn[0, 6][num] > 0).all())


@pytest.mark.parametrize("b,n,c_in,c_out", [
    (2, 150, 128, 256), (2, 150, 24, 40), (2, 1000, 200, 256),
    (32, 1024, 128, 256), (1, 10038, 128, 256), (1, 10039, 128, 256)])
def test_gather_matmul_minmax_routes(cuda, b, n, c_in, c_out):
    """The matmul min/max through the route by shape (one product a row up
    to 10,038 points at C_in = 128) and through the K-fold route
    (``gather_matmul_minmax_kfold``): both outputs held by
    ``_mm_minmax_held`` on random inputs, bit-equal to the plain version
    on exact-sum inputs, the two routes bit-equal to each other (the same
    tensor-core sums in the same order), (-3e38, +3e38) in bf16 on rows
    with no valid slot, a second call bit-equal; the launches show the
    route."""
    rng = np.random.default_rng(b + n + c_in + 1)
    k = 20 if n >= 1000 else 9
    idx, mask = _mm_graph(rng, b, n, k, cuda)
    x, w = _mm_random(rng, b, n, c_in, c_out, cuda)
    xe, we = _mm_exact(rng, b, n, c_in, c_out, cuda)
    rows = _GM.mm_slice(b, n, -(-c_in // 16) * 16, -(-c_out // 16) * 16, k,
                        132) > 0
    assert rows == (n <= 10038)
    got = {}
    for cs, launched in ((None, "" if rows else "_kfold"), (0, "_kfold")):
        reset_launch_counts()
        got[cs] = _GM._gather_matmul_minmax(x, w, idx, mask, cs)
        again = _GM._gather_matmul_minmax(x, w, idx, mask, cs)
        exact = _GM._gather_matmul_minmax(xe, we, idx, mask, cs)
        torch.cuda.synchronize()
        counts = {m: v for m, v in launch_counts().items() if v}
        assert counts == {f"gather_matmul_minmax{launched}": 3}, counts
        for g, a in zip(got[cs], again):
            assert g.dtype == torch.bfloat16 and g.shape == (b, n, c_out)
            assert torch.equal(_bits(g), _bits(a))
        _mm_minmax_held(got[cs], x, w, idx, mask)
        for g, wv in zip(exact, ops.gather_matmul_minmax_plain(xe, we, idx,
                                                               mask)):
            assert torch.equal(_bits(g), _bits(wv))
        sentinels = torch.tensor([NEG, -NEG], device=cuda).to(torch.bfloat16)
        for o, sent in zip(got[cs], sentinels):
            assert bool((o[0, 4] == sent).all())
            assert bool((o[:, -1] == sent).all())
    for a, kf in zip(got[None], got[0]):
        assert torch.equal(_bits(a), _bits(kf))


# -- the neighbour max's two routes: S (a staged slice), D (direct) -----------


def _zero_row_want(plain, h, idx, mask):
    """``plain(h, idx, mask)`` where ids outside [0, N) gather 0: the plain
    version on ``h`` with a zero row appended (and a point with no valid
    slot, dropped after), those ids pointed at it."""
    b, n, c = h.shape
    k = idx.shape[-1]
    hp = torch.cat([h, torch.zeros((b, 1, c), dtype=h.dtype,
                                   device=h.device)], dim=1)
    ids = torch.where((idx < 0) | (idx >= n), n, idx)
    ids = torch.cat([ids, torch.zeros((b, 1, k), dtype=idx.dtype,
                                      device=idx.device)], dim=1)
    valid = torch.cat([mask, torch.zeros((b, 1, k), dtype=torch.bool,
                                         device=mask.device)], dim=1)
    return tuple(o[:, :n] for o in plain(hp, ids, valid))


def _same_values(got, want):
    """Equal as numbers (+0 and -0 tie), NaN where the other is NaN."""
    nan = torch.isnan(got.float())
    assert torch.equal(nan, torch.isnan(want.float()))
    assert torch.equal(torch.where(nan, 0.0, got.float()),
                       torch.where(nan, 0.0, want.float()))


# (b, n, c, k, off): widths 1 .. 301, K = 1, 9, 20, 30, views whose data
# start one element past a 16-byte boundary (off 1), and N at the model
# shapes and on both sides of each slice boundary: 128-byte rows up to
# 1814 points, 64 up to 3630, 32 up to 7262, 16 up to 14,526 (route D
# above).
MAX_CASES = [
    (2, 150, 1, 9, 0), (2, 150, 3, 9, 0), (2, 150, 64, 20, 0),
    (2, 150, 70, 20, 0), (2, 150, 128, 30, 0), (2, 150, 256, 20, 0),
    (2, 150, 301, 9, 0), (2, 150, 64, 1, 0), (2, 150, 70, 20, 1),
    (2, 150, 128, 20, 1), (2, 150, 3, 30, 1), (4, 1024, 64, 20, 0),
    (4, 1024, 256, 20, 0), (1, 1814, 256, 20, 0), (1, 1815, 256, 20, 0),
    (2, 2048, 128, 30, 0), (1, 3631, 128, 20, 0), (1, 7262, 64, 20, 0),
    (1, 7263, 64, 20, 0), (1, 8192, 64, 20, 0), (1, 8192, 256, 20, 1),
    (1, 14526, 64, 20, 0), (1, 14527, 64, 20, 0)]


@pytest.mark.parametrize("route", ["shape", "D"])
@pytest.mark.parametrize("body", ["f32", "f32 winners", "bf16",
                                  "bf16 winners"])
@pytest.mark.parametrize("b,n,c,k,off", MAX_CASES)
def test_gather_max_routes_exact(cuda, b, n, c, k, off, body, route):
    """Each body of the neighbour max (f32, f32 with winners, bf16, bf16
    with winners) through the route by shape (route S up to 14,526
    points) and through route D, bit-equal to the plain version: ties
    (values on a coarse grid: the first slot wins), a NaN (it propagates
    with winner 0 and sticks), a row with no valid slot (-3e38, rounded
    to bf16 in bf16, winner 0), ids outside [0, N) (they gather 0); the
    launches show the route."""
    rng = np.random.default_rng(n + c + k + off)
    dtype = torch.bfloat16 if body.startswith("bf16") else torch.float32
    winners = body.endswith("winners")
    vals = torch.from_numpy(np.round(rng.standard_normal((b, n, c)) * 4)
                            .astype(np.float32)).to(cuda, dtype)
    store = torch.empty(b * n * c + off, dtype=dtype, device=cuda)
    h = store[off:].view(b, n, c)
    h.copy_(vals)
    h[0, 7, c // 2] = float("nan")
    idx = torch.from_numpy(
        rng.integers(0, n, (b, n, k)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((b, n, k)) > 0.3).to(cuda)
    mask[0, 4] = False  # no valid neighbour
    idx[0, 5, 0], mask[0, 5, 0] = n + 3, True  # outside the cloud
    idx[-1, 6, k - 1], mask[-1, 6, k - 1] = -1, True
    idx[-1, 8], mask[-1, 8, 0] = 7, True  # every slot one row: all tie
    name = ("gather_max_win" if winners else "gather_max") + (
        "_bf16" if dtype == torch.bfloat16 else "")
    forced = None if route == "shape" else (0, 0)
    reset_launch_counts()
    if winners:
        out, win = _GM._gather_max_win(h, idx, mask, forced)
    else:
        out = _GM._max(h, idx, mask, forced)
    torch.cuda.synchronize()
    counts = launch_counts()
    staged = route == "shape" and _GM.max_slice(
        b, n, c, h.element_size(), k, 132, winners)[0] > 0
    assert staged == (route == "shape" and n <= 14526)
    launched = name if staged else f"{name}_direct"
    other = f"{name}_direct" if staged else name
    assert counts[launched] == 1 and counts[other] == 0, counts
    want, want_win = _zero_row_want(ops.gather_max_win_plain, h, idx, mask)
    assert out.dtype == dtype
    _same_values(out, want)
    assert bool((out[0, 4].float() == torch.tensor(NEG).to(dtype).float())
                .all())
    if winners:
        assert torch.equal(win, want_win), int((win != want_win).sum())
        assert not win[0, 4].any() and not win[-1, 8].any()


@pytest.mark.parametrize("route", ["shape", "kfold"])
@pytest.mark.parametrize("b,n,c_in,c_out", [
    (2, 150, 128, 256), (2, 150, 24, 40), (2, 1000, 200, 256),
    (32, 1024, 128, 256), (1, 10166, 128, 256), (1, 10167, 128, 256)])
def test_gather_matmul_max_int8_routes(cuda, b, n, c_in, c_out, route):
    """The int8 matmul max through the route by shape (one product a row
    up to 10,166 points at C_in = 128, int8 rows widened once a tile) and
    through the K-fold route: held by ``_mm_max_held`` on random weights,
    bit-equal to the plain version on exact-sum weights, the two routes
    bit-equal to each other (the same tensor-core sums in the same
    order), -3e38 on rows with no valid slot; the launches show the
    route."""
    rng = np.random.default_rng(b + n + c_in)
    gen = torch.Generator(device=cuda).manual_seed(b + n)
    k = 20 if n >= 1000 else 9
    idx, mask = _mm_graph(rng, b, n, k, cuda)
    xq = torch.randint(-127, 128, (b, n, c_in), device=cuda, generator=gen,
                       dtype=torch.int8)
    w = (torch.randn((c_in, c_out), device=cuda, generator=gen) / 64).to(
        torch.bfloat16)
    we = (torch.randint(-16, 17, (c_in, c_out), device=cuda, generator=gen)
          / 16.0).to(torch.bfloat16)
    cs = None if route == "shape" else 0
    rows = route == "shape" and _GM.mm_slice(
        b, n, -(-c_in // 16) * 16, -(-c_out // 16) * 16, k, 132, 1) > 0
    assert rows == (route == "shape" and n <= 10166)
    reset_launch_counts()
    got = _GM._gather_matmul_max_int8(xq, w, idx, mask, cs)
    exact = _GM._gather_matmul_max_int8(xq, we, idx, mask, cs)
    torch.cuda.synchronize()
    counts = launch_counts()
    sfx, other = ("", "_kfold") if rows else ("_kfold", "")
    assert counts[f"gather_matmul_max_int8{sfx}"] == 2, counts
    assert counts[f"gather_matmul_max_int8{other}"] == 0, counts
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, c_out)
    _mm_max_held(got, xq, w, idx, mask)
    assert torch.equal(_bits(exact), _bits(
        ops.gather_matmul_max_int8_plain(xq, we, idx, mask)))
    neg = torch.tensor(NEG).to(torch.bfloat16).float()
    assert bool((got[0, 4].float() == neg).all())
    assert bool((got[:, -1].float() == neg).all())
    if rows:
        assert torch.equal(_bits(got), _bits(
            _GM._gather_matmul_max_int8(xq, w, idx, mask, 0)))


def _edge_mlp_exact(rng, n, k, c0, c1, masked, dev):
    """Edge MLP inputs whose sums are exact in f32 in any order: ``y`` in
    steps of 1/8 up to 4, ``a0`` and ``b0`` in steps of 1/8, ``w1`` in
    steps of 1/16 up to 1, and the integer cotangent ``g`` up to 4; so
    ``dh = g @ w1^T`` and every value before a rounding point of the plain
    version are the kernel's, bit for bit."""
    *_, idx = _edge_mlp_inputs(rng, n, k, c0, c1, masked, dev)

    def steps(shape, top, step):
        return torch.from_numpy(
            rng.integers(-top, top + 1, shape) * step).float().to(dev)

    y = steps((2, n, c0), 32, 1 / 8).to(torch.bfloat16)
    a0, b0 = steps(c0, 16, 1 / 8), steps(c0, 8, 1 / 8)
    w1 = steps((c0, c1), 16, 1 / 16)
    g = steps((2, k, n, c1), 4, 1.0).to(torch.bfloat16)
    return y, a0, b0, w1, idx, g


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("c0,c1", [(12, 12), (64, 64), (128, 128)])
def test_edge_mlp_dy_is_repeatable_and_exact(cuda, c0, c1, masked):
    """``edge_delta_mlp_bwd``'s ``dy`` sums in f64 and rounds once: the
    same bits in two calls on random inputs, and bit-equal to the plain
    version (which sums in f64 too) where their rounding points see the
    same values (exact-sum inputs); at C0 = C1 = 128 the backward's block
    still fits its shared memory."""
    rng = np.random.default_rng(97 + c0)
    n, k = 150, 11
    y, a0, b0, w1, z0, idx = _edge_mlp_inputs(rng, n, k, c0, c1, masked,
                                              cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    g = torch.randn((2, k, n, c1), device=cuda, generator=gen).to(
        torch.bfloat16)
    first = ops.edge_mlp_bwd(y, a0, b0, w1, idx, g)
    again = ops.edge_mlp_bwd(y, a0, b0, w1, idx, g)
    torch.cuda.synchronize()
    for got, want in zip(first, again):
        assert torch.equal(got, want)
    y, a0, b0, w1, idx, g = _edge_mlp_exact(rng, n, k, c0, c1, masked, cuda)
    dy, _, _ = ops.edge_mlp_bwd(y, a0, b0, w1, idx, g)
    dy_p, _, _ = ops.edge_mlp_bwd_plain(y, a0, b0, w1, idx, g)
    torch.cuda.synchronize()
    assert torch.equal(dy, dy_p), float((dy - dy_p).abs().max())


# The redesigned edge MLP's kernels one by one: the forward, the backward's
# phase 1 (edge tensor, self rows, partials) and phase 2 (the sum over the
# inverse adjacency of the clamped indices).
EDGE_WIDTHS = [(12, 12), (64, 64), (128, 128)]
EDGE_N = 77  # a last tile of 13 points


def _out_of_range(rng, idx, n):
    """``idx`` with a tenth of its slots >= 1 moved outside ``[0, N)``:
    negative ones (read from the end, then clamped) and ones from N up
    (clamped)."""
    k = idx.shape[-1]
    if k == 1:
        return idx
    sel = rng.random(tuple(idx.shape)) < 0.1
    sel[..., 0] = False
    far = rng.integers(-2 * n, 2 * n, tuple(idx.shape)).astype(np.int32)
    far = np.where((far >= 0) & (far < n), far + n, far)
    return torch.where(torch.from_numpy(sel).to(idx.device),
                       torch.from_numpy(far).to(idx.device), idx)


@pytest.mark.parametrize("k", [1, 30])
@pytest.mark.parametrize("c0,c1", EDGE_WIDTHS)
def test_edge_mlp_fwd_kernel_shapes(cuda, c0, c1, k):
    """The forward at N=77 (a last tile of 13 points), K=1 (slot 0 alone)
    and K=30, widths 12 (padded to 16), 64 and 128, indices outside [0, N):
    one launch, held by ``_edge_fwd_held`` (slot 0 bit-equal to
    ``bf16(z0)``)."""
    rng = np.random.default_rng(110 + c0 + k)
    y, a0, b0, w1, z0, idx = _edge_mlp_inputs(rng, EDGE_N, k, c0, c1, True,
                                              cuda)
    idx = _out_of_range(rng, idx, EDGE_N)
    reset_launch_counts()
    out = ops.edge_mlp_fwd(y, a0, b0, w1, z0, idx)
    torch.cuda.synchronize()
    assert launch_counts()["edge_delta_mlp"] == 1
    assert out.dtype == torch.bfloat16 and out.shape == (2, k, EDGE_N, c1)
    _edge_fwd_held(out, y, a0, b0, w1, z0, idx)


def _edge_terms_held(e, y, a0, b0, w1, idx, g):
    """Phase 1's edge tensor held element by element as the forward's
    output is (``_edge_fwd_held``): each ``bf16(dy0)`` of slots >= 1
    within one bf16 ulp of the plain version's, or within the f32
    summation bound of ``dh = g @ w1^T``, ``C1 * 2^-24 * (|g| @ |w1|^T)``
    times ``|dpre / dh| |a0|``, plus one bf16 ulp, of the exact (f64) term
    of the same inputs (where ``dh`` cancels, its f32 sums in another order
    move the term by more than an ulp of itself)."""
    from deltaconv_tpu_torch.ops.edge_mlp import _edges

    want = ops.edge_mlp_bwd_edges_plain(y, a0, b0, w1, idx, g)[0][:, 1:]
    _, pre = _edges(y, a0, b0, idx)
    scale = (torch.where(pre[:, :, 1:] >= 0, 1.0, 0.2) * a0).double()
    g1 = g[:, 1:].double().permute(0, 2, 1, 3)
    wd = w1.to(torch.bfloat16).double()
    exact = ((g1 @ wd.t()) * scale).permute(0, 2, 1, 3)
    mag = ((g1.abs() @ wd.abs().t()) * scale.abs()).permute(0, 2, 1, 3)
    got = e[:, 1:].double()
    tol = w1.shape[1] * 2.0 ** -24 * mag + 2.0 ** -8 * got.abs()
    held = (_bf16_ulps(e[:, 1:], want) <= 1) | ((got - exact).abs() <= tol)
    assert bool(held.all()), f"{int((~held).sum())} elements beyond both"


@pytest.mark.parametrize("k", [1, 30])
@pytest.mark.parametrize("c0,c1", EDGE_WIDTHS)
def test_edge_mlp_bwd_edges_kernel(cuda, c0, c1, k):
    """Phase 1 (``edge_delta_mlp_bwd``: the edge tensor ``e``, the f64
    self rows, the partials of ``dw1`` and ``(da0, db0)``) against its
    plain version at N=77, K=1 and 30, indices outside [0, N). Random
    inputs: ``e``'s slots >= 1 held by ``_edge_terms_held`` (the f32 sums
    of ``dh`` run in another order), the self rows, ``dw1`` and ``(da0,
    db0)`` within 1e-5 x max. Exact-sum
    inputs (``_edge_mlp_exact``): ``e`` and the self rows bit-equal."""
    rng = np.random.default_rng(120 + c0 + k)
    y, a0, b0, w1, _, idx = _edge_mlp_inputs(rng, EDGE_N, k, c0, c1, True,
                                             cuda)
    idx = _out_of_range(rng, idx, EDGE_N)
    gen = torch.Generator(device=cuda).manual_seed(10)
    g = torch.randn((2, k, EDGE_N, c1), device=cuda, generator=gen).to(
        torch.bfloat16)
    reset_launch_counts()
    e, s, dw1, dab = ops.edge_mlp_bwd_edges(y, a0, b0, w1, idx, g)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["edge_delta_mlp_bwd"] == 1, counts
    assert counts["edge_delta_mlp_bwd_sum"] == 0, counts
    e_p, s_p, dw1_p, dab_p = ops.edge_mlp_bwd_edges_plain(y, a0, b0, w1, idx,
                                                          g)
    assert e.dtype == torch.bfloat16 and e.shape == (2, k, EDGE_N, c0)
    assert s.dtype == torch.float64 and s.shape == (2, EDGE_N, c0)
    _edge_terms_held(e, y, a0, b0, w1, idx, g)
    _close_to_max(s, s_p, 1e-5)
    _close_to_max(dw1, dw1_p, 1e-5)
    _close_to_max(dab, dab_p, 1e-5)

    y, a0, b0, w1, _, g = _edge_mlp_exact(rng, EDGE_N, k, c0, c1, True, cuda)
    e, s, _, _ = ops.edge_mlp_bwd_edges(y, a0, b0, w1, idx, g)
    e_p, s_p, _, _ = ops.edge_mlp_bwd_edges_plain(y, a0, b0, w1, idx, g)
    torch.cuda.synchronize()
    assert torch.equal(_bits(e[:, 1:]), _bits(e_p[:, 1:]))
    assert torch.equal(s, s_p)


@pytest.mark.parametrize("k", [1, 30])
@pytest.mark.parametrize("c0", [12, 64, 128])
def test_edge_mlp_bwd_sum_kernel(cuda, c0, k):
    """Phase 2 (the inverse adjacency in its clamp mode, then
    ``edge_delta_mlp_bwd_sum``) against its plain version on the same
    ``e`` and self rows (f32 values, so every sum is exact in f64): ``dy``
    bit-equal, and the same bits in a second call; indices outside [0, N);
    slot 0 of ``e`` is never read (NaN there)."""
    rng = np.random.default_rng(130 + c0 + k)
    *_, idx = _edge_mlp_inputs(rng, EDGE_N, k, c0, c0, True, cuda)
    idx = _out_of_range(rng, idx, EDGE_N)
    e = torch.from_numpy(rng.standard_normal((2, k, EDGE_N, c0)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    e[:, 0] = float("nan")
    s = torch.from_numpy(rng.standard_normal((2, EDGE_N, c0)).astype(
        np.float32)).double().to(cuda)
    reset_launch_counts()
    dy = ops.edge_mlp_bwd_sum(e, s, idx)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["edge_delta_mlp_bwd_sum"] == 1, counts
    assert counts["inverse_adjacency"] == 1, counts
    want = ops.edge_mlp_bwd_sum_plain(e.cpu(), s.cpu(), idx.cpu())
    assert dy.dtype == torch.float32 and dy.shape == (2, EDGE_N, c0)
    assert torch.equal(dy.cpu(), want), float((dy.cpu() - want).abs().max())
    assert torch.equal(ops.edge_mlp_bwd_sum(e, s, idx), dy)


def test_inverse_adjacency_clamp_mode_exact(cuda):
    """The inverse adjacency's clamp mode (the edge MLP's): indices read as
    JAX reads them (a negative one from the end, then clamped), so every
    edge is listed, ascending, under its row; equal to the plain version
    with ``clamp``, a hub row included."""
    rng = np.random.default_rng(62)
    n = 150
    idx = torch.from_numpy(
        rng.integers(-2 * n, 2 * n, (3, n, 9)).astype(np.int32)).to(cuda)
    idx[:, :, 1] = 3
    reset_launch_counts()
    got = ops.inverse_adjacency(idx, n, clamp=True)
    torch.cuda.synchronize()
    assert launch_counts()["inverse_adjacency"] == 1
    want = ops.inverse_adjacency_plain(idx, n, clamp=True)
    for a, w in zip(got, want):
        assert a.dtype == torch.int32
        assert torch.equal(a, w)
    assert bool((got[1] >= 0).all()) and bool((got[0][:, -1] == n * 9).all())


# -- the winner-routed backward's two routes: S (shared sums), D (direct) ----


def _bwd_case(rng, b, n, n_out, c, k, dtype, maps, dev):
    """idx rows in ``[0, min(N, n_out))`` and ``maps`` (winner, g) pairs
    whose sums are exact in f32 in any order (g on a 1/16 grid, |g| <
    8: exact in bf16 too), so the plain version and both routes see the
    same sums; the first cloud's winners put a run of points on one
    row."""
    idx = torch.from_numpy(rng.integers(0, min(n, n_out), (b, n, k))
                           .astype(np.int32)).to(dev)
    idx[0, :40, 0] = 3  # 40 points' slot 0 on row 3
    args = [idx]
    for _ in range(maps):
        win = torch.from_numpy(rng.integers(0, k, (b, n, c)).astype(
            np.int32)).to(dev)
        win[0, :40] = 0
        g = torch.from_numpy((rng.integers(-127, 128, (b, n, c)) / 16.0)
                             .astype(np.float32)).to(dev, dtype)
        args += [win, g]
    return args


# (b, N, n_out, C, K): widths 3 .. 301, n_out below and above N, and the
# model shapes' clouds (1024, 2048, 8192 points: one range or several).
BWD_CASES = [(2, 150, 150, 3, 9), (2, 150, 150, 64, 9),
             (2, 150, 150, 301, 9), (2, 1024, 1024, 64, 20),
             (2, 1024, 1024, 256, 20), (2, 1024, 700, 64, 20),
             (2, 700, 1024, 70, 20), (2, 2048, 2048, 128, 30),
             (1, 8192, 8192, 64, 20), (1, 8192, 8192, 256, 20)]


@pytest.mark.parametrize("maps", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,n_out,c,k", BWD_CASES)
def test_max_bwd_routes_exact(cuda, b, n, n_out, c, k, dtype, maps):
    """``gather_max_bwd`` (one map) and ``gather_minmax_bwd`` (two) through
    the route by shape (``bwd_slice``), route D and forced slices of 4
    channels over three ranges and of 32 over one or more: bit-equal to
    the plain version (f64 sums rounded once, exact-sum inputs) and to
    themselves in a second call; the launches show the route."""
    rng = np.random.default_rng(n + c + k + maps)
    args = _bwd_case(rng, b, n, n_out, c, k, dtype, maps, cuda)
    if maps == 1:
        plain, hook, name = (ops.gather_max_bwd_plain, _GM._gather_max_bwd,
                             "gather_max_bwd")
    else:
        plain, hook, name = (ops.gather_minmax_bwd_plain,
                             _GM._gather_minmax_bwd, "gather_minmax_bwd")
    if dtype == torch.bfloat16:
        name += "_bf16"
    want = plain(*args, n_out)
    chosen = _GM.bwd_slice(n_out, c)
    assert chosen[0] > 0  # every case here fits route S
    routes = [None, (0, 0), (4, -(-n_out // 3)),
              (32, min(n_out, _GM.SMEM_MAX // (32 * 8)))]
    for route in routes:
        reset_launch_counts()
        got = hook(*args, n_out, route)
        again = hook(*args, n_out, route)
        torch.cuda.synchronize()
        counts = launch_counts()
        launched = f"{name}_direct" if route == (0, 0) else name
        assert counts[launched] == 2 and sum(counts.values()) == 2, counts
        assert got.dtype == torch.float32 and got.shape == (b, n_out, c)
        assert torch.equal(got, want), (route, float((got - want).abs()
                                                     .max()))
        assert torch.equal(again, got), route
    assert want[0, 3].abs().sum() > 0


@pytest.mark.parametrize("b,n,c,dtype", [
    (2, 150, 3, torch.float32), (2, 5, 3, torch.bfloat16),
    (2, 150, 64, torch.bfloat16), (32, 1024, 128, torch.bfloat16),
    (32, 1024, 64, torch.float32), (4, 8192, 256, torch.float32),
    (3, 77, 301, torch.bfloat16)])
def test_absmax_kernel_exact(cuda, b, n, c, dtype):
    """``absmax``, the int8 max's per-cloud ``max |h|``, equals
    ``vector_norm(inf)`` (exact: a max), on widths whose clouds start off
    16 bytes (the one-value loads) and on aligned ones (16-byte loads); a
    cloud whose largest magnitude is negative; a NaN propagates to its
    own cloud only."""
    gen = torch.Generator(device=cuda).manual_seed(b * n + c)
    h = torch.randn((b, n, c), device=cuda, generator=gen).to(dtype)
    h[0, n // 2, c - 1] = -1000.0
    reset_launch_counts()
    got = _GM.absmax(h)
    torch.cuda.synchronize()
    assert launch_counts()["absmax"] == 1
    want = torch.linalg.vector_norm(h.float(), float("inf"), dim=(1, 2))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert float(got[0]) == 1000.0
    h[-1, 0, 0] = float("nan")
    got = _GM.absmax(h)
    assert bool(torch.isnan(got[-1])) and not bool(torch.isnan(got[:-1])
                                                   .any())


def _int8_case(rng, b, n, c, k, dtype, dev):
    """Features on a coarse grid with each cloud's largest magnitude 128,
    so ``v / a * 127`` hits the half-way points (+-64 -> +-63.5) and maxes
    tie; masked slots, a row with no valid slot, ids outside [0, N)."""
    h = torch.from_numpy((np.round(rng.standard_normal((b, n, c)) * 8) / 2)
                         .astype(np.float32)).to(dev)
    h = h.clamp(-100.0, 100.0)
    h[:, 0, 0] = 128.0
    h[:, 1, :3] = torch.tensor([64.0, -64.0, 0.5])
    h = h.to(dtype)
    idx = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(
        np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((b, n, k)) > 0.3).to(dev)
    mask[0, 4] = False  # no valid neighbour
    idx[:, 2, 0], mask[:, 2, 0] = 1, True  # gathers the half-way points
    idx[0, 5, 0], mask[0, 5, 0] = n + 3, True  # outside the cloud
    idx[-1, 6, k - 1], mask[-1, 6, k - 1] = -1, True
    return h, idx, mask


def _int8_want(h, idx, mask):
    """The plain version where ids outside [0, N) gather 0: on ``h`` with
    a zero row appended (its quantization unchanged), those ids pointed
    at it."""
    b, n, c = h.shape
    hp = torch.cat([h, torch.zeros((b, 1, c), dtype=h.dtype,
                                   device=h.device)], dim=1)
    ids = torch.where((idx < 0) | (idx >= n), n, idx)
    ids = torch.cat([ids, torch.zeros_like(ids[:, :1])], dim=1)
    valid = torch.cat([mask, torch.zeros_like(mask[:, :1])], dim=1)
    return ops.gather_max_int8_plain(hp, ids, valid)[:, :n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c,k", [(2, 150, 64, 9), (2, 150, 128, 20),
                                     (32, 1024, 64, 20),
                                     (32, 1024, 128, 20), (2, 150, 3, 9),
                                     (2, 150, 301, 9), (1, 14527, 64, 20)])
def test_gather_max_int8_routes_exact(cuda, b, n, c, k, dtype):
    """``gather_max_int8`` through route S (``absmax``, then the staged
    max with the quantizing epilogue) and route D (the quantization in
    torch ops, then the earlier kernel): bit-equal to the plain version
    (quantize, max, dequantize) and to each other, half-way points, ties,
    masked slots, a row with no valid slot (0) and ids outside the cloud
    (0) included; above route S's 14,526 points the route by shape is
    D."""
    rng = np.random.default_rng(b + n + c + k)
    h, idx, mask = _int8_case(rng, b, n, c, k, dtype, cuda)
    want = _int8_want(h, idx, mask)
    staged = _GM.max_slice(b, n, c, h.element_size(), k, 132)[0] > 0
    assert staged == (n <= 14526)
    for route, launched in ((None, ("absmax", "gather_max_int8") if staged
                             else ("gather_max_int8_direct",)),
                            ((0, 0), ("gather_max_int8_direct",))):
        reset_launch_counts()
        got = _GM._gather_max_int8(h, idx, mask, route)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert all(counts[m] == 1 for m in launched), counts
        assert sum(counts.values()) == len(launched), counts
        assert got.dtype == dtype
        assert torch.equal(got, want), (route, int((got != want).sum()))
        assert not got[0, 4].float().any()


# -- the bf16 eval max with the epilogue: route S (staged), route D ----------


def _affine_case(rng, b, n, c, k, dev):
    """bf16 features with a NaN in the last cloud, a graph with masked
    slots, a row with no valid slot, a masked slot 0 and ids outside the
    cloud (in slot 0 too), and an affine with slopes of both signs."""
    h = torch.from_numpy(rng.standard_normal((b, n, c)).astype(
        np.float32)).to(dev, torch.bfloat16)
    h[-1, 7, c // 2] = float("nan")
    idx = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(
        np.int32)).to(dev)
    idx[:, :, 0] = torch.arange(n, device=dev, dtype=torch.int32)
    mask = torch.from_numpy(rng.random((b, n, k)) > 0.3).to(dev)
    mask[0, 4] = False  # no valid neighbour
    mask[0, 6, 0] = False  # a masked slot 0: its row still self
    idx[0, 5, 0], mask[0, 5, 0] = n + 3, True  # outside the cloud
    idx[-1, 9, 0] = -2
    idx[-1, 6, k - 1], mask[-1, 6, k - 1] = -1, True
    inv = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(dev)
    aff = (torch.where(inv >= 0, 1.0, -1.0), inv,
           torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(dev),
           torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(dev))
    return h, idx, mask, aff


def _affine_want(h, idx, mask, aff, sub_self):
    """The plain version where ids outside [0, N) gather 0 (the self row
    included): on ``h`` with a zero row appended, those ids pointed at
    it."""
    b, n, c = h.shape
    hp = torch.cat([h, torch.zeros((b, 1, c), dtype=h.dtype,
                                   device=h.device)], dim=1)
    ids = torch.where((idx < 0) | (idx >= n), n, idx)
    ids = torch.cat([ids, torch.zeros_like(ids[:, :1])], dim=1)
    valid = torch.cat([mask, torch.zeros_like(mask[:, :1])], dim=1)
    return ops.gather_max_affine_plain(hp, ids, valid, aff, sub_self)[:, :n]


@pytest.mark.parametrize("sub_self", [False, True])
@pytest.mark.parametrize("b,n,c,k", [
    (2, 150, 3, 9), (2, 150, 64, 20), (2, 150, 70, 20), (2, 150, 301, 9),
    (32, 1024, 64, 20), (32, 1024, 128, 20), (16, 2048, 128, 30),
    (4, 8192, 64, 20), (4, 8192, 128, 20), (1, 14526, 64, 20),
    (1, 14527, 64, 20)])
def test_gather_max_affine_routes_exact(cuda, b, n, c, k, sub_self):
    """``gather_max_affine`` through the route by shape (route S up to
    14,526 points) and route D (forced): bit-equal to the plain version and to itself across two
    calls, on the model shapes and widths the 16-byte stores do not cover
    (3, 70, 301): a NaN propagates, a row with no valid slot gives 0, the
    self row is slot 0's whatever its mask, an id outside the cloud
    (slot 0's too) gathers 0; the launches show the route."""
    rng = np.random.default_rng(b + n + c + k)
    h, idx, mask, aff = _affine_case(rng, b, n, c, k, cuda)
    want = _affine_want(h, idx, mask, aff, sub_self)
    cs, _ = _GM.max_slice(b, n, c, 2, k, 132)
    assert (cs > 0) == (n <= 14526)
    for route, name in ((None, "gather_max_affine" if cs
                         else "gather_max_affine_direct"),
                        ((0, 0), "gather_max_affine_direct")):
        reset_launch_counts()
        got = _GM._gather_max_affine(h, idx, mask, aff, sub_self, route)
        again = _GM._gather_max_affine(h, idx, mask, aff, sub_self, route)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts[name] == 2 and sum(counts.values()) == 2, counts
        assert got.dtype == torch.bfloat16
        _same_values(got, want)
        assert torch.equal(_bits(got), _bits(again))
        assert not got[0, 4].float().any()


def _stable_top_k(scores, k):
    """XLA ``top_k`` on the host: the f32 scores' bits in their total
    order (-0.0 below +0.0), a stable argsort of their negation (equal
    scores lowest index first), cut to k."""
    bits = scores.view(np.int32)
    keys = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits).astype(np.int64)
    return np.argsort(-keys, axis=-1, kind="stable")[..., :k]


@pytest.mark.parametrize("k", [8, 10, 20])
@pytest.mark.parametrize("masked", [False, True])
def test_exact_knn_breaks_ties_as_xla(cuda, k, masked):
    """The exact kNN on square grids (exact distance ties on every row):
    the ids equal the stable-sort rule on the card's own scores, bit for
    bit, and two calls agree."""
    from deltaconv_tpu_torch.geometry.knn import exact_scores

    h = np.float32(2.0 / 31.0)
    u, v = np.meshgrid(np.arange(32, dtype=np.float32) * h - 1.0,
                       np.arange(32, dtype=np.float32) * h - 1.0)
    grid = np.stack([u.ravel(), v.ravel(), np.zeros(1024, np.float32)], -1)
    pos = torch.from_numpy(np.stack([grid, grid[::-1].copy()])).to(cuda)
    pm = None
    if masked:
        pm = torch.ones((2, 1024), dtype=torch.bool, device=cuda)
        pm[:, 700:] = False
        pm[:, ::5] = True
    idx, _ = knn(pos, k, pm)
    again, _ = knn(pos, k, pm)
    assert torch.equal(idx, again)
    want = _stable_top_k(exact_scores(pos, pm).cpu().numpy(), k)
    np.testing.assert_array_equal(np.where(
        _graph_valid(want, pm), want, np.arange(1024)[None, :, None]),
        idx.cpu().numpy())


def _graph_valid(ids, pm):
    """The slots a masked kNN keeps (the others are clamped to self)."""
    if pm is None:
        return np.ones(ids.shape, bool)
    valid = pm.cpu().numpy()
    return np.take_along_axis(valid[:, None, :].repeat(ids.shape[1], 1),
                              ids, axis=-1)


def _surface_cloud(rng, n):
    """One cloud ``[N, 3]`` on a random quadratic height field with its
    analytic frames."""
    uv = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    c = rng.random(5).astype(np.float32)
    f = c[0] * uv[:, 0] + c[1] * uv[:, 1] + c[2] * uv[:, 0] ** 2 \
        + c[3] * uv[:, 0] * uv[:, 1] + c[4] * uv[:, 1] ** 2
    pos = np.concatenate([uv, f[:, None]], 1).astype(np.float32)
    fx = np.stack([np.ones(n), np.zeros(n), c[0] + 2 * c[2] * uv[:, 0]
                   + c[3] * uv[:, 1]], 1)
    fy = np.stack([np.zeros(n), np.ones(n), c[1] + c[3] * uv[:, 0]
                   + 2 * c[4] * uv[:, 1]], 1)
    nrm = np.cross(fx, fy)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pos, nrm.astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("normalized", [True, False])
def test_single_cloud_build_on_the_kernels(cuda, normalized, masked):
    """``geometry.build_grad_div`` of one cloud on CUDA tensors launches
    ``gather_rows`` and ``wls`` once each and agrees with the torch math
    (``_tables_math``) on the card: the same indices and masks,
    coefficients within 1e-4 x max|coef|; with ``shape_regularizer`` it
    runs the torch math and launches no kernel, and its operators apply
    on the card."""
    from deltaconv_tpu_torch.geometry import build_grad_div
    from deltaconv_tpu_torch.geometry import grad_div as gdm

    rng = np.random.default_rng(30)
    pos, nrm = (torch.from_numpy(a).to(cuda) for a in _surface_cloud(
        rng, 1000))
    xb, yb = build_tangent_basis(nrm)
    idx, mask = knn(pos, 20)
    pm = None
    if masked:
        pm = torch.from_numpy(rng.random(1000) > 0.2).to(cuda)
    reset_launch_counts()
    got = build_grad_div(pos, nrm, xb, yb, idx, mask, pm,
                         normalized=normalized)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["gather_rows"] == 1 and counts["wls"] == 1
    want = gdm._tables_math(pos, xb, yb, pos, nrm, xb, yb, idx, mask, pm,
                            normalized=normalized)
    assert got.single and torch.equal(got.nbr_idx, want.nbr_idx)
    assert torch.equal(got.nbr_mask, want.nbr_mask)
    for a, b in ((got.grad_coef, want.grad_coef),
                 (got.div_coef, want.div_coef)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    view = pos[:, :1]  # a strided view: the applies copy it first
    for apply, arg in ((got.grad, view), (got.div, got.grad(view))):
        assert torch.equal(apply(arg), apply(arg.contiguous()))
    reset_launch_counts()
    shaped = build_grad_div(pos, nrm, xb, yb, idx, mask, pm,
                            shape_regularizer=1e-2)
    assert sum(launch_counts().values()) == 0
    lap = shaped.div(shaped.grad(pos))  # the applies' kernels take them
    assert lap.shape == (1000, 3) and bool(lap.isfinite().all())


def test_knn_tiled_on_the_card(cuda):
    """``geometry.knn_tiled`` of one cloud (N=5000, tiles of 1024, the last
    partial): self in slot 0, every slot valid, and each row's distances
    those of the exact kNN's selection (``knn`` on ``[N, 3]``) within
    1e-6 (the two score forms may order a near-tie otherwise)."""
    from deltaconv_tpu_torch.geometry import knn_tiled

    rng = np.random.default_rng(31)
    pos = torch.from_numpy(rng.random((5000, 3)).astype(np.float32)).to(cuda)
    idx, mask = knn_tiled(pos, 16, tile=1024)
    want, _ = knn(pos, 16)
    assert idx.dtype == torch.int32 and bool(mask.all())
    assert torch.equal(idx[:, 0], torch.arange(5000, device=cuda,
                                               dtype=torch.int32))
    p = pos.double()
    d = [torch.sort((p[i.long()] - p[:, None]).norm(dim=-1), dim=1).values
         for i in (idx, want)]
    torch.testing.assert_close(d[0], d[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("m", [40, 3000, 65536])
def test_top_k_select_on_the_card(cuda, m):
    """``top_k(..., select=True)`` (``knn_tiled``'s selection, ``torch.topk``
    of unique int64 keys) on the card: on rows of exact ties, signed zeros
    and infinities the ids equal the stable-sort rule on the host and
    ``top_k``'s sort on the card, and the values their bits."""
    from deltaconv_tpu_torch.geometry.knn import top_k

    rng = np.random.default_rng(32)
    s = rng.integers(-3, 4, (16, m)).astype(np.float32)
    s[:, ::7] = -0.0
    s[:, 3] = np.inf
    s[1::2, 5] = -np.inf
    st = torch.from_numpy(s).to(cuda)
    for k in (1, 20, 40):
        values, idx = top_k(st, k, select=True)
        want = _stable_top_k(s, k)
        np.testing.assert_array_equal(idx.cpu().numpy(), want)
        assert torch.equal(idx, top_k(st, k)[1])
        np.testing.assert_array_equal(
            values.cpu().numpy().view(np.int32),
            np.take_along_axis(s, want, -1).view(np.int32))


def test_adam_checkpoint_restores_the_live_placement(cuda, tmp_path):
    """An Adam state restored on the card holds every optimizer tensor on
    the device a live state holds it (the step counts on the host, the
    moments on the card) and the same bits, so a resumed step runs as an
    uninterrupted one."""
    from deltaconv_tpu_torch.training import (adam_steplr,
                                              restore_checkpoint,
                                              save_checkpoint)

    torch.manual_seed(0)
    model = torch.nn.Linear(8, 4)
    state = create_train_state(model, adam_steplr(0.01, 30, 0.1, 4),
                               device=cuda)
    for _ in range(2):
        state.optimizer.zero_grad()
        model(torch.randn(5, 8, device=cuda)).square().sum().backward()
        state.optimizer.step()
    save_checkpoint(str(tmp_path), state, step=1)
    target = create_train_state(torch.nn.Linear(8, 4),
                                adam_steplr(0.01, 30, 0.1, 4), device=cuda)
    restore_checkpoint(str(tmp_path), target)
    live = state.optimizer.state_dict()["state"]
    got = target.optimizer.state_dict()["state"]
    for i, entry in live.items():
        for name, value in entry.items():
            assert got[i][name].device == value.device, name
            assert torch.equal(got[i][name], value), name
