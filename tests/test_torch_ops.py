"""deltaconv_tpu_torch kernel modules against the JAX package on the CPU.

Each plain PyTorch version (what a kernel wrapper runs on a CPU tensor)
is held against the JAX function it ports, with the Pallas kernel run in
interpret mode as tests/ops/test_kernels.py runs it. Inputs are made
with numpy from a seed and handed to both.

The TPU's gather kernels (gather_rows, gather_max) reconstruct f32 rows
from a hi/lo bf16 pair, i.e. to 16 significant bits. Their inputs here
are drawn with at most 16 significant bits, which the pair holds
exactly, so these comparisons test indexing and masking exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu.geometry.frames import build_tangent_basis as jax_basis
from deltaconv_tpu.geometry.grad_div import build_grad_div
from deltaconv_tpu.geometry.knn import knn as jax_knn
from deltaconv_tpu.ops.densify_op import densify_coefs as jax_densify
from deltaconv_tpu.ops.gather_max import _pallas_fwd
from deltaconv_tpu.ops.gather_max import gather_max as jax_gather_max
from deltaconv_tpu.ops.gather_max import masked_nbr_max as jax_masked_max
from deltaconv_tpu.ops.gather_rows import gather_rows as jax_gather_rows
from deltaconv_tpu.ops.gather_sum import _adjacency_matrix
from deltaconv_tpu.ops.wls_fused import build_grad_div_fused as jax_fused
from deltaconv_tpu_torch import geometry as G
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.ops.gather_max import NEG

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair_exact(rng, shape):
    """f32 values with at most 16 significant bits."""
    return (rng.integers(-2**15, 2**15, shape) / 2.0**12).astype(np.float32)


def test_gather_rows_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    b, n, k, c = 2, 192, 9, 9
    table = _pair_exact(rng, (b, n, c))
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                      128, True))
    got = ops.gather_rows(_t(table), _t(idx))
    assert got.shape == (b, c, k, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.transpose(table[np.arange(b)[:, None, None], idx],
                                  (0, 3, 2, 1)))


def _wls_inputs(rng, masked, b=2, n=128, k=10):
    pos = rng.random((b, n, 3)).astype(np.float32)
    nrm = rng.random((b, n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pm = None
    if masked:
        pm = np.ones((b, n), bool)
        pm[0, 90:] = False
        pm[1, 50:] = False
    nbr, mask = jax.vmap(lambda p, m: jax_knn(p, k, m),
                         in_axes=(0, None if pm is None else 0))(
        jnp.asarray(pos), None if pm is None else jnp.asarray(pm))
    mask = np.asarray(mask)
    if pm is not None:
        mask = mask & pm[:, :, None]
    xb, yb = jax.vmap(jax_basis)(jnp.asarray(nrm))
    return pos, nrm, np.asarray(xb), np.asarray(yb), np.asarray(nbr), mask, pm


@pytest.mark.parametrize("masked", [False, True])
def test_build_grad_div_fused_matches_jax(masked):
    """Plain edge planes + WLS == the Pallas fused build (interpret) and
    the XLA build_grad_div, atol 2e-5 as tests/ops/test_kernels.py."""
    rng = np.random.default_rng(1)
    pos, nrm, xb, yb, nbr, mask, pm = _wls_inputs(rng, masked)
    args = [pos, nrm, xb, yb, nbr, mask]
    fused = jax_fused(*map(jnp.asarray, args), tile=64, interpret=True)
    xla = jax.vmap(lambda p, n_, x, y, i, m, q: build_grad_div(
        p, n_, x, y, i, m, q), in_axes=(0,) * 6 + (
        None if pm is None else 0,))(*map(jnp.asarray, args),
                                     None if pm is None else jnp.asarray(pm))
    got = ops.build_grad_div_fused(*map(_t, args))
    for ref in (fused, xla):
        np.testing.assert_allclose(got.grad_coef.numpy(),
                                   np.asarray(ref.grad_coef), atol=2e-5)
        np.testing.assert_allclose(got.div_coef.numpy(),
                                   np.asarray(ref.div_coef), atol=2e-5)
    # Masked edges carry zero coefficients.
    assert not got.grad_coef[~_t(mask)].any()
    assert not got.div_coef[~_t(mask)].any()


# -- the WLS kernels' launch geometry (csrc/wls.cu's split route) -------------


def test_wls_split_routes():
    """``wls_split``, the Python mirror of the WLS kernels' launch: every
    K from 1 to 80 gets a route. Up to WLS_MAX_SLICES x the most slots a
    warp holds, the split route: S the fewest warps whose slots hold K
    edges, E the fewest slots for that S (no warp without an edge), the
    block's sums within the shared memory it gets without opting in;
    above, the direct route. The model shapes take the split route: 4
    warps of 5 slots at K=20, 6 of 5 at K=30."""
    wf = importlib.import_module("deltaconv_tpu_torch.ops.wls_fused")
    most = wf.WLS_EDGES
    split = 0
    for k in range(1, 81):
        s, e = wf.wls_split(k)
        if k > wf.WLS_MAX_SLICES * most:
            assert (s, e) == (0, 0), k
            continue
        split += 1
        assert 1 <= s <= wf.WLS_MAX_SLICES and 1 <= e <= most, (k, s, e)
        assert s * e >= k > s * (e - 1) and (s - 1) * most < k, (k, s, e)
        assert s <= k  # warp s - 1 holds edge s - 1
        assert wf.wls_smem(s) <= wf.WLS_SMEM_MAX
    assert split == wf.WLS_MAX_SLICES * most
    assert wf.wls_split(20) == (4, 5)
    assert wf.wls_split(30) == (6, 5)
    assert wf.wls_split(0) == (1, 1)  # nothing to launch: any route


def test_wls_split_constants_match_cuda():
    """The mirror's constants are the split route's (``csrc/wls_split.cuh``,
    shared by ``wls.cu`` and ``fused_build.cu``): the points of a block,
    the most warps, the most slots a warp holds, and the block's shared
    memory (``split_smem``: 21 sums of 4 bytes a point and warp); the fused
    build's block (``fused_smem``: those sums and its [4][32][K] output
    tile) within the default 48 KB at every K the split route takes."""
    import re
    from pathlib import Path

    wf = importlib.import_module("deltaconv_tpu_torch.ops.wls_fused")
    csrc = Path(wf.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "wls_split.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kPoints") == wf.WLS_POINTS
    assert const("kMaxSlices") == wf.WLS_MAX_SLICES
    assert const("kMaxEdges") == wf.WLS_EDGES
    body = re.search(r"inline size_t split_smem\(int S\) \{\s*return "
                     r"([^;]+);", src).group(1)
    expr = (body.replace("(size_t)", "").replace("wls::NA", "21")
            .replace("sizeof(float)", "4"))
    for s in range(1, wf.WLS_MAX_SLICES + 1):
        assert eval(expr, {"S": s, "kPoints": wf.WLS_POINTS}) == wf.wls_smem(s)
    fused = re.search(r"inline size_t fused_smem\(int S, int K\) \{\s*"
                      r"return split_smem\(S\) \+ ([^;]+);",
                      (csrc / "fused_build.cu").read_text()).group(1)
    tile = (fused.replace("(size_t)", "").replace("sizeof(float)", "4"))
    for k in range(1, wf.WLS_MAX_SLICES * wf.WLS_EDGES + 1):
        s = wf.wls_split(k)[0]
        assert s and wf.wls_smem(s) + eval(
            tile, {"K": k, "kPoints": wf.WLS_POINTS}) <= wf.WLS_SMEM_MAX


@pytest.mark.parametrize("bwd", [False, True], ids=["wls", "wls_bwd"])
@pytest.mark.parametrize("k,slices,launched", [
    (20, None, ""),          # the classification shapes: split, by shape
    (30, None, ""),          # segmentation
    (7, None, ""),
    (41, None, "_direct"),   # above the split route's edges
    (80, None, "_direct"),
    (20, 0, "_direct"),      # forced direct route
    (20, 7, ""),             # a given number of warps
])
def test_wls_wrapper_launches_the_route(monkeypatch, bwd, k, slices,
                                        launched):
    """The WLS wrappers' one launch on CUDA tensors (recorded in place of
    the launch; meta tensors, no card): the split kernel with
    ``wls_split``'s warps before the two floats, or the direct kernel
    without them."""
    wf = importlib.import_module("deltaconv_tpu_torch.ops.wls_fused")
    calls = []
    monkeypatch.setattr(wf._lib, "launch", lambda kernel, device, *args:
                        calls.append((kernel, args)))
    monkeypatch.setattr(wf._lib, "check_inputs",
                        lambda name, specs: torch.device("cuda", 0))
    b, n = 2, 70
    edges = torch.empty((b, 12, k, n), device="meta")
    ct = torch.empty((b, 2, k, n), device="meta")
    if bwd:
        out = wf._wls_bwd(edges, ct, ct, 1.0, 1e-3, slices)
        assert out.shape == edges.shape
        name, ptrs = "wls_bwd", 4
    else:
        g, d = wf._wls_kernel(edges, 1.0, 1e-3, slices)
        assert g.shape == d.shape == (b, 2, k, n)
        name, ptrs = "wls", 3
    want = slices if slices is not None else wf.wls_split(k)[0]
    assert [(kernel, args[ptrs:]) for kernel, args in calls] == [
        (name + launched, (b, k, n) + ((want,) if want else ())
         + (1.0, 1e-3))]


@pytest.mark.parametrize("masked", [False, True])
def test_densify_plain_matches_pallas_interpret(masked):
    """Duplicate columns sum. Masked: the last slots are clamped to self
    with zero coefficients while slot 0 holds the real self
    coefficient, which a storing kernel would overwrite."""
    rng = np.random.default_rng(2)
    b, n, k = 2, 96, 8
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[:, :, 0] = np.arange(n)
    gc = rng.standard_normal((b, n, k, 2)).astype(np.float32)
    dc = rng.standard_normal((b, n, k, 2)).astype(np.float32)
    if masked:
        idx[:, :, -3:] = np.arange(n)[None, :, None]
        gc[:, :, -3:] = 0.0
        dc[:, :, -3:] = 0.0
    wg_j, wd_j = jax_densify(jnp.asarray(idx), jnp.asarray(gc),
                             jnp.asarray(dc), "float32", 128, True)
    wg, wd = ops.densify_coefs(_t(idx), _t(gc), _t(dc))
    np.testing.assert_allclose(wg.numpy(), np.asarray(wg_j), atol=1e-6)
    np.testing.assert_allclose(wd.numpy(), np.asarray(wd_j), atol=1e-6)
    if masked:  # the self coefficient survives the clamped slots
        diag = wg.numpy()[:, 0, np.arange(n), np.arange(n)]
        dup = (idx[:, :, 1:k - 3] == np.arange(n)[None, :, None])
        want = gc[:, :, 0, 0] + (gc[:, :, 1:k - 3, 0] * dup).sum(-1)
        np.testing.assert_allclose(diag, want, atol=1e-6)


@pytest.mark.parametrize("c", [8, 64])
def test_gather_max_plain_matches_pallas_interpret(c):
    rng = np.random.default_rng(3)
    b, n, k = 2, 256, 10
    h = _pair_exact(rng, (b, n, c))
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    mask = rng.random((b, n, k)) > 0.3
    mask[0, 5] = False  # a row with no valid neighbour
    want, _ = _pallas_fwd(jnp.asarray(h), jnp.asarray(idx),
                          jnp.asarray(mask), tile=128, interpret=True,
                          winners=False)
    got = ops.gather_max(_t(h), _t(idx), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got[0, 5].eq(NEG).all()

    # masked_nbr_max: all-masked rows give 0.
    want0 = jax_masked_max(jnp.asarray(h), jnp.asarray(idx),
                           jnp.asarray(mask))
    got0 = ops.masked_nbr_max(_t(h), _t(idx), _t(mask))
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), atol=1e-6)
    assert not got0[0, 5].any()


@pytest.mark.parametrize("masked", [False, True])
def test_knn_matches_jax(masked):
    """Same neighbour sets, self in slot 0, same edge mask; padded slots
    clamped to self."""
    rng = np.random.default_rng(4)
    b, n, k = 2, 128, 10
    pos = rng.standard_normal((b, n, 3)).astype(np.float32)
    pm = None
    if masked:
        pm = np.ones((b, n), bool)
        pm[0, 100:] = False
        pm[1, 6:] = False  # fewer valid points than k
    idx_j, mask_j = jax.vmap(lambda p, m: jax_knn(p, k, m),
                             in_axes=(0, None if pm is None else 0))(
        jnp.asarray(pos), None if pm is None else jnp.asarray(pm))
    idx_j, mask_j = np.asarray(idx_j), np.asarray(mask_j)
    idx, mask = G.knn(_t(pos), k, None if pm is None else _t(pm))
    assert idx.dtype == torch.int32 and mask.dtype == torch.bool
    idx, mask = idx.numpy(), mask.numpy()
    np.testing.assert_array_equal(idx[:, :, 0],
                                  np.broadcast_to(np.arange(n), (b, n)))
    np.testing.assert_array_equal(mask, mask_j)
    self_idx = np.arange(n)[None, :, None]
    assert np.all(np.where(mask, True, idx == self_idx))
    for bi in range(b):
        for i in range(n):
            assert (set(idx[bi, i][mask[bi, i]])
                    == set(idx_j[bi, i][mask_j[bi, i]]))


def test_tangent_basis_matches_jax():
    rng = np.random.default_rng(5)
    nrm = rng.standard_normal((2, 64, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[0, 0] = [1.0, 0.0, 0.0]  # the alternate test vector
    xb_j, yb_j = jax_basis(jnp.asarray(nrm))
    xb, yb = G.build_tangent_basis(_t(nrm))
    np.testing.assert_allclose(xb.numpy(), np.asarray(xb_j), atol=1e-6)
    np.testing.assert_allclose(yb.numpy(), np.asarray(yb_j), atol=1e-6)


def test_vector_operators_match_jax():
    from deltaconv_tpu.geometry import operators as JO
    from deltaconv_tpu_torch.geometry import operators as PO

    rng = np.random.default_rng(6)
    v = rng.standard_normal((2, 16, 2, 5)).astype(np.float32)
    v[0, 0] = 0.0  # zero vectors: norm exactly 0
    for name in ("norm", "J", "I_J"):
        np.testing.assert_allclose(getattr(PO, name)(_t(v)).numpy(),
                                   np.asarray(getattr(JO, name)(v)),
                                   atol=1e-6)


def _graph_with_ties(rng, b, n, k):
    """Random neighbour lists with masked slots; indices repeat inside a
    row (exact ties in the max), and one row has no valid neighbour."""
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    mask = rng.random((b, n, k)) > 0.25
    mask[0, 5] = False
    return idx, mask


@pytest.mark.parametrize("c", [8, 64])
def test_gather_max_win_matches_pallas_interpret(c):
    """Out and winners equal: the winner is the FIRST slot holding the
    maximum, which repeated indices and 16-bit values put to the test."""
    rng = np.random.default_rng(7)
    b, n, k = 2, 256, 10
    h = _pair_exact(rng, (b, n, c))
    idx, mask = _graph_with_ties(rng, b, n, k)
    want, want_win = _pallas_fwd(jnp.asarray(h), jnp.asarray(idx),
                                 jnp.asarray(mask), tile=128, interpret=True,
                                 winners=True)
    got, win = ops.gather_max_win(_t(h), _t(idx), _t(mask))
    assert win.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(win.numpy(), np.asarray(want_win))
    vals = np.where(mask[..., None], h[np.arange(b)[:, None, None], idx],
                    -np.inf)
    ties = (vals == vals.max(axis=2, keepdims=True)).sum(axis=2) > 1
    assert ties.sum() > 20  # the first-winner rule decided these
    assert not win[0, 5].any()  # no valid neighbour: winner 0


@pytest.mark.parametrize("masked_max", [False, True])
def test_gather_max_vjp_matches_jax(masked_max):
    """The single-winner backward against jax.vjp of the JAX gather_max
    (its reference path on the CPU), atol 1e-5: every cotangent goes to
    the first winning neighbour, none is split over ties; through
    masked_nbr_max the row with no valid neighbour passes nothing
    back."""
    rng = np.random.default_rng(8)
    b, n, k, c = 2, 96, 8, 16
    h = _pair_exact(rng, (b, n, c))
    idx, mask = _graph_with_ties(rng, b, n, k)
    ct = rng.standard_normal((b, n, c)).astype(np.float32)
    jfn = jax_masked_max if masked_max else jax_gather_max
    want, vjp = jax.vjp(lambda a: jfn(a, jnp.asarray(idx),
                                      jnp.asarray(mask)), jnp.asarray(h))
    (want_dh,) = vjp(jnp.asarray(ct))
    for gmax in (ops.gather_max, ops.gather_max_plain):
        hg = _t(h).requires_grad_()
        out = (ops.masked_nbr_max(hg, _t(idx), _t(mask), gmax) if masked_max
               else gmax(hg, _t(idx), _t(mask)))
        out.backward(_t(ct))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
        np.testing.assert_allclose(hg.grad.numpy(), np.asarray(want_dh),
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("two_maps", [False, True])
def test_max_bwd_is_the_exact_sum_rounded_once(dtype, two_maps):
    """The winner-routed backward (one map, and ``gather_minmax``'s two)
    is each row's exact sum of cotangents rounded once to f32, as the
    kernels compute it in f64: equal bit for bit to a float64 numpy sum,
    and to the same backward with the points in another order (the
    kernels' atomics land in any order). The cotangents span 16 binary
    orders and collide on 8 rows, so f32 sums in the two orders differ."""
    rng = np.random.default_rng(31)
    b, n, k, c, n_out = 2, 200, 6, 16, 8
    maps = 2 if two_maps else 1
    idx = rng.integers(0, n_out, (b, n, k)).astype(np.int32)
    win = [rng.integers(0, k, (b, n, c)).astype(np.int32)
           for _ in range(maps)]
    g = [_t(rng.choice([-1.0, 1.0], (b, n, c)) * (1 + rng.random((b, n, c)))
            * 2.0 ** rng.integers(-8, 8, (b, n, c))).float().to(
                getattr(torch, dtype)) for _ in range(maps)]

    def bwd(order):
        p = torch.as_tensor(order)
        args = [_t(idx)[:, p]]
        for w, gm in zip(win, g):
            args += [_t(w)[:, p], gm[:, p]]
        fn = ops.gather_minmax_bwd if two_maps else ops.gather_max_bwd
        return fn(*args, n_out)

    got = bwd(np.arange(n))
    want = np.zeros((b, n_out, c), np.float64)
    f32 = [torch.zeros((b, n_out, c)) for _ in range(2)]
    perm = rng.permutation(n)
    for w, gm in zip(win, g):
        src = np.take_along_axis(idx, w, axis=2)
        for bb, ch in np.ndindex(b, c):
            np.add.at(want[bb, :, ch], src[bb, :, ch],
                      gm[bb, :, ch].double().numpy())
        for acc, order in zip(f32, (np.arange(n), perm)):
            acc.scatter_add_(1, _t(src[:, order]).long(),
                             gm[:, torch.as_tensor(order)].float())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert torch.equal(bwd(perm), got)
    assert not torch.equal(f32[0], f32[1])  # the data tells orders apart


@pytest.mark.parametrize("name", ["gather_max_bwd", "gather_max_bwd_bf16",
                                  "gather_minmax_bwd",
                                  "gather_minmax_bwd_bf16"])
@pytest.mark.parametrize("n_out,route,launched", [
    (1024, None, ""),           # by shape: route S, bwd_slice's
    (65536, None, "_direct"),   # beyond route S's ranges: route D
    (1024, (0, 0), "_direct"),  # forced route D
    (1024, (16, 300), ""),      # a given slice and range
])
def test_bwd_wrapper_launches_the_route(monkeypatch, name, n_out, route,
                                        launched):
    """``_bwd_launch``, the last step of ``gather_max_bwd``'s and
    ``gather_minmax_bwd``'s wrappers, launches the route that
    ``bwd_slice`` names (its slice and rows the last arguments, no
    scratch) or route D's ``_direct`` kernel with its f64 scratch
    (recorded in place of the launch; meta tensors, no card)."""
    gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
    calls = []
    monkeypatch.setattr(gm._lib, "launch", lambda kernel, device, *args:
                        calls.append((kernel, args)))
    b, n, c, k = 32, 1024, 64, 20
    dh = torch.empty((b, n_out, c), device="meta")
    gm._bwd_launch(name, torch.device("cuda", 0), (11, 12, 13), dh, b, n, c,
                   k, n_out, route)
    if launched:
        assert calls == [(name + launched, (11, 12, 13, 0, 0, b, n, c, k,
                                            n_out))]
        return
    want = route or gm.bwd_slice(n_out, c)
    assert want[0] > 0
    assert calls == [(name, (11, 12, 13, 0, b, n, c, k, n_out, *want))]


def test_sum_bwd_is_the_exact_sum_rounded_once():
    """The neighbour sum's streaming backward (``gather_sum_bwd``) is each
    row's exact sum of the masked cotangents rounded once to f32, as the
    kernel computes it in f64: equal bit for bit to a float64 numpy sum,
    and to the same backward with the points in another order (the
    kernel's atomics land in any order). The cotangents span 16 binary
    orders and collide on 8 rows, so f32 sums in the two orders differ."""
    rng = np.random.default_rng(32)
    b, n, k, c = 2, 200, 6, 16
    idx = rng.integers(0, 8, (b, n, k)).astype(np.int32)
    mask = rng.random((b, n, k)) > 0.2
    g = (rng.choice([-1.0, 1.0], (b, n, c)) * (1 + rng.random((b, n, c)))
         * 2.0 ** rng.integers(-8, 8, (b, n, c))).astype(np.float32)

    def bwd(order):
        p = torch.as_tensor(order)
        return ops.gather_sum_bwd(_t(idx)[:, p], _t(mask)[:, p], _t(g)[:, p])

    got = bwd(np.arange(n))
    want = np.zeros((b, n, c), np.float64)
    for bb, kk in np.ndindex(b, k):
        rows = mask[bb, :, kk]
        np.add.at(want[bb], idx[bb, rows, kk], g[bb, rows].astype(np.float64))
    perm = rng.permutation(n)
    f32 = []
    for order in (np.arange(n), perm):
        src = torch.where(_t(mask)[:, order, :, None],
                          _t(g)[:, order, None, :], 0.0)
        index = _t(idx)[:, order].reshape(b, n * k, 1).long().expand(
            b, n * k, c)
        f32.append(torch.zeros((b, n, c)).scatter_add_(
            1, index, src.reshape(b, n * k, c)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert torch.equal(bwd(perm), got)
    assert not torch.equal(f32[0], f32[1])  # the data tells orders apart


def test_edge_mlp_dy_is_the_exact_sum_rounded_once():
    """The edge MLP backward's ``dy`` (``edge_mlp_bwd``: ``bf16(dy0)`` at
    each neighbour row, ``-dy0`` at the point's own) is each row's exact
    sum of its addends rounded once to f32, as the kernel computes it in
    f64: equal bit for bit to a float64 numpy sum, and to the same
    backward with the points in another order. ``dh = g1 @ w1^T`` is
    exact in f32 (small dyadic values), the terms span 32 binary orders
    and collide on 8 rows, so f32 sums in the two orders differ."""
    from deltaconv_tpu_torch.ops.edge_mlp import _rows

    rng = np.random.default_rng(33)
    b, n, k, c0, c1 = 2, 200, 6, 16, 16
    idx = rng.integers(0, 8, (b, n, k)).astype(np.int32)
    y = _t(rng.standard_normal((b, n, c0))).float().to(torch.bfloat16)
    a0 = _t(rng.choice([-1.0, 1.0], c0) * (1 + rng.random(c0))
            * 2.0 ** rng.integers(-8, 8, c0)).float()
    b0 = _t(0.3 * rng.standard_normal(c0)).float()
    w1 = _t(rng.integers(-16, 17, (c0, c1)) / 16.0).float()
    g = _t(rng.integers(-4, 5, (b, k, n, c1))
           * 2.0 ** rng.integers(-8, 8, (b, k, n, 1))).float().to(
               torch.bfloat16)

    def bwd(order):
        p = torch.as_tensor(order)
        inv = torch.empty_like(p)
        inv[p] = torch.arange(n)
        ids = inv[_t(idx)[:, p].long()].int()
        return ops.edge_mlp_bwd(y[:, p], a0, b0, w1, ids, g[:, :, p])[0]

    got = bwd(np.arange(n))
    y0 = y.float()[torch.arange(b)[:, None, None], _t(idx).long()] - (
        y.float()[:, :, None])
    pre = (y0 * a0 + b0)[:, :, 1:]
    dh = g[:, 1:].float().permute(0, 2, 1, 3) @ w1.to(
        torch.bfloat16).float().t()
    dy0f = dh * torch.where(pre >= 0, 1.0, 0.2) * a0
    edge = dy0f.to(torch.bfloat16).double().numpy()
    rows = _rows(_t(idx)[:, :, 1:], n).numpy()
    want = -dy0f.double().numpy().sum(axis=2)
    for bb in range(b):
        np.add.at(want[bb], rows[bb].reshape(-1),
                  edge[bb].reshape(-1, c0))
    perm = rng.permutation(n)
    f32 = []
    for order in (np.arange(n), perm):
        acc = torch.zeros((b, n, c0))
        src = torch.from_numpy(edge).float()[:, order]
        acc.scatter_add_(1, torch.from_numpy(rows[:, order]).reshape(
            b, -1, 1).expand(b, n * (k - 1), c0), src.reshape(b, -1, c0))
        f32.append(acc)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert torch.equal(bwd(perm), got[:, torch.as_tensor(perm)])
    assert not torch.equal(f32[0], f32[1])  # the data tells orders apart


def test_adjacency_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    b, n, k = 2, 192, 9
    idx, mask = _graph_with_ties(rng, b, n, k)
    want = _adjacency_matrix(jnp.asarray(idx), jnp.asarray(mask), 128, True)
    got = ops.adjacency(_t(idx), _t(mask))
    assert got.dtype == torch.float32 and got.shape == (b, n, n)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.float32))
    assert got.max() > 1  # repeated indices count twice


@pytest.mark.parametrize("streaming", [False, True])
def test_gather_sum_and_vjp_match_jax(streaming, monkeypatch):
    """Forward and VJP on the dense route (adjacency + products) and on
    the streaming one (both packages' byte budget patched to 0), masked
    slots included, atol 1e-5. The JAX side runs its Pallas kernels in
    interpret mode; they split f32 into a hi/lo bf16 pair, which holds
    the 16-bit inputs exactly."""
    import deltaconv_tpu.ops.gather_sum as jax_gs

    port_gs = importlib.import_module("deltaconv_tpu_torch.ops.gather_sum")
    if streaming:
        monkeypatch.setattr(jax_gs, "_DENSE_ADJ_MAX_BYTES", 0)
        monkeypatch.setattr(port_gs, "_DENSE_ADJ_MAX_BYTES", 0)
    rng = np.random.default_rng(10)
    b, n, k, c = 2, 128, 7, 12
    h = _pair_exact(rng, (b, n, c))
    idx, mask = _graph_with_ties(rng, b, n, k)
    ct = _pair_exact(rng, (b, n, c))
    want, vjp = jax.vjp(lambda a: jax_gs.gather_sum(
        a, jnp.asarray(idx), jnp.asarray(mask), 64, True), jnp.asarray(h))
    (want_dh,) = vjp(jnp.asarray(ct))

    for fn in (ops.gather_sum, ops.gather_sum_plain):
        hg = _t(h).requires_grad_()
        out = fn(hg, _t(idx), _t(mask))
        # What the backward keeps tells the route: A, or the graph.
        saved = out.grad_fn.saved_tensors
        assert [t.shape for t in saved] == (
            [(b, n, k), (b, n, k)] if streaming else [(b, n, n)])
        out.backward(_t(ct))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
        np.testing.assert_allclose(hg.grad.numpy(), np.asarray(want_dh),
                                   atol=1e-5)
    with torch.no_grad():  # no gradient traced: the streaming forward
        out = ops.gather_sum(_t(h).requires_grad_(), _t(idx), _t(mask))
    assert out.grad_fn is None
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


# -- the bf16 serving slice: knn_topk, densify bf16, the bf16 maxes --------


def _bf16(a):
    """numpy f32 -> (the same values rounded to bf16 as f32 numpy, jnp
    bf16, torch bf16)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    f = np.asarray(j, np.float32)
    return f, j, torch.from_numpy(f).to(torch.bfloat16)


def _bf16_ulps(a, b):
    """Per-element distance in bf16 ulps of two bf16-valued arrays."""
    def ordered(x):
        u = torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16).view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("quantized", [False, True])
def test_knn_topk_plain_matches_pallas_interpret(quantized):
    """Same indices in the same order as the Pallas kernel (interpret),
    self in slot 0; the scores are elementwise f32 in the kernel's order
    on both sides, so every row agrees."""
    from deltaconv_tpu.ops.knn_topk import knn_topk as jax_knn_topk

    rng = np.random.default_rng(11)
    b, n, k = 2, 256, 12
    pos = rng.standard_normal((b, n, 3)).astype(np.float32)
    pos[0, 7] = pos[0, 3]  # a duplicate point: an exact tie
    want = np.asarray(jax_knn_topk(jnp.asarray(pos), k, interpret=True,
                                   quantized=quantized))
    got = ops.knn_topk(_t(pos), k, quantized=quantized)
    assert got.dtype == torch.int32 and got.shape == (b, n, k)
    np.testing.assert_array_equal(got.numpy()[:, :, 0],
                                  np.broadcast_to(np.arange(n), (b, n)))
    np.testing.assert_array_equal(got.numpy(), want)
    # The same neighbour sets as the exact kNN (the packed keys reorder
    # only near-ties, and these clouds have none at 16 bits).
    idx_e, _ = G.knn(_t(pos), k)
    for bi in range(b):
        for i in range(n):
            assert set(got[bi, i].tolist()) == set(idx_e[bi, i].tolist())


@pytest.mark.parametrize("quantized", [False, True])
def test_knn_topk_long_rows_match_pallas_interpret(quantized):
    """Rows longer than 1024 points (B=1, N=1100, K=30), where the earlier
    CUDA kernel changed bodies: the same ids, in the same order, as the
    Pallas kernel in interpret mode."""
    from deltaconv_tpu.ops.knn_topk import knn_topk as jax_knn_topk

    rng = np.random.default_rng(12)
    pos = rng.standard_normal((1, 1100, 3)).astype(np.float32)
    want = np.asarray(jax_knn_topk(jnp.asarray(pos), 30, interpret=True,
                                   quantized=quantized))
    got = ops.knn_topk(_t(pos), 30, quantized=quantized)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quantized,tol", [(False, 1e-5), (True, 5e-4)],
                         ids=["exact", "quantized"])
def test_knn_topk_grid_ties_match_pallas_interpret(quantized, tol):
    """A coarse 9^3 grid of 300 points a cloud, with many duplicates: equal
    scores and equal quantized keys, broken to the lowest column as the
    Pallas kernel (interpret mode) breaks them; ids equal, order
    included, and the mean distances within the tolerances of
    ``test_knn_topk_mean_dist_matches_jax`` (XLA rounds the dequantized
    scores otherwise)."""
    from deltaconv_tpu.ops.knn_topk import knn_topk as jax_knn_topk

    rng = np.random.default_rng(13)
    pos = (rng.integers(-4, 5, (2, 300, 3)) * 0.25).astype(np.float32)
    want, want_md = jax_knn_topk(jnp.asarray(pos), 20, interpret=True,
                                 quantized=quantized, return_mean_dist=True)
    got, md = ops.knn_topk(_t(pos), 20, quantized, return_mean_dist=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(md.numpy(), np.asarray(want_md), rtol=0,
                               atol=tol)


def _distinct_graph(rng, b, n, k, clamped):
    """Neighbour lists as the kNN makes them: self in slot 0, distinct
    columns, and ``clamped`` trailing slots clamped to self with zero
    coefficients (a masked cloud)."""
    idx = np.stack([np.stack([np.concatenate(
        [[i], rng.permutation(np.delete(np.arange(n), i))[:k - 1]])
        for i in range(n)]) for _ in range(b)]).astype(np.int32)
    gc = rng.standard_normal((b, n, k, 2)).astype(np.float32)
    dc = rng.standard_normal((b, n, k, 2)).astype(np.float32)
    gc[0, 0, 1, 0] = -0.0  # a negative zero lands alone in its column
    if clamped:
        idx[:, :, -clamped:] = np.arange(n)[None, :, None]
        gc[:, :, -clamped:] = 0.0
        dc[:, :, -clamped:] = 0.0
    return idx, gc, dc


@pytest.mark.parametrize("masked", [False, True])
def test_densify_bf16_plain_matches_pallas_interpret(masked):
    """Bit-equal to the Pallas bf16 body (interpret), which rounds every
    coefficient and ORs it into place: the f32 sum rounded once is the
    same value when every real slot has its own column."""
    rng = np.random.default_rng(12)
    b, n, k = 2, 96, 8
    idx, gc, dc = _distinct_graph(rng, b, n, k, 3 if masked else 0)
    wg_j, wd_j = jax_densify(jnp.asarray(idx), jnp.asarray(gc),
                             jnp.asarray(dc), "bfloat16", 128, True)
    wg, wd = ops.densify_coefs(_t(idx), _t(gc), _t(dc), torch.bfloat16)
    assert wg.dtype == torch.bfloat16 and wg.shape == (b, 2, n, n)
    for got, want in ((wg, wg_j), (wd, wd_j)):
        got_bits = got.view(torch.int16).numpy()
        want_bits = np.asarray(want).view(np.int16)
        np.testing.assert_array_equal(got_bits, want_bits)
    assert not (wg.view(torch.int16) == -32768).any()  # no -0.0 stored


def _affine(rng, c):
    """A BatchNorm eval affine with slopes of both signs."""
    inv = rng.standard_normal(c).astype(np.float32)
    return [np.where(inv >= 0, 1.0, -1.0).astype(np.float32), inv,
            rng.standard_normal(c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32)]


def _self_first_graph(rng, b, n, k):
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[:, :, 0] = np.arange(n)
    mask = rng.random((b, n, k)) > 0.2
    mask[:, :, 0] = True
    mask[0, 3] = False  # a row with no valid neighbour
    return idx, mask


# XLA's CPU compiler contracts ``(h - mean) * inv + bias`` into one FMA
# (jit(a * b + c) on the CPU equals the fused result for every input we
# drew); the port rounds the product on its own, as its CUDA kernel does,
# so an f32 result that sits on a bf16 rounding boundary can land one
# bf16 ulp away. Measured: 0 of 4800 and 1 of 10240 elements.
_EPILOGUE_ULPS = 1
_EPILOGUE_SHARE = 1e-3


def _assert_epilogue_close(got, want):
    ulps = _bf16_ulps(got.float().numpy(), want)
    assert int(ulps.max()) <= _EPILOGUE_ULPS
    assert float((ulps > 0).float().mean()) <= _EPILOGUE_SHARE


@pytest.mark.parametrize("sub_self", [False, True])
def test_gather_max_affine_plain_matches_pallas_interpret(sub_self):
    """Both replay the epilogue op for op in f32 on the bf16-rounded max;
    within one bf16 ulp (FMA contraction on the JAX side, above). N=100
    is not a multiple of the Pallas tile, so its self row comes through
    the slot-0 gather, as the port's."""
    from deltaconv_tpu.ops.gather_max import gather_max_affine as jax_fn

    rng = np.random.default_rng(13)
    b, n, k, c = 2, 100, 7, 24
    _, h_j, h = _bf16(rng.standard_normal((b, n, c)).astype(np.float32))
    idx, mask = _self_first_graph(rng, b, n, k)
    aff = _affine(rng, c)
    want = jax_fn(h_j, jnp.asarray(idx), jnp.asarray(mask),
                  tuple(map(jnp.asarray, aff)), sub_self=sub_self,
                  interpret=True)
    got = ops.gather_max_affine(h, _t(idx), _t(mask),
                                tuple(map(_t, aff)), sub_self)
    assert got.dtype == torch.bfloat16
    _assert_epilogue_close(got, np.asarray(want, np.float32))
    assert not got[0, 3].float().any()
    assert (np.asarray(aff[0]) < 0).any()  # negative slopes were folded


def _zero_row_graph(h, idx, mask):
    """``h`` with a zero row appended and the ids outside [0, N) pointed
    at it: the port's plain versions gather in range only."""
    b, n, c = h.shape
    hp = torch.cat([h, torch.zeros((b, 1, c), dtype=h.dtype)], dim=1)
    ids = torch.where((idx < 0) | (idx >= n), n, idx)
    ids = torch.cat([ids, torch.zeros_like(ids[:, :1])], dim=1)
    return hp, ids, torch.cat([mask, torch.zeros_like(mask[:, :1])], dim=1)


@pytest.mark.parametrize("sub_self", [False, True])
def test_gather_max_affine_plain_hard_cases_match_pallas_interpret(sub_self):
    """The rows the card's two routes must agree on, against the JAX
    kernel in interpret mode (its slot-0 self row through the one-hot
    gather: N=100 is not a multiple of its tile): a row with no valid
    slot (0), a masked slot 0 (its row is still the self row), ids
    outside the cloud in slot 0 (masked and valid: a self row of 0) and
    in a later slot (it gathers 0). The plain version runs on the graph
    with a zero row appended for those ids; within one bf16 ulp on 1e-3
    of the elements (FMA contraction on the JAX side, above)."""
    from deltaconv_tpu.ops.gather_max import gather_max_affine as jax_fn

    rng = np.random.default_rng(15)
    b, n, k, c = 2, 100, 7, 24
    _, h_j, h = _bf16(rng.standard_normal((b, n, c)).astype(np.float32))
    idx, mask = _self_first_graph(rng, b, n, k)
    mask[1, 5, 0] = False  # masked slot 0
    idx[0, 7, 0] = n + 4  # slot 0 outside the cloud, valid
    idx[0, 9, 0], mask[0, 9, 0] = -3, False  # and masked
    idx[1, 8, 2], mask[1, 8, 2] = -1, True  # a later slot outside
    aff = _affine(rng, c)
    want = np.asarray(jax_fn(h_j, jnp.asarray(idx), jnp.asarray(mask),
                             tuple(map(jnp.asarray, aff)), sub_self=sub_self,
                             interpret=True), np.float32)
    hp, ids, valid = _zero_row_graph(h, _t(idx), _t(mask))
    got = ops.gather_max_affine_plain(hp, ids, valid, tuple(map(_t, aff)),
                                      sub_self)[:, :n]
    assert got.dtype == torch.bfloat16
    _assert_epilogue_close(got, want)
    assert not got[0, 3].float().any()
    if sub_self:  # the slot-0 rows outside the cloud subtract nothing
        raw = ops.gather_max_affine_plain(hp, ids, valid, tuple(map(
            _t, aff)), False)[:, :n]
        assert torch.equal(got[0, 7], raw[0, 7])
        assert torch.equal(got[0, 9], raw[0, 9])


@pytest.mark.parametrize("affine", [False, True])
def test_gather_matmul_max_plain_matches_pallas_interpret(affine):
    """Random bf16 inputs: within one bf16 ulp (the f32 sums run in
    another order). Inputs with few significant bits, whose products and
    sums are exact in f32 in any order: bit-equal without the epilogue,
    within one bf16 ulp with it (FMA contraction on the JAX side)."""
    from deltaconv_tpu.ops.gather_max import gather_matmul_max as jax_fn

    rng = np.random.default_rng(14)
    b, n, k, ci, co = 2, 128, 7, 32, 40
    idx, mask = _self_first_graph(rng, b, n, k)
    aff = _affine(rng, co)
    draws = {
        "random": (rng.standard_normal((b, n, ci)),
                   rng.standard_normal((ci, co)) / 4),
        "exact": (rng.integers(-32, 33, (b, n, ci)) / 8.0,
                  rng.integers(-16, 17, (ci, co)) / 16.0),
    }
    for label, (x, w) in draws.items():
        _, x_j, x_t = _bf16(x.astype(np.float32))
        _, w_j, w_t = _bf16(w.astype(np.float32))
        want = np.asarray(jax_fn(
            x_j, w_j, jnp.asarray(idx), jnp.asarray(mask), interpret=True,
            self_slot0=True,
            affine=tuple(map(jnp.asarray, aff)) if affine else None),
            np.float32)
        got = ops.gather_matmul_max(x_t, w_t, _t(idx), _t(mask),
                                    tuple(map(_t, aff)) if affine else None)
        assert got.dtype == torch.bfloat16 and got.shape == (b, n, co)
        if label == "exact" and affine:
            _assert_epilogue_close(got, want)
        elif label == "exact":
            np.testing.assert_array_equal(got.float().numpy(), want)
        elif not affine:
            assert int(_bf16_ulps(got.float().numpy(), want).max()) <= 1
        else:  # one ulp of the max, through the affine
            slope = np.abs(aff[1]).max()
            tol = 2.0 ** -7 * slope * np.abs(want).max() + 2.0 ** -7
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                       atol=tol)
    if not affine:  # rows with no valid neighbour: -3e38 rounded to bf16
        assert bool((got[0, 3].float() == torch.tensor(NEG).to(
            torch.bfloat16).float()).all())
