"""The fused centralized edge MLP (``ops.edge_delta_mlp``) and the masked
maxes with first-winner gradients of deltaconv_tpu_torch against the JAX
package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs its Pallas kernels in interpret mode (``_pallas_fwd``,
``_pallas_bwd``) and its CPU references (``_reference``,
``_reference_bwd``).

Tolerances, and why:

- Forward: within one bf16 ulp elementwise. The port rounds ``y0 * a0``
  and ``+ b0`` separately, as its CUDA kernel does; XLA's CPU compiler
  contracts them into one FMA, which moves ``h`` by one bf16 ulp on a
  few edges and ``y1`` with it.
- Backward (f32, before any cast): ``dy``, ``dw1``, ``da0`` and ``db0``
  within 1e-4 x each tensor's max (f32 sums in another order, and the
  FMA above); ``dz0``, a sum of the same bf16 values, within 1e-5 x max.
  ``dy`` adds the edge terms ``bf16(dy0)``, and a ``dy0`` whose f32 sum
  ran in another order can round to the neighbouring bf16 value: so
  ``dy`` is allowed one bf16 ulp of the largest ``|dy0|`` more (measured:
  one element of 12,288 at 1.4e-4 x max, 64 -> 64 uniform).
- The autograd Function against ``jax.vjp`` of the JAX ``custom_vjp``:
  the same, with ``dy`` rounded to bf16 on both sides, so one bf16 ulp of
  an element more.
- The masked maxes: bit-equal values and gradients (selections).
- The backward's two phases (edge tensor and self rows, then the
  destination-major sum): composed, bit-equal to the one-piece plain
  backward (both add the same addends exactly in f64 and round once);
  against numpy on exact-sum inputs, bit-equal; against JAX as above.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.nn.deltaconv as jax_dc
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.nn.deltaconv import _MaskedMax

em = importlib.import_module("deltaconv_tpu.ops.edge_mlp")

torch.set_num_threads(1)

B, N, K = 2, 96, 8
TILE = 32  # the interpret kernels' point tile
BWD_REL = 1e-4  # x max: dy, dw1, da0, db0 (f32 sums in another order)
DZ0_REL = 1e-5  # x max: dz0
ULP = 2.0 ** -8  # one bf16 ulp, relative


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_ulps(a, b):
    """Per-element distance in bf16 ulps of two f32 arrays of bf16
    values."""
    def ordered(x):
        u = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(
            np.int64)
        return np.where(u >= 0x8000, -(u & 0x7FFF), u)

    return np.abs(ordered(a) - ordered(b))


def _graph(rng, masked):
    """``idx [B, N, K]`` with the self loop in slot 0; masked: the kNN's
    padding (slots of padded points and a random 30% clamped to self)."""
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    self_idx = np.broadcast_to(np.arange(N, dtype=np.int32)[None, :, None],
                               idx.shape)
    idx[:, :, 0] = np.arange(N)
    if masked:
        drop = rng.random((B, N, K)) < 0.3
        drop[1, 60:] = True
        drop[:, :, 0] = False
        idx = np.where(drop, self_idx, idx)
    return idx


def _data(rng, c0, c1, masked):
    """bf16 ``y`` (as f32 values), f32 ``a0, b0, w1``, ``z0`` as the
    layer makes it, and the graph."""
    y = np.asarray(jnp.asarray(rng.standard_normal((B, N, c0)).astype(
        np.float32)).astype(jnp.bfloat16), np.float32)
    a0 = rng.uniform(-1.5, 1.5, c0).astype(np.float32)
    b0 = rng.normal(0.0, 0.3, c0).astype(np.float32)
    w1 = (rng.standard_normal((c0, c1)) / np.sqrt(c0)).astype(np.float32)
    lb = np.where(b0 >= 0, b0, np.float32(0.2) * b0)
    z0 = np.asarray(jnp.dot(jnp.asarray(lb).astype(jnp.bfloat16)[None],
                            jnp.asarray(w1).astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)[0])
    return y, a0, b0, w1, z0, _graph(rng, masked)


def _jargs(y, a0, b0, w1, z0):
    return (jnp.asarray(y).astype(jnp.bfloat16), jnp.asarray(a0),
            jnp.asarray(b0), jnp.asarray(w1), jnp.asarray(z0))


def _targs(y, a0, b0, w1, z0):
    return (_t(y).to(torch.bfloat16), _t(a0), _t(b0), _t(w1), _t(z0))


def _within(got, want, rel, what, extra=0.0):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * float(np.abs(want).max()) + extra,
                               err_msg=what)


def _dy0_ulp(y, a0, b0, w1, idx, g):
    """One bf16 ulp of the largest edge term ``|dy0|`` of ``dy``
    (numpy, f32)."""
    y0 = y[np.arange(B)[:, None, None], idx[:, :, 1:]] - y[:, :, None, :]
    pre = y0 * a0 + b0
    w1b = np.asarray(jnp.asarray(w1).astype(jnp.bfloat16), np.float32)
    dh = np.moveaxis(g[:, 1:], 1, 2) @ w1b.T
    return ULP * float(np.abs(dh * np.where(pre >= 0, 1.0, 0.2) * a0).max())


WIDTHS = [(12, 12), (64, 64)]
GRAPHS = [False, True]


@pytest.mark.parametrize("masked", GRAPHS, ids=["uniform", "masked"])
@pytest.mark.parametrize("c0,c1", WIDTHS, ids=["12-12", "64-64"])
def test_edge_mlp_forward_matches_jax(c0, c1, masked):
    """The plain forward against the JAX interpret kernel and its XLA
    reference: K-major ``[B, K, N, C1]`` bf16, every element within one
    bf16 ulp, slot 0 equal to ``bf16(z0)``."""
    rng = np.random.default_rng(40 + c0)
    y, a0, b0, w1, z0, idx = _data(rng, c0, c1, masked)
    args = _jargs(y, a0, b0, w1, z0)
    jidx = jnp.asarray(idx)
    kernel, y0 = jax.jit(lambda *a: em._pallas_fwd(*a, jidx, TILE, True))(
        *args)
    reference = jax.jit(lambda *a: em._reference(*a, jidx))(*args)
    got = ops.edge_mlp_fwd(*_targs(y, a0, b0, w1, z0), _t(idx))
    assert got.dtype == torch.bfloat16 and got.shape == (B, K, N, c1)
    got = got.float().numpy()
    for tag, want in (("interpret kernel", kernel), ("reference", reference)):
        ulps = _bf16_ulps(got, np.asarray(want, np.float32))
        print(f"{tag}: {float((ulps > 0).mean()):.4%} differ, at most "
              f"{int(ulps.max())} ulp")
        assert int(ulps.max()) <= 1, tag
    np.testing.assert_array_equal(
        got[:, 0], np.broadcast_to(np.asarray(jnp.asarray(z0).astype(
            jnp.bfloat16), np.float32), (B, N, c1)))
    # The TPU's f32 stash is the edge values the port's backward
    # recomputes: y[idx_k] - y[n] in f32.
    np.testing.assert_array_equal(
        np.moveaxis(np.asarray(y0)[:, :, :N], 1, 2),
        y[np.arange(B)[:, None, None], idx[:, :, 1:]] - y[:, :, None, :])


@pytest.mark.parametrize("masked", GRAPHS, ids=["uniform", "masked"])
@pytest.mark.parametrize("c0,c1", WIDTHS, ids=["12-12", "64-64"])
def test_edge_mlp_backward_matches_jax(c0, c1, masked):
    """The plain backward (f32 ``dy``, ``dw1``, ``(da0, db0)``) against
    ``_reference_bwd`` and the interpret ``_pallas_bwd`` on the same bf16
    cotangent."""
    rng = np.random.default_rng(50 + c0)
    y, a0, b0, w1, z0, idx = _data(rng, c0, c1, masked)
    g = np.asarray(jnp.asarray(rng.standard_normal((B, K, N, c1)).astype(
        np.float32)).astype(jnp.bfloat16), np.float32)
    jy, ja0, jb0, jw1, jz0 = _jargs(y, a0, b0, w1, z0)
    jidx, jg = jnp.asarray(idx), jnp.asarray(g).astype(jnp.bfloat16)
    ref = jax.jit(em._reference_bwd)(jy, ja0, jb0, jw1, jidx, jg)
    _, y0 = jax.jit(lambda *a: em._pallas_fwd(*a, jidx, TILE, True))(
        jy, ja0, jb0, jw1, jz0)
    kdy, kdw1, kdab = jax.jit(
        lambda s: em._pallas_bwd(s, ja0, jb0, jw1, jidx, jg, N, TILE, True))(
        y0)
    interp = (kdy, kdab[0], kdab[1], kdw1)

    dy, dw1, dab = ops.edge_mlp_bwd(_t(y).to(torch.bfloat16), _t(a0), _t(b0),
                                    _t(w1), _t(idx),
                                    _t(g).to(torch.bfloat16))
    assert dy.dtype == dw1.dtype == dab.dtype == torch.float32
    assert dy.shape == (B, N, c0) and dw1.shape == (c0, c1)
    got = (dy, dab[0], dab[1], dw1)
    flip = _dy0_ulp(y, a0, b0, w1, idx, g)
    for tag, want in (("reference", ref[:4]), ("interpret kernel", interp)):
        for name, gv, wv in zip(("dy", "da0", "db0", "dw1"), got, want):
            _within(gv.numpy(), wv, BWD_REL, f"{tag} {name}",
                    flip if name == "dy" else 0.0)


@pytest.mark.parametrize("c0,c1", WIDTHS, ids=["12-12", "64-64"])
def test_edge_delta_mlp_vjp_matches_jax(c0, c1):
    """The autograd Function (plain route) against ``jax.vjp`` of the JAX
    ``edge_delta_mlp`` in interpret mode: values, ``dy`` (bf16), ``da0``,
    ``db0``, ``dw1`` (f32) and ``dz0``; the kernel route takes the plain
    versions on CPU tensors, with the same results."""
    rng = np.random.default_rng(60 + c0)
    y, a0, b0, w1, z0, idx = _data(rng, c0, c1, True)
    g = np.asarray(jnp.asarray(rng.standard_normal((B, K, N, c1)).astype(
        np.float32)).astype(jnp.bfloat16), np.float32)
    jidx = jnp.asarray(idx)

    def fwd(*a):
        return em.edge_delta_mlp(*a, jidx, TILE, True)

    want, vjp = jax.vjp(fwd, *_jargs(y, a0, b0, w1, z0))
    want_grads = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    flip = _dy0_ulp(y, a0, b0, w1, idx, g)
    for fn in (ops.edge_delta_mlp, ops.edge_delta_mlp_plain):
        leaves = [t.clone().requires_grad_()
                  for t in _targs(y, a0, b0, w1, z0)]
        out = fn(*leaves, _t(idx))
        out.backward(_t(g).to(torch.bfloat16))
        assert int(_bf16_ulps(out.detach().float().numpy(),
                              np.asarray(want, np.float32)).max()) <= 1
        assert leaves[0].grad.dtype == torch.bfloat16
        for name, leaf, wv, rel in zip(
                ("dy", "da0", "db0", "dw1", "dz0"), leaves, want_grads,
                (BWD_REL, BWD_REL, BWD_REL, BWD_REL, DZ0_REL)):
            wv = np.asarray(wv, np.float32)
            np.testing.assert_allclose(
                leaf.grad.float().numpy(), wv,
                rtol=ULP if name == "dy" else 0,
                atol=rel * float(np.abs(wv).max())
                + (flip if name == "dy" else 0.0), err_msg=name)


def test_edge_mlp_pads_odd_widths_and_clamps_indices():
    """Widths that are not multiples of 16 and indices outside [0, N)
    (JAX's indexing: a negative one counts from the end, one past the end
    is clamped) give the JAX reference's values."""
    rng = np.random.default_rng(70)
    y, a0, b0, w1, z0, idx = _data(rng, 5, 7, False)
    idx[0, 3, 2], idx[1, 4, 3] = -4, N + 9
    want = jax.jit(lambda *a: em._reference(*a, jnp.asarray(idx)))(
        *_jargs(y, a0, b0, w1, z0))
    got = ops.edge_mlp_fwd(*_targs(y, a0, b0, w1, z0), _t(idx))
    assert int(_bf16_ulps(got.float().numpy(),
                          np.asarray(want, np.float32)).max()) <= 1


def _out_of_range(rng, idx):
    """``idx`` with some slots >= 1 outside [0, N): negative ones (read
    from the end, then clamped) and ones from N up (clamped)."""
    idx = idx.copy()
    sel = rng.random(idx.shape) < 0.1
    sel[..., 0] = False
    far = rng.integers(-2 * N, 2 * N, idx.shape).astype(np.int32)
    idx[sel] = np.where((far >= 0) & (far < N), far + N, far)[sel]
    return idx


def _exact(rng, c0, c1):
    """Inputs whose f32 sums are exact in any order (values on coarse
    grids): every term of the backward is the same in any summation
    order, so an independent numpy computation gives the same bits."""
    def steps(shape, top, step):
        return (rng.integers(-top, top + 1, shape) * step).astype(np.float32)

    return (steps((B, N, c0), 32, 1 / 8), steps(c0, 16, 1 / 8),
            steps(c0, 8, 1 / 8), steps((c0, c1), 16, 1 / 16),
            steps((B, K, N, c1), 4, 1.0))


def _clamped(idx):
    return np.clip(np.where(idx < 0, idx + N, idx), 0, N - 1)


@pytest.mark.parametrize("masked", GRAPHS, ids=["uniform", "masked"])
@pytest.mark.parametrize("c0,c1", WIDTHS, ids=["12-12", "64-64"])
def test_edge_mlp_bwd_phases_compose_to_the_model(c0, c1, masked):
    """The backward's two plain phases (``edge_mlp_bwd_edges_plain``, then
    ``edge_mlp_bwd_sum_plain`` over the inverse adjacency of the clamped
    indices) give ``edge_mlp_bwd_plain``'s ``dy``, ``dw1`` and ``(da0,
    db0)`` bit for bit, on indices that are negative or >= N too; slot 0
    of the edge tensor is never read (NaN there changes nothing); the
    kernel wrappers take the plain versions on CPU tensors."""
    rng = np.random.default_rng(140 + c0 + masked)
    y, a0, b0, w1, z0, idx = _data(rng, c0, c1, masked)
    idx = _out_of_range(rng, idx)
    g = rng.standard_normal((B, K, N, c1)).astype(np.float32)
    args = (*_targs(y, a0, b0, w1, z0)[:4], _t(idx),
            _t(g).to(torch.bfloat16))
    dy, dw1, dab = ops.edge_mlp_bwd_plain(*args)
    e, s, dw1_e, dab_e = ops.edge_mlp_bwd_edges_plain(*args)
    assert e.dtype == torch.bfloat16 and e.shape == (B, K, N, c0)
    assert s.dtype == torch.float64 and s.shape == (B, N, c0)
    assert not bool(e[:, 0].any())
    e[:, 0] = float("nan")
    got = ops.edge_mlp_bwd_sum_plain(e, s, args[4])
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), dy.view(torch.int32))
    assert torch.equal(dw1_e, dw1) and torch.equal(dab_e, dab)
    assert torch.equal(ops.edge_mlp_bwd_sum(e, s, args[4]), got)
    for a_, b_ in zip(ops.edge_mlp_bwd_edges(*args),
                      (e, s, dw1_e, dab_e)):
        assert torch.equal(a_[:, 1:] if a_.dim() == 4 else a_,
                           b_[:, 1:] if b_.dim() == 4 else b_)


@pytest.mark.parametrize("c0,c1", WIDTHS, ids=["12-12", "64-64"])
def test_edge_tensor_and_self_rows_are_the_edge_terms(c0, c1):
    """Phase 1's outputs against an independent numpy computation on
    exact-sum inputs, indices outside [0, N) included: the edge tensor's
    slot k >= 1 at point n is ``bf16(dy0)`` of edge (n, k) (``dy0 = dh
    LeakyReLU'(pre) a0``, ``dh = g @ bf16(w1)^T``), slot 0 zero; the self
    rows are each point's f64 sum of its unrounded ``dy0``."""
    rng = np.random.default_rng(150 + c0)
    idx = _out_of_range(rng, _graph(rng, True))
    y, a0, b0, w1, g = _exact(rng, c0, c1)
    e, s, _, _ = ops.edge_mlp_bwd_edges_plain(
        _t(y).to(torch.bfloat16), _t(a0), _t(b0), _t(w1), _t(idx),
        _t(g).to(torch.bfloat16))
    nb = _clamped(idx)[:, :, 1:]
    y0 = y[np.arange(B)[:, None, None], nb] - y[:, :, None, :]
    pre = y0 * a0 + b0
    dh = np.moveaxis(g[:, 1:], 1, 2) @ w1.T  # exact: grid values
    dy0 = (dh * np.where(pre >= 0, 1.0, 0.2).astype(np.float32)
           * a0).astype(np.float32)
    want = np.asarray(jnp.asarray(dy0).astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(e[:, 1:].float().numpy(),
                                  np.moveaxis(want, 2, 1))
    assert not bool(e[:, 0].float().any())
    np.testing.assert_array_equal(s.numpy(),
                                  dy0.astype(np.float64).sum(axis=2))


@pytest.mark.parametrize("c0,c1", WIDTHS, ids=["12-12", "64-64"])
def test_edge_mlp_bwd_phases_match_jax(c0, c1):
    """The two plain phases composed against the JAX backward
    (``_reference_bwd`` and the interpret ``_pallas_bwd``): ``dy`` within
    BWD_REL x max plus one bf16 ulp of the largest edge term, as
    ``test_edge_mlp_backward_matches_jax`` holds the one-piece backward,
    on a masked graph (indices in [0, N): JAX's scatter drops the updates
    of indices from N up, where its gather clamps them; the port clamps
    both, as the composition tests above check)."""
    rng = np.random.default_rng(160 + c0)
    y, a0, b0, w1, z0, idx = _data(rng, c0, c1, True)
    g = np.asarray(jnp.asarray(rng.standard_normal((B, K, N, c1)).astype(
        np.float32)).astype(jnp.bfloat16), np.float32)
    jy, ja0, jb0, jw1, jz0 = _jargs(y, a0, b0, w1, z0)
    jidx, jg = jnp.asarray(idx), jnp.asarray(g).astype(jnp.bfloat16)
    ref = jax.jit(em._reference_bwd)(jy, ja0, jb0, jw1, jidx, jg)[0]
    _, y0 = jax.jit(lambda *a: em._pallas_fwd(*a, jidx, TILE, True))(
        jy, ja0, jb0, jw1, jz0)
    interp = jax.jit(lambda st: em._pallas_bwd(st, ja0, jb0, jw1, jidx, jg,
                                               N, TILE, True))(y0)[0]
    targs = (*_targs(y, a0, b0, w1, z0)[:4], _t(idx),
             _t(g).to(torch.bfloat16))
    e, s, _, _ = ops.edge_mlp_bwd_edges_plain(*targs)
    dy = ops.edge_mlp_bwd_sum_plain(e, s, targs[4]).numpy()
    flip = _dy0_ulp(y, a0, b0, w1, idx, g)
    for tag, want in (("reference", ref), ("interpret kernel", interp)):
        _within(dy, want, BWD_REL, f"{tag} dy", flip)


def test_inverse_adjacency_plain_clamp_mode():
    """``inverse_adjacency_plain(..., clamp=True)`` against lists built
    edge by edge from the indices as JAX reads them: every edge listed
    once, under its clamped row, ascending."""
    rng = np.random.default_rng(170)
    idx = rng.integers(-2 * N, 2 * N, (B, N, K)).astype(np.int32)
    offsets, edges = ops.inverse_adjacency_plain(_t(idx), N, clamp=True)
    rows = _clamped(idx).reshape(B, N * K)
    for b in range(B):
        lists = [[] for _ in range(N)]
        for e_, m in enumerate(rows[b]):
            lists[m].append(e_)
        want_off = np.cumsum([0] + [len(x) for x in lists])
        np.testing.assert_array_equal(offsets[b].numpy(), want_off)
        np.testing.assert_array_equal(edges[b].numpy(),
                                      np.concatenate(lists))


def _ties(rng, shape, dtype):
    """Values on a coarse grid (many exact ties), as numpy f32."""
    h = rng.integers(-2, 3, shape).astype(np.float32)
    return np.asarray(jnp.asarray(h).astype(dtype), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kmajor", [False, True], ids=["nk", "kn"])
def test_masked_max_routes_to_the_first_winner(kmajor, dtype):
    """``_MaskedMax`` against JAX's ``_masked_max`` (``[..., K, C]``, the
    reference pipeline's edge tensor) and ``_masked_max_kmajor``
    (``[..., K, N, C]``, the fused branch's): on exact ties the whole
    cotangent goes to the first maximal slot, bit-equal; fully masked
    rows give -inf."""
    rng = np.random.default_rng(80)
    jdt = jnp.dtype(dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    mask = rng.random((B, N, K)) > 0.3
    mask[1, 60:] = False
    h = _ties(rng, (B, N, K, 6), jdt)
    g = _ties(rng, (B, N, 6), jdt)
    if kmajor:
        h = np.ascontiguousarray(np.moveaxis(h, 2, 1))
        jm = jnp.asarray(np.swapaxes(mask, 1, 2))
        fn, dim, tm = jax_dc._masked_max_kmajor, 1, np.swapaxes(mask, 1, 2)
    else:
        jm = jnp.asarray(mask)[..., None]
        fn, dim, tm = jax_dc._masked_max, 2, mask
    want, vjp = jax.vjp(lambda a: fn(a, jm), jnp.asarray(h).astype(jdt))
    (want_dh,) = vjp(jnp.asarray(g).astype(jdt))

    hg = _t(h).to(tdt).requires_grad_()
    got = _MaskedMax.apply(hg, _t(tm)[..., None], dim)
    got.backward(_t(g).to(tdt))
    assert got.dtype == hg.grad.dtype == tdt
    got = got.detach().float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    np.testing.assert_array_equal(hg.grad.float().numpy(),
                                  np.asarray(want_dh, np.float32))
    assert np.isneginf(got[1, 60:]).all()
    # Ties were there to be broken.
    assert (np.asarray(want_dh) != 0).sum() < (h == np.asarray(
        want, np.float32)[(slice(None),) * dim + (None,)]).sum()
