"""The neighbour min/max of deltaconv_tpu_torch (``ops.gather_minmax`` with
its VJP, ``ops.gather_matmul_minmax``, the operator objects' hooks
``nbr_minmax`` and ``nbr_matmul_minmax`` and their point-sharded forms)
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs ``gather_minmax`` and ``gather_matmul_minmax`` as
tests/ops/test_kernels.py runs them: the Pallas kernels in interpret
mode, the VJP through its plain reference path. JAX's unsharded
``nbr_matmul_minmax`` hook lowers its Pallas call without ``interpret``
(TPU only), so its counterpart here is ``gather_matmul_minmax(...,
interpret=True)`` on the JAX operator object's ``nbr_idx`` and
``nbr_mask``. This module imports JAX inside its test functions, so the
spawned ``gloo`` ranks of the sharded test load only torch.

Tolerances, and why:

- The forwards' values and winners: equal. A max or a min is exact, and
  the first-winner rule (strict ``>`` and ``<``) is the same on both
  sides. The TPU kernel gathers f32 rows through a hi/lo bf16 pair, i.e.
  to 16 significant bits, so f32 inputs are drawn with at most 16
  (``_pair_exact``), which the pair holds exactly; bf16 inputs are exact
  in the one-hot product as they are.
- The VJP: within 1e-5 x max of ``jax.vjp`` (the same cotangents summed
  in another order); bf16 with integer cotangents, whose sums are exact
  in any order: equal.
- ``gather_matmul_minmax``: within one bf16 ulp (XLA's f32 sums run in
  another order than torch's); on inputs whose sums are exact in f32 in
  any order: equal.
- The sharded forms at 2 ranks: equal to the 1-process hooks where both
  round the same f32 values (f32 ``nbr_minmax``, bf16 ``nbr_minmax``),
  within one bf16 ulp for bf16 ``nbr_matmul_minmax`` (the full table's
  product and the per-point product are two matmuls); against the numpy
  reference within 2e-5, the bound of tests/training/test_point_sharding.py.
"""

import numpy as np
import pytest
import torch

from deltaconv_tpu_torch import KERNEL_OPS, PLAIN_OPS, ops
from deltaconv_tpu_torch.models import build_operators
from deltaconv_tpu_torch.parallel import (ShardedGradDiv, pad_cloud,
                                          point_sharded_operators, shard_rows)
from deltaconv_tpu_torch.parallel import point_sharding as ps
from deltaconv_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

VJP_REL = 1e-5
SHARD_ATOL = 2e-5
SPAWN_TIMEOUT = 240  # s: both ranks must finish within it
NEG = np.float32(-3e38)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gm():
    """The JAX module (``deltaconv_tpu.ops`` exports functions of the same
    names, so the module is imported by its path)."""
    import importlib
    return importlib.import_module("deltaconv_tpu.ops.gather_max")


def _pair_exact(rng, shape):
    """f32 values with at most 16 significant bits; many repeat."""
    return (rng.integers(-2**11, 2**11, shape) / 2.0**6).astype(np.float32)


def _graph(rng, b, n, k, masked):
    """Neighbour lists with repeated indices (exact ties); masked: random
    masked slots, a row with no valid neighbour (0, 5) and a row with one
    valid slot (1, 7), where the max and the min win at the same slot."""
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    mask = np.ones((b, n, k), bool)
    if masked:
        mask = rng.random((b, n, k)) > 0.3
        mask[0, 5] = False
        mask[1, 7] = False
        mask[1, 7, 3] = True
    return idx, mask


def _inputs(rng, dtype, masked, b=2, n=256, k=10, c=24):
    """``(h as numpy f32, h for JAX, h for the port, idx, mask)``."""
    import jax.numpy as jnp
    if dtype == "float32":
        h = _pair_exact(rng, (b, n, c))
        return h, jnp.asarray(h), _t(h), *_graph(rng, b, n, k, masked)
    hj = jnp.asarray(rng.standard_normal((b, n, c)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    h = np.asarray(hj, np.float32)
    return (h, hj, _t(h).to(torch.bfloat16), *_graph(rng, b, n, k, masked))


def _f32(t):
    return (t.float() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _gathered(h, idx):
    """``[B, N, K, C]`` rows of ``h`` at ``idx``, a zero row at an id
    outside [0, N)."""
    b, n, c = h.shape
    hp = np.concatenate([h, np.zeros((b, 1, c), h.dtype)], axis=1)
    ids = np.where((idx < 0) | (idx >= n), n, idx)
    return hp[np.arange(b)[:, None, None], ids]


def _numpy_minmax(h, idx, mask):
    """Masked max and min and their first winners, in numpy; a valid id
    outside [0, N) gathers a zero row."""
    g = _gathered(h, idx)
    m = mask[..., None]
    vmax = np.where(m, g, NEG)
    vmin = np.where(m, g, -NEG)
    return (vmax.max(2), vmin.min(2), vmax.argmax(2), vmin.argmin(2))


def _harden(idx, mask, n):
    """The masked graph's hard rows: slot 0 masked on a row with later
    valid slots (0, 9); a second row with no valid slot (1, 3); valid ids
    outside the cloud, which gather a zero row: past its end, the only
    valid slot of (0, 11), and negative, slot 0 of (1, 12); a row whose
    valid slots all read one row, from slot 1 on (1, 14: the max and the
    min win at the same slot)."""
    idx, mask = idx.copy(), mask.copy()
    mask[0, 9, 0], mask[0, 9, 1:4] = False, True
    mask[1, 3] = False
    mask[0, 11] = False
    idx[0, 11, 2], mask[0, 11, 2] = n + 3, True
    idx[1, 12, 0], mask[1, 12, 0] = -2, True
    idx[1, 14], mask[1, 14, 0], mask[1, 14, 1:] = 7, False, True
    return idx, mask


def _zero_row(fn, h, idx, mask):
    """``fn(h, idx, mask)`` where valid ids outside [0, N) gather 0: on
    ``h`` with a zero row appended (and a point with no valid slot,
    dropped after), those ids pointed at it; the torch plain versions
    index ``h`` directly."""
    b, n, c = h.shape
    k = idx.shape[-1]
    hp = torch.cat([h, torch.zeros((b, 1, c), dtype=h.dtype)], dim=1)
    ids = torch.where((idx < 0) | (idx >= n), n, idx)
    ids = torch.cat([ids, torch.zeros((b, 1, k), dtype=idx.dtype)], dim=1)
    valid = torch.cat([mask, torch.zeros((b, 1, k), dtype=torch.bool)], dim=1)
    return tuple(o[:, :n] for o in fn(hp, ids, valid))


# -- gather_minmax (#10) ---------------------------------------------------


@pytest.mark.parametrize("graph", ["uniform", "masked", "hard"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_minmax_matches_pallas_interpret(dtype, graph):
    """Values equal to JAX's ``gather_minmax`` (interpret) and, with
    winners, values and first winners equal to ``_pallas_minmax(...,
    winners=True)``, through the wrapper (CPU: the plain versions) and
    the plain bundle; bf16 in, bf16 out; a row with no valid neighbour
    gives (-3e38, +3e38) as JAX rounds them, winners 0. The hard rows
    (``_harden``): a masked slot 0, two rows with no valid slot, valid ids
    outside the cloud (JAX's one-hot row has no match: a zero row, which
    the port's kernels read too; its plain versions take ``h`` with a zero
    row appended, ``_zero_row``), and rows where the max and the min win
    at the same slot."""
    import jax.numpy as jnp
    gm = _gm()
    rng = np.random.default_rng(20)
    h, hj, ht, idx, mask = _inputs(rng, dtype, graph != "uniform")
    if graph == "hard":
        idx, mask = _harden(idx, mask, h.shape[1])
    args_j = (hj, jnp.asarray(idx), jnp.asarray(mask))
    want = gm.gather_minmax(*args_j, True)
    want_w = gm._pallas_minmax(*args_j, tile=128, interpret=True,
                               winners=True)

    def port(fn):
        if graph == "hard":
            return _zero_row(fn, ht, _t(idx), _t(mask))
        return fn(ht, _t(idx), _t(mask))

    for fn in (ops.gather_minmax, ops.gather_minmax_plain,
               KERNEL_OPS.gather_minmax, PLAIN_OPS.gather_minmax):
        got = port(fn)
        for g, w in zip(got, want):
            assert g.dtype == ht.dtype
            np.testing.assert_array_equal(_f32(g).numpy(), _f32(w))
    got_w = port(ops.gather_minmax_win)
    for g, w in zip(got_w, want_w):
        np.testing.assert_array_equal(_f32(g).numpy(), _f32(w))
    assert got_w[2].dtype == got_w[3].dtype == torch.int32
    mx, mn, wmx, wmn = _numpy_minmax(h, idx, mask)
    np.testing.assert_array_equal(got_w[2].numpy(), wmx)
    np.testing.assert_array_equal(got_w[3].numpy(), wmn)
    vals = np.where(mask[..., None], _gathered(h, idx), np.nan)
    ties = ((vals == mx[:, :, None]).sum(2) > 1).sum()
    assert ties > 20  # the first-winner rule decided these
    if graph == "uniform":
        return
    sentinels = torch.tensor([NEG, -NEG]).to(ht.dtype)
    empty = ((0, 5), (1, 3)) if graph == "hard" else ((0, 5),)
    for row in empty:
        assert not got_w[2][row].any() and not got_w[3][row].any()
        assert bool((got_w[0][row] == sentinels[0]).all())
        assert bool((got_w[1][row] == sentinels[1]).all())
    assert torch.equal(got_w[2][1, 7], got_w[3][1, 7])  # one valid slot
    if graph == "hard":
        assert bool((got_w[2][1, 14] == 1).all())  # every slot one row
        assert bool((got_w[3][1, 14] == 1).all())
        assert bool((got_w[2][0, 9] > 0).all())  # slot 0 masked
        assert bool((got_w[3][0, 9] > 0).all())
        # The zero row of the id past the end, its only valid slot.
        assert not bool(got_w[0][0, 11].any() or got_w[1][0, 11].any())
        assert bool((got_w[2][0, 11] == 2).all())
        assert bool((got_w[3][0, 11] == 2).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_minmax_nan_rule(dtype):
    """The NaN rule, against the port's plain versions only (the TPU
    kernel's one-hot product spreads a NaN across its tile, so JAX is no
    reference there): a NaN in a valid slot propagates to the max and the
    min of its channel, with winner 0 (no slot equals it); a NaN in a
    masked slot changes nothing; the winners of the other channels stay
    the first slot that holds the extreme."""
    rng = np.random.default_rng(26)
    h, _, ht, idx, mask = _inputs(rng, dtype, True, n=64, k=6, c=8)
    row = idx[0, 2, 1]
    mask[0, 2, :3] = True
    ht[0, row, 3] = float("nan")  # read by (0, 2)'s valid slot 1
    gone = idx[0, 4][~mask[0, 4]]
    if gone.size:
        ht[0, gone[0], 5] = float("nan")  # read by (0, 4) only where masked
    mx, mn, wmx, wmn = ops.gather_minmax_win(ht, _t(idx), _t(mask))
    got = ops.gather_minmax(ht, _t(idx), _t(mask))
    for a, b in zip(got, (mx, mn)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
    readers = (_t(idx)[..., None] == row) & _t(mask)[..., None]
    nan_rows = readers[0].any(1)[:, 0]  # points of cloud 0 that read it
    assert bool(torch.isnan(mx[0, nan_rows, 3]).all())
    assert bool(torch.isnan(mn[0, nan_rows, 3]).all())
    assert not bool(wmx[0, nan_rows, 3].any())
    assert not bool(wmn[0, nan_rows, 3].any())
    h_nan = _f32(ht).numpy()
    finite = ~np.isnan(_f32(mx).numpy())
    want = _numpy_minmax(np.nan_to_num(h_nan, nan=0.0), idx, mask)
    want = [_f32(_t(w).to(ht.dtype)).numpy() for w in want[:2]] + list(
        want[2:])  # the sentinels as the dtype rounds them
    for g, w in zip((mx, mn, wmx, wmn), want):
        np.testing.assert_array_equal(_f32(g).numpy()[finite], w[finite])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_minmax_vjp_matches_jax(dtype):
    """The gradient of ``sum(mx g1) - 2 sum(mn g2)``
    (tests/ops/test_kernels.py:222-240) against ``jax.vjp`` of JAX's
    ``gather_minmax`` and a numpy scatter: each cotangent to its output's
    first winner. Cotangents are nonzero on the row with no valid
    neighbour (routed to ``idx[0, 5, 0]``, JAX's winner 0) and on the row
    with one valid slot (the max's and the min's add at one row). f32:
    within 1e-5 x max; bf16 with integer cotangents (sums exact in any
    order): equal, and ``dh`` in bf16."""
    import jax
    import jax.numpy as jnp
    gm = _gm()
    rng = np.random.default_rng(21)
    h, hj, ht, idx, mask = _inputs(rng, dtype, True, n=96, k=8, c=16)
    if dtype == "float32":
        g1 = rng.standard_normal(h.shape).astype(np.float32)
        g2 = rng.standard_normal(h.shape).astype(np.float32)
    else:
        g1 = rng.integers(-4, 5, h.shape).astype(np.float32)
        g2 = rng.integers(-4, 5, h.shape).astype(np.float32)
    jdt = hj.dtype
    _, vjp = jax.vjp(lambda a: gm.gather_minmax(a, jnp.asarray(idx),
                                                jnp.asarray(mask)), hj)
    (want,) = vjp((jnp.asarray(g1).astype(jdt),
                   jnp.asarray(-2.0 * g2).astype(jdt)))
    want = np.asarray(want, np.float32)
    _, _, wmx, wmn = _numpy_minmax(h, idx, mask)
    acc = np.zeros(h.shape, np.float64)
    bi, ni, ci = np.indices(h.shape)
    np.add.at(acc, (bi, np.take_along_axis(idx, wmx, 2), ci), g1)
    np.add.at(acc, (bi, np.take_along_axis(idx, wmn, 2), ci), -2.0 * g2)
    np.testing.assert_allclose(want, acc, atol=VJP_REL * np.abs(acc).max())
    r0 = idx[0, 5, 0]
    assert np.abs(acc[0, r0]).max() > 0
    for fn in (ops.gather_minmax, ops.gather_minmax_plain):
        hg = ht.clone().requires_grad_()
        mx, mn = fn(hg, _t(idx), _t(mask))
        torch.autograd.backward(
            (mx, mn), (_t(g1).to(ht.dtype), _t(-2.0 * g2).to(ht.dtype)))
        assert hg.grad.dtype == ht.dtype
        got = hg.grad.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want,
                                       atol=VJP_REL * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)


def test_gather_minmax_bwd_two_maps_add():
    """The two-map backward adds both cotangents where the max and the
    min win at the same row and channel, and equals two one-map
    backwards summed."""
    rng = np.random.default_rng(22)
    _, _, ht, idx, mask = _inputs(rng, "float32", True, n=64, k=6, c=8)
    _, _, wmx, wmn = ops.gather_minmax_win(ht, _t(idx), _t(mask))
    gmx, gmn = torch.randn(ht.shape), torch.randn(ht.shape)
    dh = ops.gather_minmax_bwd(_t(idx), wmx, gmx, wmn, gmn, 64)
    assert dh.dtype == torch.float32
    two = (ops.gather_max_bwd(_t(idx), wmx, gmx, 64)
           + ops.gather_max_bwd(_t(idx), wmn, gmn, 64))
    torch.testing.assert_close(dh, two, rtol=0, atol=1e-6)
    j = idx[1, 7, wmx[1, 7, 0]]  # the one-slot row: same winner for both
    solo = torch.zeros_like(gmx)
    solo[1, 7] = 1.0
    d1 = ops.gather_minmax_bwd(_t(idx), wmx, solo, wmn, 2 * solo, 64)
    assert float(d1[1, j, 0]) == 3.0


def test_gather_minmax_self_slot0_matches_jax():
    """JAX's self-slot shortcut (tests/ops/test_kernels.py:630: read the
    own rows for slot 0 when ``idx[..., 0] == arange(N)``, interpret,
    bf16): the port loads every slot directly and gives the same values."""
    import jax.numpy as jnp
    gm = _gm()
    rng = np.random.default_rng(23)
    b, n, k, c = 2, 256, 9, 16
    hj = jnp.asarray(rng.standard_normal((b, n, c)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[:, :, 0] = np.arange(n)
    mask = rng.random((b, n, k)) > 0.2
    mask[:, :, 0] = True
    want = gm.gather_minmax(hj, jnp.asarray(idx), jnp.asarray(mask), True,
                            True)
    got = ops.gather_minmax(_t(np.asarray(hj, np.float32)).to(
        torch.bfloat16), _t(idx), _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), _f32(w))


# -- gather_matmul_minmax (#13) ---------------------------------------------


def _bf16_ulps(a, b):
    """Per-element distance in bf16 ulps of two bf16-valued arrays."""
    def ordered(x):
        u = torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16).view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("draw", ["random", "exact"])
def test_gather_matmul_minmax_matches_pallas_interpret(draw):
    """``(x @ w)[idx]``'s masked max and min against JAX's
    ``gather_matmul_minmax`` in interpret mode
    (tests/ops/test_kernels.py:474's shapes, C_out = 24, not a multiple of
    16), a row with no valid neighbour included: random bf16 inputs
    within one bf16 ulp; inputs whose products and sums are exact in f32
    in any order equal."""
    import jax.numpy as jnp
    gm = _gm()
    rng = np.random.default_rng(24)
    b, n, k, ci, co = 2, 128, 7, 16, 24
    if draw == "random":
        x = rng.standard_normal((b, n, ci))
        w = rng.standard_normal((ci, co))
    else:
        x = rng.integers(-32, 33, (b, n, ci)) / 8.0
        w = rng.integers(-16, 17, (ci, co)) / 16.0
    xj = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
    wj = jnp.asarray(w.astype(np.float32)).astype(jnp.bfloat16)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    mask = rng.random((b, n, k)) > 0.2
    mask[:, :, 0] = True
    mask[0, 3] = False
    want = gm.gather_matmul_minmax(xj, wj, jnp.asarray(idx),
                                   jnp.asarray(mask), interpret=True)
    xt = _t(np.asarray(xj, np.float32)).to(torch.bfloat16)
    wt = _t(np.asarray(wj, np.float32)).to(torch.bfloat16)
    for fn in (ops.gather_matmul_minmax, ops.gather_matmul_minmax_plain):
        got = fn(xt, wt, _t(idx), _t(mask))
        for g, wv in zip(got, want):
            assert g.dtype == torch.bfloat16 and g.shape == (b, n, co)
            if draw == "exact":
                np.testing.assert_array_equal(g.float().numpy(), _f32(wv))
            else:
                assert int(_bf16_ulps(g.float().numpy(), _f32(wv)).max()) <= 1
        sentinels = torch.tensor([NEG, -NEG]).to(torch.bfloat16)
        assert bool((got[0][0, 3] == sentinels[0]).all())
        assert bool((got[1][0, 3] == sentinels[1]).all())


def test_gather_matmul_minmax_refuses_grad():
    """Forward only, as JAX's (no VJP): the wrapper, its plain twin and
    the hook raise on an input or weight that requires grad, on the CPU
    as on the card."""
    rng = np.random.default_rng(25)
    idx = _t(rng.integers(0, 16, (1, 16, 4)).astype(np.int32))
    mask = torch.ones((1, 16, 4), dtype=torch.bool)
    x = torch.randn((1, 16, 8)).to(torch.bfloat16)
    w = torch.randn((8, 16)).to(torch.bfloat16)
    for fn in (ops.gather_matmul_minmax, ops.gather_matmul_minmax_plain):
        for args in ((x.clone().requires_grad_(), w),
                     (x, w.clone().requires_grad_())):
            with pytest.raises(ValueError, match="forward only"):
                fn(*args, idx, mask)
    gd = build_operators(torch.randn(1, 16, 3), 4,
                         torch.nn.functional.normalize(torch.randn(1, 16, 3),
                                                       dim=-1))
    with pytest.raises(ValueError, match="forward only"):
        gd.nbr_matmul_minmax(torch.randn(1, 16, 8, requires_grad=True), w)


# -- the hooks on the operator objects ---------------------------------------


def _cloud(rng, b, n):
    d = rng.standard_normal((b, n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axes = rng.uniform(0.5, 1.5, (b, 1, 3)).astype(np.float32)
    nrm = d / axes
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return d * axes, nrm


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coef"])
def test_hooks_match_jax_operator_objects(dense):
    """``nbr_minmax`` (f32 and bf16, values and the gradient of
    ``sum(mx g1) - 2 sum(mn g2)``) and ``nbr_matmul_minmax`` (bf16) on the
    operator object that the classifier's build gives in each package
    (``DenseGradDiv``, or ``GradDiv`` in coefficient form) for the same
    two clouds, the second padded to 100 of 128 points (its padded rows
    have no valid neighbour): the neighbour sets equal, the hooks' values
    equal, the gradient within 1e-5 x max, the matmul form within one
    bf16 ulp of JAX's ``gather_matmul_minmax`` (interpret, the hook's
    ``self_slot0``) on the JAX object's graph."""
    import jax
    import jax.numpy as jnp
    from deltaconv_tpu.geometry.dense import densify as jax_densify
    from deltaconv_tpu.models.deltanet_base import \
        build_operators as jax_build
    gm = _gm()
    rng = np.random.default_rng(26)
    b, n, k, c = 2, 128, 10, 24
    pos, nrm = _cloud(rng, b, n)
    pm = np.ones((b, n), bool)
    pm[1, 100:] = False
    pos[1, 100:], nrm[1, 100:] = 0.0, [0.0, 0.0, 1.0]
    jgd = jax_build(jnp.asarray(pos), k, jnp.asarray(nrm), jnp.asarray(pm))
    if dense:
        jgd = jax_densify(jgd)
    gd = build_operators(_t(pos), k, _t(nrm), _t(pm),
                         dense_operators=dense)
    assert type(gd).__name__ == ("DenseGradDiv" if dense else "GradDiv")
    jidx, jmask = np.asarray(jgd.nbr_idx), np.asarray(jgd.nbr_mask)
    np.testing.assert_array_equal(gd.nbr_mask.numpy(), jmask)
    for bi in range(b):
        for i in range(n):
            assert (set(gd.nbr_idx[bi, i][gd.nbr_mask[bi, i]].tolist())
                    == set(jidx[bi, i][jmask[bi, i]].tolist())), (bi, i)
    assert not jmask[1, 100:].any()

    h = rng.standard_normal((b, n, c)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        hj = jnp.asarray(h).astype(jdt)
        want = jgd.nbr_minmax(hj)
        got = gd.nbr_minmax(_t(np.asarray(hj, np.float32)).to(dt))
        for g, w in zip(got, want):
            assert g.dtype == dt
            np.testing.assert_array_equal(g.float().numpy(), _f32(w))

    # The rows with no valid neighbour (the padded points) get the zero
    # cotangent a caller that masks them gives: their masked slots differ
    # between the two kNNs (JAX fills a padded row's slots with 0, the
    # port with the point itself), and each routes such a row's cotangent
    # to its slot 0. That routing is held on one graph by
    # test_gather_minmax_vjp_matches_jax; here it is shown apart.
    live = pm[..., None].astype(np.float32)
    g1 = rng.standard_normal((b, n, c)).astype(np.float32)
    g2 = rng.standard_normal((b, n, c)).astype(np.float32)
    _, vjp = jax.vjp(jgd.nbr_minmax, jnp.asarray(h))
    (want,) = vjp((jnp.asarray(g1 * live), jnp.asarray(-2.0 * g2 * live)))
    want = np.asarray(want)
    assert np.abs(want[1, 100:]).max() == 0  # nothing routes to padding
    hg = _t(h).requires_grad_()
    torch.autograd.backward(gd.nbr_minmax(hg),
                            (_t(g1 * live), _t(-2.0 * g2 * live)))
    np.testing.assert_allclose(hg.grad.numpy(), want,
                               atol=VJP_REL * np.abs(want).max())
    dead = _t(1.0 - live).expand(b, n, c).contiguous()
    (want,) = vjp((jnp.asarray(dead.numpy()), jnp.zeros((b, n, c))))
    want = np.asarray(want)
    assert want[1, 0].sum() == 28 * c and np.abs(want).sum() == 28 * c
    hg = _t(h).requires_grad_()
    torch.autograd.backward(gd.nbr_minmax(hg), (dead, torch.zeros_like(dead)))
    assert torch.equal(hg.grad, dead)  # each padded row to itself

    x = rng.standard_normal((b, n, 16)).astype(np.float32)
    w = rng.standard_normal((16, c)).astype(np.float32) / 4
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    want = gm.gather_matmul_minmax(xj, wj, jgd.nbr_idx, jgd.nbr_mask,
                                   interpret=True, self_slot0=True)
    got = gd.nbr_matmul_minmax(_t(x), _t(w))
    for g, wv in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert int(_bf16_ulps(g.float().numpy(), _f32(wv)).max()) <= 1


def test_hooks_route_through_the_ops_bundle():
    """The hooks call ``self.ops``: the kernel bundle and the plain one
    give the same values on the CPU, and neither launches a kernel."""
    rng = np.random.default_rng(27)
    pos, nrm = _cloud(rng, 2, 64)
    h = torch.randn((2, 64, 8))
    x, w = torch.randn((2, 64, 16)), torch.randn((16, 8))
    ops.reset_launch_counts()
    outs = []
    for bundle in (KERNEL_OPS, PLAIN_OPS):
        gd = build_operators(_t(pos), 8, _t(nrm), ops=bundle)
        outs.append((*gd.nbr_minmax(h), *gd.nbr_matmul_minmax(x, w)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert sum(ops.launch_counts().values()) == 0


# -- the sharded forms on two gloo ranks --------------------------------------


def _sharded_hooks(job, group):
    """The sharded hooks of this rank's rows, gathered whole: for each
    dtype ``nbr_minmax(h)`` and ``nbr_matmul_minmax(x, w)``."""
    rank, size = ps.rank_and_size(group)
    pos, nrm = _t(job["pos"]), _t(job["normal"])
    p, q, m = pad_cloud(pos, size, nrm)
    p, q, m = (shard_rows(t, group) for t in (p, q, m))
    sgd = ShardedGradDiv(point_sharded_operators(p, job["k"], q, m, group),
                         group)
    out = {"rank_size": (rank, size),
           "idx": ps.all_gather(sgd.nbr_idx[0], group),
           "mask": ps.all_gather(sgd.nbr_mask[0], group)}
    for dt in (torch.float32, torch.bfloat16):
        h = shard_rows(_t(job["h"]).to(dt), group)[None]
        x = shard_rows(_t(job["x"]).to(dt), group)[None]
        w = _t(job["w"]).to(dt)
        res = (*sgd.nbr_minmax(h), *sgd.nbr_matmul_minmax(x, w))
        out[str(dt)] = [ps.all_gather(t[0], group) for t in res]
    return out


def _spawn(job, world=2):
    """Runs the sharded hooks on ``world`` gloo ranks
    (``parallel.launch``); rank 0's results."""
    return run_ranks(_run_hooks, world, job, timeout=SPAWN_TIMEOUT)[0]


def _run_hooks(group, job):
    return _sharded_hooks(job, group)


def test_sharded_hooks_two_ranks():
    """``ShardedGradDiv.nbr_minmax`` and ``nbr_matmul_minmax`` on 2 gloo
    ranks (a cloud of 256 points, k=8), held against the 1-process hooks
    on the same cloud's operators (``build_operators``, coefficient form)
    and against a numpy reference on the sharded graph
    (tests/training/test_point_sharding.py:278): f32 ``nbr_minmax`` and
    bf16 ``nbr_minmax`` equal to the hook; bf16 ``nbr_matmul_minmax``
    within one bf16 ulp of the hook (which always works in bf16); f32
    ``nbr_matmul_minmax`` (the product rounded to f32, as JAX's sharded
    form) within 2e-5 of numpy."""
    rng = np.random.default_rng(28)
    n, k = 256, 8
    pos, nrm = (a[0] for a in _cloud(rng, 1, n))
    job = dict(pos=pos, normal=nrm, k=k,
               h=rng.standard_normal((n, 12)).astype(np.float32),
               x=rng.random((n, 4)).astype(np.float32),
               w=rng.random((4, 6)).astype(np.float32))
    got = _spawn(job)
    assert got["rank_size"] == (0, 2)
    gd = build_operators(_t(pos)[None], k, _t(nrm)[None],
                         dense_operators=False)
    idx, mask = got["idx"].numpy(), got["mask"].numpy()
    assert mask.all()
    for i in range(n):
        assert set(idx[i].tolist()) == set(gd.nbr_idx[0, i].tolist()), i
    for dt in (torch.float32, torch.bfloat16):
        mx, mn, mmx, mmn = got[str(dt)]
        h = _t(job["h"]).to(dt)[None]
        for g, wv in zip((mx, mn), gd.nbr_minmax(h)):
            assert g.dtype == dt
            assert torch.equal(g, wv[0])
        y = job["x"] @ job["w"]
        if dt == torch.bfloat16:
            y = (_t(job["x"]).to(dt).float() @ _t(job["w"]).to(dt).float()
                 ).numpy()
            for g, wv in zip((mmx, mmn), gd.nbr_matmul_minmax(
                    _t(job["x"])[None], _t(job["w"]))):
                assert g.dtype == dt
                assert int(_bf16_ulps(g.float().numpy(),
                                      wv[0].float().numpy()).max()) <= 1
        want_mx, want_mn = y[idx].max(axis=1), y[idx].min(axis=1)
        atol = SHARD_ATOL if dt == torch.float32 else 2.0 ** -7 * np.abs(
            y).max()
        np.testing.assert_allclose(mmx.float().numpy(), want_mx, atol=atol)
        np.testing.assert_allclose(mmn.float().numpy(), want_mn, atol=atol)


def test_sharded_hooks_one_rank_match_the_hooks():
    """At one rank (``group=None``) the sharded forms on the padded cloud
    (255 points, padded to 256 by ``pad_cloud``: the padded row has no
    valid neighbour) give the unsharded hooks' values on the same graph,
    (-3e38, +3e38) on the padded row, f32 and bf16."""
    rng = np.random.default_rng(29)
    n, k = 255, 8
    pos, nrm = (a[0] for a in _cloud(rng, 1, n))
    p, q, m = pad_cloud(_t(pos), 2, _t(nrm))
    local = point_sharded_operators(p, k, q, m)
    sgd = ShardedGradDiv(local)
    assert not local.nbr_mask[0, n:].any()
    h = torch.randn((1, n + 1, 5))
    for dt in (torch.float32, torch.bfloat16):
        got = sgd.nbr_minmax(h.to(dt))
        want = local.nbr_minmax(h.to(dt))
        for g, wv in zip(got, want):
            assert g.dtype == dt and torch.equal(g, wv)
        assert bool((got[0][0, n] == torch.tensor(NEG).to(dt)).all())
        assert bool((got[1][0, n] == torch.tensor(-NEG).to(dt)).all())
