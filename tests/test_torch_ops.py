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
from deltaconv_tpu.ops.gather_max import masked_nbr_max as jax_masked_max
from deltaconv_tpu.ops.gather_rows import gather_rows as jax_gather_rows
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
