"""The coefficients' cotangent of an operator apply, ``ops.coef_cotangent``
(a sampled product), against the JAX package on the CPU.

``coef_cotangent(feat, ct, idx)`` is the cotangent of the coefficient-form
applies with respect to their coefficients, and of the dense applies with
respect to the coefficients they were densified from: grad ``d[n, k, e] =
sum_c x[idx[n, k], c] * ct[n, e, c]``, div ``d[n, k, e] = sum_c v[idx[n,
k], e, c] * ct[n, c]``. Its plain version (what the wrapper takes on CPU
tensors) is held against

- ``jax.vjp`` of JAX's ``coef_apply_grad`` / ``coef_apply_div`` in
  interpret mode (their ``gather_rows`` and ``einsum`` VJP), and
- ``jax.vjp`` of JAX's dense apply, ``densify_coefs`` (interpret mode, its
  ``_densify_bwd`` gather) then the ``einsum`` of ``DenseGradDiv.grad`` /
  ``.div``, with respect to the coefficients,

on kNN-like graphs (self in slot 0, distinct columns), ragged ones (a
padded cloud, its rows clamped to self; masked slots clamped to self, so
columns repeat) and ones with indices outside ``[0, N)`` (which give 0),
at C = 3, 8, 16. Inputs are numpy draws from a seed.

Tolerances, and why:

- Against an f64 ``numpy.einsum`` of the same gathered rows: the plain
  version takes each dot in f64 and rounds once, so it is within one f32
  ulp of the f64 value plus the f64 summation bound ``C 2^-52 sum_c |x_c
  ct_c|`` (measured: equal to numpy's f64 value rounded on all 73,728
  entries of the cases below).
- Against JAX: its kernels gather f32 rows through bf16 ``hi + lo``
  halves (about 16 mantissa bits) and sum the C products in f32, so each
  entry is held within ``(2^-15 + C 2^-23) sum_c |x_c ct_c|`` (measured:
  at most 6.6e-6 of that sum, 4.2e-6 of the largest entry).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu.geometry.dense import DenseGradDiv as JaxDense
from deltaconv_tpu_torch import KERNEL_OPS, PLAIN_OPS, ops
from deltaconv_tpu_torch.geometry import GradDiv
from deltaconv_tpu_torch.geometry.dense import densify

jax_coef = importlib.import_module("deltaconv_tpu.ops.coef_apply")
jax_densify = importlib.import_module("deltaconv_tpu.ops.densify_op")

torch.set_num_threads(1)

B, N, K = 2, 128, 8
TILE = 128
WIDTHS = (3, 8, 16)
GRAPHS = ("uniform", "ragged", "outside")
JAX_BITS = 2.0 ** -15  # the JAX gathers' hi + lo bf16 halves


def _t(x):
    return torch.from_numpy(np.array(x))


def _graph(rng, kind):
    """``idx [B, N, K]`` i32 and coefficients ``[B, N, K, 2]``: kNN-like
    rows; "ragged": the second cloud's last 40 points padded (every slot
    the point itself, zero coefficients) and the last 3 slots of every
    other point masked (clamped to self, zero); "outside": those, and a
    fifth of the slots set to -1 or N."""
    idx = np.stack([np.stack([np.concatenate(
        [[i], rng.permutation(np.delete(np.arange(N), i))[:K - 1]])
        for i in range(N)]) for _ in range(B)]).astype(np.int32)
    coef = rng.standard_normal((B, N, K, 2)).astype(np.float32)
    if kind != "uniform":
        idx[1, N - 40:] = np.arange(N - 40, N)[:, None]
        coef[1, N - 40:] = 0.0
        idx[:, ::2, -3:] = np.arange(0, N, 2)[None, :, None]
        coef[:, ::2, -3:] = 0.0
    if kind == "outside":
        out = rng.random((B, N, K)) < 0.2
        idx[out] = rng.choice(np.array([-1, N], np.int32), int(out.sum()))
    return idx, coef


def _inputs(rng, mode, c):
    feat_shape = (B, N, c) if mode == "grad" else (B, N, 2, c)
    ct_shape = (B, N, 2, c) if mode == "grad" else (B, N, c)
    return (rng.standard_normal(feat_shape).astype(np.float32),
            rng.standard_normal(ct_shape).astype(np.float32))


def _f64(feat, ct, idx, mode):
    """The cotangent in f64 (numpy) and its scale ``sum_c |x_c ct_c|``."""
    inside = (idx >= 0) & (idx < N)
    j = np.where(inside, idx, 0)
    rows = feat.astype(np.float64)[np.arange(B)[:, None, None], j]
    keep = inside.reshape(inside.shape + (1,) * (rows.ndim - 3))
    rows = np.where(keep, rows, 0.0)
    eq = "bnkc,bnec->bnke" if mode == "grad" else "bnkec,bnc->bnke"
    ct64 = ct.astype(np.float64)
    return np.einsum(eq, rows, ct64), np.einsum(eq, np.abs(rows),
                                                np.abs(ct64))


def _jax_coef_vjp(feat, ct, idx, coef, mode):
    fn = jax_coef.coef_apply_grad if mode == "grad" else \
        jax_coef.coef_apply_div
    _, vjp = jax.vjp(lambda w: fn(jnp.asarray(feat), w, jnp.asarray(idx),
                                  TILE, True), jnp.asarray(coef))
    return np.asarray(vjp(jnp.asarray(ct))[0])


def _jax_dense_vjp(feat, ct, idx, coef, mode):
    """The coefficients' cotangent through JAX's dense form: both
    coefficient tensors densified (interpret mode), then one apply."""
    j_idx = jnp.asarray(idx)
    mask = jnp.ones(idx.shape, bool)

    def apply(gc, dc):
        wg, wd = jax_densify.densify_coefs(j_idx, gc, dc, "float32", TILE,
                                           True)
        op = JaxDense(nbr_idx=j_idx, nbr_mask=mask, w_grad=wg, w_div=wd)
        x = jnp.asarray(feat)
        return op.grad(x) if mode == "grad" else op.div(x)

    zero = jnp.zeros_like(jnp.asarray(coef))
    _, vjp = jax.vjp(apply, jnp.asarray(coef), zero)
    dg, dd = vjp(jnp.asarray(ct))
    return np.asarray(dg if mode == "grad" else dd)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("mode", ["grad", "div"])
def test_coef_cotangent_matches_jax(mode, graph, c):
    """The plain version (and the wrapper on CPU tensors) against the
    f64 value, JAX's coefficient-form VJP and JAX's dense VJP."""
    rng = np.random.default_rng(100 + 10 * WIDTHS.index(c)
                                + GRAPHS.index(graph))
    idx, coef = _graph(rng, graph)
    feat, ct = _inputs(rng, mode, c)
    got = ops.coef_cotangent_plain(_t(feat), _t(ct), _t(idx))
    assert got.dtype == torch.float32 and got.shape == (B, N, K, 2)
    assert torch.equal(ops.coef_cotangent(_t(feat), _t(ct), _t(idx)), got)
    g = got.numpy().astype(np.float64)
    exact, scale = _f64(feat, ct, idx, mode)
    ulp = np.spacing(np.abs(exact.astype(np.float32))).astype(np.float64)
    assert np.all(np.abs(g - exact) <= ulp + c * 2.0 ** -52 * scale)
    if graph == "outside":
        assert np.all(g[(idx < 0) | (idx >= N)] == 0.0)
    tol = (JAX_BITS + c * 2.0 ** -23) * scale + 1e-30
    for what, want in (("coefficient form",
                        _jax_coef_vjp(feat, ct, idx, coef, mode)),
                       ("dense form",
                        _jax_dense_vjp(feat, ct, idx, coef, mode))):
        assert want.shape == got.shape
        err = np.abs(g - want)
        assert np.all(err <= tol), (what, float((err - tol).max()))


@pytest.mark.parametrize("mode", ["grad", "div"])
def test_coef_cotangent_reads_strided_cotangents(mode):
    """A cotangent with strides (the dense grad's is the ``transpose(1,
    2)`` view of a ``[B, 2, N, C]`` product) gives the bits of its
    contiguous copy."""
    rng = np.random.default_rng(7)
    idx, _ = _graph(rng, "ragged")
    feat, ct = _inputs(rng, mode, 12)
    if mode == "grad":
        view = _t(ct).transpose(1, 2).contiguous().transpose(1, 2)
    else:
        view = _t(np.ascontiguousarray(np.swapaxes(ct, 1, 2))).transpose(1, 2)
    assert not view.is_contiguous()
    want = ops.coef_cotangent(_t(feat), _t(ct), _t(idx))
    assert torch.equal(ops.coef_cotangent(_t(feat), view, _t(idx)), want)


def test_coef_cotangent_refuses_other_shapes():
    """Shapes that fit neither mode raise before any launch, and a meta
    tensor (neither CPU nor CUDA) raises in the kernel wrapper."""
    idx = torch.zeros((B, N, K), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected"):
        ops.coef_cotangent(torch.zeros((B, N, 3, 4)), torch.zeros(
            (B, N, 4)), idx)
    with pytest.raises(ValueError, match="ct"):
        ops.coef_cotangent(torch.zeros((B, N, 4)), torch.zeros((B, N, 4)),
                           idx)
    meta = torch.device("meta")
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.coef_cotangent(torch.zeros((B, N, 4), device=meta),
                           torch.zeros((B, N, 2, 4), device=meta),
                           idx.to(meta))
    assert sum(ops.launch_counts().values()) == 0
    assert KERNEL_OPS.coef_cotangent is ops.coef_cotangent
    assert PLAIN_OPS.coef_cotangent is ops.coef_cotangent_plain


def _coef_operators(rng, bundle):
    idx, coef = _graph(rng, "ragged")
    gc = _t(coef).requires_grad_()
    dc = _t(rng.standard_normal(coef.shape).astype(np.float32))
    dc.requires_grad_()
    mask = torch.ones(idx.shape, dtype=torch.bool)
    return GradDiv(nbr_idx=_t(idx), nbr_mask=mask, grad_coef=gc,
                   div_coef=dc, ops=bundle)


@pytest.mark.parametrize("bundle", [KERNEL_OPS, PLAIN_OPS],
                         ids=["kernels", "plain"])
def test_differentiated_dense_build_keeps_no_operator_graph(bundle):
    """A dense build of coefficients that require grad: ``w_grad`` and
    ``w_div`` carry no graph, the coefficients do; the dense applies give
    the coefficients and the features the cotangents of the coefficient
    form (the same sampled product, so the coefficients' bit for bit; the
    features' from ``W^T @ ct`` against the edge-row scatter, within
    1e-5 x max), and ``W``'s plain ``torch.matmul`` forward."""
    rng = np.random.default_rng(11)
    gd = _coef_operators(rng, bundle)
    dense = densify(gd, bundle)
    for w in (dense.w_grad, dense.w_div):
        assert not w.requires_grad and w.grad_fn is None
    assert dense.grad_coef is gd.grad_coef and dense.div_coef is gd.div_coef
    c = 5
    x = _t(rng.standard_normal((B, N, c)).astype(np.float32))
    v = _t(rng.standard_normal((B, N, 2, c)).astype(np.float32))
    ctg = _t(rng.standard_normal((B, N, 2, c)).astype(np.float32))
    ctd = _t(rng.standard_normal((B, N, c)).astype(np.float32))
    grads = []
    for op in (dense, gd):
        xg, vg = x.clone().requires_grad_(), v.clone().requires_grad_()
        yg, yd = op.grad(xg), op.div(vg)
        torch.autograd.backward((yg, yd), (ctg, ctd))
        grads.append((yg.detach(), yd.detach(), xg.grad, vg.grad,
                      gd.grad_coef.grad.clone(), gd.div_coef.grad.clone()))
        gd.grad_coef.grad = gd.div_coef.grad = None
    for i, (a, b) in enumerate(zip(*grads)):
        if i >= 4:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=1e-5 * float(b.abs().max()))
    with torch.no_grad():
        assert torch.equal(dense.grad(x), torch.matmul(
            dense.w_grad, x[:, None]).transpose(1, 2))


def test_dense_applies_unchanged_without_differentiated_coefficients():
    """Without coefficients that require grad the dense build keeps none
    and its applies are the plain products, as before; a bf16 build of
    differentiated coefficients, as an f32 one, keeps no graph on ``W``
    and keeps the coefficients, cast to bf16 (its applies give them
    their cotangent, rounded to bf16 as JAX's)."""
    rng = np.random.default_rng(12)
    gd = _coef_operators(rng, PLAIN_OPS)
    with torch.no_grad():
        dense = densify(gd, PLAIN_OPS)
    assert dense.grad_coef is None and dense.div_coef is None
    bf16 = densify(gd, PLAIN_OPS, torch.bfloat16)
    assert not bf16.w_grad.requires_grad and not bf16.w_div.requires_grad
    assert bf16.grad_coef.dtype == bf16.div_coef.dtype == torch.bfloat16
    assert bf16.grad_coef.requires_grad and bf16.div_coef.requires_grad
