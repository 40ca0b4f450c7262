"""The fused eval build of deltaconv_tpu_torch against the JAX package on
the CPU: ``knn_topk``'s mean distances, ``fused_gather_wls``,
``build_dense_operators_fused``, ``DenseGradDiv.scale`` and the
backbone's ``fused_eval_build`` switch.

The JAX side runs its Pallas kernels in interpret mode; the port runs its
plain versions. Inputs are numpy arrays from a seed.

Tolerances, and why (measured on this file's inputs):

- Mean distances: exact body within 1e-5 of JAX's (measured 6.0e-7: XLA
  contracts the score into FMAs); quantized body within 5e-4 (measured
  2.4e-5 against JAX's, 3.2e-4 against the true distances of the same
  ids; JAX holds its own to 2e-3, tests/ops/test_kernels.py:662-674):
  each winner's dequantized score carries up to the row's range / 65534.
- ``fused_gather_wls``: the JAX kernel gathers the table as bf16 ``hi +
  lo`` halves, about 16 mantissa bits, where the port gathers exact f32:
  2e-4 x max (measured 2.5e-5 for the coefficients, 1.1e-5 for the row
  norms). Against the port's own unfused ``edge_planes`` + ``wls_plain``
  with the same ``avg``: 1e-5 x max (0 here, where both run the plain
  math; the kernel is held to it on the card, tests/test_torch_gpu.py).
- The dense operators ``W * scale``: rtol 2e-2, atol 2e-4, as JAX holds
  its own fused build against its pipeline (test_kernels.py:712-716).
- ``DenseGradDiv.scale``: the scaled input and the pre-scaled operator
  are each rounded to bf16 once: two bf16 ulps of the largest output
  (2^-7 x max; measured 5.4e-3); f32 1e-6 (measured 1.0e-7).
- The backbone (bf16): within 0.05 x max, the JAX package's bf16 bound
  (measured 5.3e-3).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu.geometry.frames import \
    build_tangent_basis as jax_tangent_basis
from deltaconv_tpu.models import DeltaNetBase as JaxBase
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu_torch import (PLAIN_OPS, DeltaNetClassification,
                                 state_dict_from_flax)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.geometry import DenseGradDiv, build_tangent_basis
from deltaconv_tpu_torch.models import (DeltaNetBase,
                                        build_dense_operators_fused,
                                        build_operators)
from deltaconv_tpu_torch.ops.wls_fused import edge_planes

jax_knn_topk = importlib.import_module("deltaconv_tpu.ops.knn_topk")
jax_fused = importlib.import_module("deltaconv_tpu.ops.fused_build")

torch.set_num_threads(1)

B, N, K = 2, 128, 12
HILO_REL = 2e-4
SELF_REL = 1e-5
ULP = 2.0 ** -8


def _t(x):
    return torch.from_numpy(np.array(x))


def _within(got, want, rel, what=""):
    got = got.detach().float().numpy() if isinstance(got,
                                                     torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert np.all(np.isfinite(got)), what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _cloud(rng, b=B, n=N):
    """Clouds on ellipsoids with analytic normals."""
    d = rng.standard_normal((b, n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axes = rng.uniform(0.5, 1.5, (b, 1, 3)).astype(np.float32)
    q = d / axes
    return d * axes, q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("quantized,tol", [(False, 1e-5), (True, 5e-4)],
                         ids=["exact", "quantized"])
def test_knn_topk_mean_dist_matches_jax(quantized, tol):
    """``knn_topk(return_mean_dist=True)``, plain, against the JAX kernel in
    interpret mode: the same ids, the mean distances within ``tol``; and
    against the distances of the returned ids (self counted as 0)."""
    rng = np.random.default_rng(0)
    pos = rng.standard_normal((B, 256, 3)).astype(np.float32)
    want_idx, want_md = jax_knn_topk.knn_topk(
        jnp.asarray(pos), 10, interpret=True, quantized=quantized,
        return_mean_dist=True)
    idx, md = ops.knn_topk(_t(pos), 10, quantized, return_mean_dist=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(md.numpy(), np.asarray(want_md), rtol=0,
                               atol=tol)
    g = pos[np.arange(B)[:, None, None], idx.numpy()]
    dist = np.linalg.norm(g - pos[:, :, None], axis=-1).sum(-1) / 10
    np.testing.assert_allclose(md.numpy(), dist, rtol=0, atol=tol)
    assert torch.equal(idx, ops.knn_topk(_t(pos), 10, quantized))


@pytest.mark.parametrize("quantized,tol", [(False, 1e-5), (True, 5e-4)],
                         ids=["exact", "quantized"])
def test_knn_topk_mean_dist_long_rows_match_jax(quantized, tol):
    """The mean distances of rows longer than 1024 points (B=1, N=1100,
    K=30) against the JAX kernel in interpret mode: the same ids, the
    distances within ``tol`` (as at N=256 above)."""
    rng = np.random.default_rng(1)
    pos = rng.standard_normal((1, 1100, 3)).astype(np.float32)
    want_idx, want_md = jax_knn_topk.knn_topk(
        jnp.asarray(pos), 30, interpret=True, quantized=quantized,
        return_mean_dist=True)
    idx, md = ops.knn_topk(_t(pos), 30, quantized, return_mean_dist=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(md.numpy(), np.asarray(want_md), rtol=0,
                               atol=tol)


def _fused_inputs(rng, masked):
    pos, nrm = _cloud(rng)
    p = _t(pos)
    idx, md = ops.knn_topk(p, K, True, return_mean_dist=True)
    mask = torch.ones(idx.shape, dtype=torch.bool)
    if masked:
        mask[:, :, K // 2:] = torch.from_numpy(
            rng.random((B, N, K - K // 2)) > 0.3)
    xb, yb = build_tangent_basis(_t(nrm))
    return p, _t(nrm), xb, yb, idx, mask, md.mean(dim=1)


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "masked"])
def test_fused_gather_wls_matches_jax(masked):
    """#26: ``fused_gather_wls``, plain, against the JAX kernel in
    interpret mode (``grad_coef``, ``div_coef``, ``row_norm``, at the
    tolerance its hi/lo gather forces), and against the port's own
    unfused ``edge_planes`` + ``wls_plain`` with the same ``avg``,
    unnormalized."""
    args = _fused_inputs(np.random.default_rng(1), masked)
    pos, nrm, xb, yb, idx, mask, avg = args
    gc, dc, rn = ops.fused_gather_wls(*args)
    assert gc.shape == dc.shape == (B, 2, N, K) and rn.shape == (B, N)
    want = jax_fused.fused_gather_wls(
        *(jnp.asarray(t.numpy()) for t in args), tile=128, interpret=True)
    for got, w, what in zip((gc, dc, rn), want, ("grad", "div", "row")):
        _within(got, np.asarray(w), HILO_REL, what)
    edges = edge_planes(pos, nrm, xb, yb, idx, mask, torch.ones((B, N)))
    edges[:, 11] = avg[:, None, None]
    g, d = ops.wls_plain(edges, 1.0, 1e-3)
    _within(gc, g.transpose(2, 3).numpy(), SELF_REL, "grad, unfused")
    _within(dc, d.transpose(2, 3).numpy(), SELF_REL, "div, unfused")
    s = g.abs().sum(dim=2)
    _within(rn, torch.sqrt(s[:, 0] ** 2 + s[:, 1] ** 2).numpy(), SELF_REL,
            "row")


def test_build_dense_operators_fused_matches_jax():
    """The port's ``build_dense_operators_fused`` (plain) against JAX's
    composition of the same steps in interpret mode (``knn_topk`` with
    its mean distances, the tangent frames, ``fused_dense_build``, the
    deferred scale): ``W * scale`` within JAX's own bound; and against the
    port's unfused bf16 build (``build_operators``, normalized)."""
    pos, nrm = _cloud(np.random.default_rng(2))
    gd = build_dense_operators_fused(_t(pos), K, _t(nrm), ops=PLAIN_OPS)
    assert isinstance(gd, DenseGradDiv) and gd.w_grad.dtype == torch.bfloat16
    assert gd.scale.shape == (B,) and bool(gd.nbr_mask.all())

    jp, jn = jnp.asarray(pos), jnp.asarray(nrm)
    idx, md = jax_knn_topk.knn_topk(jp, K, interpret=True, quantized=True,
                                    return_mean_dist=True)
    xb, yb = jax_tangent_basis(jn)
    wg, wd, rn = jax_fused.fused_dense_build(
        jp, jn, xb, yb, idx, jnp.ones(idx.shape, bool), jnp.mean(md, axis=1),
        interpret=True)
    inf = jnp.max(rn, axis=1)
    scale = jnp.where(inf > 1e-5, 1.0 / inf, 1.0)[:, None, None, None]
    np.testing.assert_array_equal(gd.nbr_idx.numpy(), np.asarray(idx))
    sw = gd.scale[:, None, None, None]
    for got, want in ((gd.w_grad, wg), (gd.w_div, wd)):
        np.testing.assert_allclose(
            (got.float() * sw).numpy(),
            np.asarray(want.astype(jnp.float32) * scale), rtol=2e-2,
            atol=2e-4)
    ref = build_operators(_t(pos), K, _t(nrm), ops=PLAIN_OPS,
                          operator_dtype="bfloat16", knn_method="approx")
    for got, want in ((gd.w_grad, ref.w_grad), (gd.w_div, ref.w_div)):
        np.testing.assert_allclose((got.float() * sw).numpy(),
                                   want.float().numpy(), rtol=2e-2,
                                   atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_scale_equals_prescaled_operators(dtype):
    """``DenseGradDiv.scale``: ``grad`` and ``div`` with the deferred scale
    equal the same applies on ``W * scale``, within one rounding of the
    scaled input to ``dtype``; the maxes ignore it."""
    rng = np.random.default_rng(3)
    pos, nrm = _cloud(rng)
    gd = build_operators(_t(pos), K, _t(nrm))
    scale = _t(rng.uniform(0.5, 2.0, B).astype(np.float32))
    wg, wd = gd.w_grad.to(dtype), gd.w_div.to(dtype)
    deferred = DenseGradDiv(gd.nbr_idx, gd.nbr_mask, wg, wd, gd.ops,
                            scale=scale)
    s = scale[:, None, None, None]
    prescaled = DenseGradDiv(gd.nbr_idx, gd.nbr_mask,
                             (wg.float() * s).to(dtype),
                             (wd.float() * s).to(dtype), gd.ops)
    x = _t(rng.standard_normal((B, N, 5)).astype(np.float32)).to(dtype)
    v = _t(rng.standard_normal((B, N, 2, 5)).astype(np.float32)).to(dtype)
    rel = 1e-6 if dtype == torch.float32 else 2 * ULP
    _within(deferred.grad(x), prescaled.grad(x).float().numpy(), rel, "grad")
    _within(deferred.div(v), prescaled.div(v).float().numpy(), rel, "div")
    assert torch.equal(deferred.nbr_max(x), prescaled.nbr_max(x))
    plain = DenseGradDiv(gd.nbr_idx, gd.nbr_mask, wg, wd, gd.ops)
    assert torch.equal(DenseGradDiv(gd.nbr_idx, gd.nbr_mask, wg, wd, gd.ops,
                                    scale=None).grad(x), plain.grad(x))


NARROW = dict(conv_channels=(16, 16), num_neighbors=K)


def _backbones(rng):
    model = JaxModel(num_classes=4, embedding_size=32, **NARROW)
    pos, nrm = _cloud(rng)
    variables = jax.jit(lambda key, p, q: model.init(key, p, normal=q))(
        jax.random.PRNGKey(0), pos, nrm)
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    stats = jax.tree_util.tree_map(np.asarray,
                                   dict(variables["batch_stats"]))
    port = DeltaNetClassification(4, embedding_size=32, **NARROW)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    jvars = {"params": params["deltanet_base"],
             "batch_stats": stats["deltanet_base"]}
    return jvars, port.deltanet_base


def test_backbone_on_fused_operators_matches_jax():
    """The port's bf16 backbone eval forward on
    ``operators=build_dense_operators_fused(...)`` against the JAX backbone
    on its normal route (bf16 operators and compute, the same weights):
    every stage within 0.05 x its max. Both take the exact kNN (the fused
    build through ``knn_topk``'s exact body), so the graphs are the same:
    the packed keys' order may differ from exact ``top_k`` at near-ties,
    which moves single points by more than bf16 rounding."""
    rng = np.random.default_rng(4)
    jvars, base = _backbones(rng)
    pos, nrm = _cloud(rng)
    jbase = JaxBase(**NARROW, operator_dtype="bfloat16",
                    compute_dtype="bfloat16")
    want = jbase.apply(jvars, jnp.asarray(pos), normal=jnp.asarray(nrm))
    base.set_precision("bfloat16", "bfloat16")
    base.eval()
    with torch.no_grad():
        gd = build_dense_operators_fused(_t(pos), K, _t(nrm),
                                         knn_method="exact")
        got = base(_t(pos), _t(nrm), operators=gd)
    for i, (g, w) in enumerate(zip(got, want)):
        _within(g, np.asarray(w.astype(jnp.float32)), 0.05, f"stage {i}")


def test_fused_eval_build_changes_nothing_on_the_cpu():
    """JAX's gate takes the fused build on the TPU only; the port's on the
    card only: on the CPU ``fused_eval_build=True`` gives the same outputs
    bit for bit, in bf16 eval where the gate would otherwise hold."""
    rng = np.random.default_rng(5)
    pos, nrm = _cloud(rng)
    outs = []
    for fused in (False, True):
        base = DeltaNetBase((16, 16), num_neighbors=K,
                            operator_dtype="bfloat16",
                            compute_dtype="bfloat16", knn_method="approx",
                            fused_eval_build=fused)
        base.load_state_dict(outs[0][0] if outs else base.state_dict())
        base.eval()
        assert base.fused_eval_build is fused
        assert not base._fused_route(_t(pos), _t(nrm), None)
        with torch.no_grad():
            outs.append((base.state_dict(), base(_t(pos), _t(nrm))))
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,slices,launched,extra", [
    (20, None, "fused_gather_wls", (4,)),         # by shape: 4 warps of 5
    (30, None, "fused_gather_wls", (6,)),         # 6 warps of 5
    (40, None, "fused_gather_wls", (8,)),         # the most edges split
    (48, None, "fused_gather_wls_direct", ()),    # above: the direct route
    (20, 0, "fused_gather_wls_direct", ()),       # forced direct route
    (20, 7, "fused_gather_wls", (7,)),            # a given warp count
])
def test_fused_wrapper_launches_the_route(monkeypatch, k, slices, launched,
                                          extra):
    """The fused build's one launch on CUDA tensors (recorded in place of
    the launch; meta tensors, no card): the split route with
    ``wls_split``'s warps a block before the two floats, or the direct
    route without them."""
    fb = importlib.import_module("deltaconv_tpu_torch.ops.fused_build")
    calls = []
    monkeypatch.setattr(fb._lib, "launch",
                        lambda kernel, device, *args: calls.append(
                            (kernel, args)))
    monkeypatch.setattr(fb._lib, "check_inputs",
                        lambda name, specs: torch.device("meta"))
    rows = [torch.empty((B, N, 3), device="meta") for _ in range(4)]
    idx = torch.empty((B, N, k), dtype=torch.int32, device="meta")
    mask = torch.empty((B, N, k), dtype=torch.bool, device="meta")
    avg = torch.empty((B,), device="meta")
    gc, dc, rn = fb._fused_gather_wls(*rows, idx, mask, avg, 1.0, 1e-3,
                                      slices)
    assert gc.shape == dc.shape == (B, 2, N, k) and rn.shape == (B, N)
    assert [(name, args[10:]) for name, args in calls] == [
        (launched, (B, N, k) + extra + (1.0, 1e-3))]
