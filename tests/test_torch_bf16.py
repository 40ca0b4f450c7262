"""The bf16 serving slice of deltaconv_tpu_torch against the JAX package
on the CPU.

Each bf16 module (EdgeMaxMLP, PointMaxMLP in both of its eval branches,
DeltaConv) runs in both packages on the same bf16 dense operators (the
port's, handed to the JAX layer) with the same perturbed weights
(BatchNorm scales of both signs), held to ``rtol = atol = 5e-2``, the
JAX package's own bound for its bf16 eval fast paths
(tests/nn/test_deltaconv.py). The JAX side runs its Pallas kernels in
interpret mode through the package's test hook
(``_FORCE_FUSED_INTERPRET``), which routes its eval branches as on the
TPU, except that its PointMaxMLP takes the per-point branch on the CPU
even where the input is lane-narrower; the port takes the TPU's matmul
branch there, which differs only in the order of the f32 sums.

Then the slice: a narrow bf16 DeltaNetClassification (channels (8, 16,
16, 136): the last conv is lane-narrower, so both PointMaxMLP branches
run), exact kNN, served uniform and ragged through the port's
``InferenceEngine(precision="bfloat16", device="cpu")`` and the JAX
``InferenceEngine(precision="bfloat16")``: the largest deviation must be
below 0.05 x max|logit| and the argmax equal wherever the f32 margin
exceeds twice that deviation (tests/models/test_serving.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.nn.deltaconv as jax_dc
from deltaconv_tpu.geometry.dense import DenseGradDiv as JaxDenseGradDiv
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.serving import InferenceEngine as JaxEngine
from deltaconv_tpu_torch import (DeltaNetClassification, InferenceEngine,
                                 state_dict_from_flax)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.geometry import knn
from deltaconv_tpu_torch.models import build_operators
from deltaconv_tpu_torch.nn import DeltaConv, EdgeMaxMLP, PointMaxMLP

torch.set_num_threads(1)

B, N, K = 2, 128, 8
BF16_TOL = 5e-2
WIDTH = dict(conv_channels=(8, 16, 16, 136), embedding_size=32,
             num_neighbors=K)


def _t(x):
    return torch.from_numpy(np.array(x))


def _clouds(rng, sizes):
    """Points on random ellipsoids with their analytic normals."""
    clouds, normals = [], []
    for n in sizes:
        axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        nrm = d / axes
        clouds.append(d * axes)
        normals.append(nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    return clouds, normals


def _padded(clouds, normals):
    pos = np.zeros((len(clouds), N, 3), np.float32)
    nrm = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32),
                  (len(clouds), N, 1))
    for i, (c, q) in enumerate(zip(clouds, normals)):
        pos[i, :len(c)], nrm[i, :len(c)] = c, q
    mask = np.arange(N)[None, :] < np.asarray([len(c) for c in clouds])[
        :, None]
    return pos, nrm, mask


def _perturb(tree, rng, in_bn=False):
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _perturb(x, rng, in_bn or k == "BatchNorm_0")
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(-1.5, 1.5, x.shape).astype(np.float32)
        elif k == "bias" and in_bn:
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        else:
            out[k] = np.asarray(x)
    return out


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _bf16_input(rng, shape):
    """(jnp bf16, torch bf16) of the same values."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _operators(rng, masked):
    """The port's bf16 dense operators of a batch and the same arrays as
    a JAX DenseGradDiv."""
    sizes = [N, 90] if masked else [N] * B
    pos, nrm, mask = _padded(*_clouds(rng, sizes))
    gd = build_operators(_t(pos), K, _t(nrm), _t(mask) if masked else None,
                         operator_dtype="bfloat16")
    assert gd.w_grad.dtype == torch.bfloat16
    jgd = JaxDenseGradDiv(
        jnp.asarray(gd.nbr_idx.numpy()), jnp.asarray(gd.nbr_mask.numpy()),
        *(jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
          for w in (gd.w_grad, gd.w_div)))
    return gd, jgd


def _close(got, want):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("kind,c_in,c_out", [
    ("edge", 3, 8), ("point", 8, 16), ("point", 16, 136)])
def test_scalar_max_branch_bf16_matches_jax(kind, c_in, c_out, monkeypatch):
    """EdgeMaxMLP (gather_max_affine with the self row) and PointMaxMLP:
    8 -> 16 takes the per-point branch (gather_max_affine), 16 -> 136 the
    lane-narrower one (gather_matmul_max)."""
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    rng = np.random.default_rng(20)
    gd, jgd = _operators(rng, masked=True)
    x_j, x = _bf16_input(rng, (B, N, c_in))
    jax_cls = jax_dc.EdgeMaxMLP if kind == "edge" else jax_dc.PointMaxMLP
    layer = jax_cls(c_out, dtype="bfloat16")
    variables = layer.init(jax.random.PRNGKey(0), x_j, jgd)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)
    want = layer.apply({"params": params, "batch_stats": stats}, x_j, jgd,
                       train=False)

    port = (EdgeMaxMLP if kind == "edge" else PointMaxMLP)(
        c_in, c_out, dtype=torch.bfloat16)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.eval()
    with torch.inference_mode():
        got = port(x, gd)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, c_out)
    _close(got, want)
    assert not got[1, 90:].float().any()  # padded points: no neighbour


@pytest.mark.parametrize("centralized,c_in,c_out,masked", [
    (True, 3, 8, False), (True, 3, 8, True), (False, 8, 16, True),
    (False, 16, 136, False)])
def test_deltaconv_bf16_matches_jax(centralized, c_in, c_out, masked,
                                    monkeypatch):
    """A whole bf16 DeltaConv: both streams, bf16 operator applies with
    f32 accumulation, bf16 MLPs with f32 BatchNorm, the VectorNonLin's
    f32 norm and bf16 rescale."""
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    rng = np.random.default_rng(21)
    gd, jgd = _operators(rng, masked)
    x_j, x = _bf16_input(rng, (B, N, c_in))
    v_j, v = _bf16_input(rng, (B, N, 2, c_in))
    layer = jax_dc.DeltaConv(c_out, centralized=centralized,
                             dtype="bfloat16")
    variables = layer.init(jax.random.PRNGKey(0), x_j, v_j, jgd)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)
    jx, jv = layer.apply({"params": params, "batch_stats": stats}, x_j, v_j,
                         jgd, train=False)

    port = DeltaConv(c_in, c_out, centralized=centralized,
                     dtype=torch.bfloat16)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.eval()
    with torch.inference_mode():
        tx, tv = port(x, v, gd)
    assert tx.dtype == tv.dtype == torch.bfloat16
    _close(tx, jx)
    _close(tv, jv)


@pytest.fixture(scope="module")
def slice_pair():
    """(JAX model, its perturbed numpy variables, the port loaded from
    them)."""
    rng = np.random.default_rng(22)
    model = JaxModel(num_classes=4, **WIDTH)
    pos, nrm, _ = _padded(*_clouds(rng, [N] * B))
    variables = jax.jit(lambda key, p, n_: model.init(key, p, normal=n_))(
        jax.random.PRNGKey(0), pos, nrm)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)
    port = DeltaNetClassification(4, **WIDTH)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return model, {"params": params, "batch_stats": stats}, port


@pytest.mark.parametrize("sizes", [[N] * 3, [N, 100, 77]],
                         ids=["uniform", "ragged"])
def test_bf16_engine_matches_jax_engine(slice_pair, sizes, monkeypatch):
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    model, variables, port = slice_pair
    clouds, normals = _clouds(np.random.default_rng(23), sizes)
    want = JaxEngine(model, variables, num_points=N, batch_size=B,
                     precision="bfloat16").predict(clouds, normals)
    base = JaxEngine(model, variables, num_points=N,
                     batch_size=B).predict(clouds, normals)
    engine = InferenceEngine(port, num_points=N, batch_size=B,
                             precision="bfloat16", device="cpu")
    got = engine.predict(clouds, normals)
    assert got.shape == (len(sizes), 4) and got.dtype == np.float32
    assert engine.model.compute_dtype == torch.bfloat16
    assert port.compute_dtype is None  # the caller's model is unchanged
    dev = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"bf16 port vs JAX bf16 engine: max deviation {dev:.3e}, "
          f"{dev / scale:.3e} x max|logit|")
    assert dev < 0.05 * scale
    # bf16 really ran: the two packages agree more closely than bf16
    # differs from f32.
    assert dev < float(np.abs(want - base).max())
    top2 = np.sort(base, axis=-1)
    decisive = top2[:, -1] - top2[:, -2] > 2 * dev
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


def test_approx_knn_graph():
    """``knn_method="approx"``: the packed-key knn_topk on a uniform
    batch, the exact torch.topk route on a masked one."""
    rng = np.random.default_rng(24)
    pos, nrm, mask = _padded(*_clouds(rng, [N, 90]))
    gd = build_operators(_t(pos), K, _t(nrm), knn_method="approx")
    assert torch.equal(gd.nbr_idx, ops.knn_topk_plain(_t(pos), K, True))
    assert bool(gd.nbr_mask.all())
    gd = build_operators(_t(pos), K, _t(nrm), _t(mask), knn_method="approx")
    idx, nbr_mask = knn(_t(pos), K, _t(mask))
    assert torch.equal(gd.nbr_idx, idx)
    assert torch.equal(gd.nbr_mask, nbr_mask & _t(mask)[:, :, None])
    with pytest.raises(ValueError, match="method"):
        knn(_t(pos), K, method="tiled")
