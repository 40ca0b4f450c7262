"""Segmentation serving of deltaconv_tpu_torch against the JAX package on
the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs its Pallas kernels in interpret mode, its depth-2 modules
through the package's test hook (``_FORCE_FUSED_INTERPRET``), which
routes their eval branches as on the TPU, as the port does on every
device.

- ``gather_mlp_max``'s plain version, and the plain versions of the
  two-phase route its CUDA wrapper takes without centralization
  (``mlp_rows`` then ``gather_max_merge``), against the JAX function:
  the best values bit-equal on >= 99% of the elements and never more
  than 2 bf16 ulps apart (the two sum each product in another order, so
  a rounded product may differ by one ulp and carry through the next
  layer);
  outputs with the epilogue within 1e-2 x max (XLA's CPU compiler also
  contracts the affine into an FMA).
- ``DeepMaxMLP`` and ``DeltaConv(depth=2)``: f32 within 1e-5 (module)
  and 1e-4 (conv) x max; bf16 at ``rtol = atol = 5e-2``, the JAX
  package's own bound for its bf16 eval fast paths.
- A narrow ``DeltaNetSegmentation`` with the categorical head (channels
  (8, 16, 136): the first conv is centralized and the last lane-
  narrower, so both take the fused kernel in bf16, and the middle one
  the per-point MLP and the bf16 max): f32 logits within 1e-4 x
  max|logit|, bf16 within 0.05 x max|logit| with the argmax equal
  wherever the f32 margin exceeds twice the deviation, uniform and
  masked; both ``InferenceEngine``s with int categories on ragged
  clouds; the weight mapping.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.nn.deltaconv as jax_dc
from deltaconv_tpu.geometry.dense import DenseGradDiv as JaxDenseGradDiv
from deltaconv_tpu.models import DeltaNetSegmentation as JaxModel
from deltaconv_tpu.ops.gather_mlp_max import gather_mlp_max as jax_gmm
from deltaconv_tpu.serving import InferenceEngine as JaxEngine
from deltaconv_tpu.utils.torch_export import export_torch_state_dict
from deltaconv_tpu_torch import (DeltaNetSegmentation, InferenceEngine,
                                 state_dict_from_flax)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.models import build_operators
from deltaconv_tpu_torch.nn import DeepMaxMLP, DeltaConv
from deltaconv_tpu_torch.ops.gather_max import NEG

torch.set_num_threads(1)

B, N, K = 2, 128, 8
BF16_TOL = 5e-2
WIDTH = dict(conv_channels=(8, 16, 136), embedding_size=32,
             num_neighbors=K, categorical_vector=True)
NUM_CLASSES = 6


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


def _variables(variables, rng):
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    return (_perturb(dict(tree["params"]), rng),
            _perturb(dict(tree["batch_stats"]), rng))


def _bf16(a):
    """numpy f32 values rounded to bf16, as f32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)


def _bf16_ulps(a, b):
    """Per-element distance in bf16 ulps of two f32 arrays of bf16
    values."""
    def ordered(x):
        u = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(
            np.int64)
        return np.where(u >= 0x8000, -(u & 0x7FFF), u)

    return np.abs(ordered(a) - ordered(b))


def _operators(rng, masked, dtype=None):
    """The port's dense operators of a batch (f32 or bf16) and the same
    arrays as a JAX DenseGradDiv."""
    sizes = [N, 90] if masked else [N] * B
    pos, nrm, mask = _padded(*_clouds(rng, sizes))
    gd = build_operators(_t(pos), K, _t(nrm), _t(mask) if masked else None,
                         operator_dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jgd = JaxDenseGradDiv(
        jnp.asarray(gd.nbr_idx.numpy()), jnp.asarray(gd.nbr_mask.numpy()),
        *(jnp.asarray(w.float().numpy()).astype(jdt)
          for w in (gd.w_grad, gd.w_div)))
    return gd, jgd


def _inputs(rng, shape, dtype):
    """(jnp, torch) of the same values, bf16-rounded for bf16."""
    a = rng.standard_normal(shape).astype(np.float32)
    if dtype is None:
        return jnp.asarray(a), _t(a)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(np.asarray(j, np.float32)).to(torch.bfloat16)


def _close_to_max(got, want, rel):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _close_bf16(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


# -- the kernel's plain version -------------------------------------------


@pytest.mark.parametrize(
    "centralized,widths,z0_kind,epilogue,skip_slot0,two_phase", [
        (True, (12, 24, 32), "const", True, True, False),
        (False, (12, 24, 32), "rows", True, True, False),
        (False, (12, 24, 32), None, False, False, False),
        (True, (16, 24, 40, 32), None, False, True, False),
        (False, (16, 24, 40, 32), "rows", True, True, False),
        (False, (12, 24, 32), "rows", True, True, True),
        (False, (12, 24, 32), None, False, False, True),
        (False, (12, 24, 32), None, False, True, True),
        (False, (16, 24, 40, 32), "rows", True, True, True),
        (False, (12, 32), "rows", False, True, True),
    ], ids=["centralized-const-z0", "rows-z0", "no-z0-every-slot",
            "centralized-3-layers", "rows-z0-3-layers",
            "two-phase-rows-z0", "two-phase-every-slot",
            "two-phase-skip-slot0", "two-phase-3-layers",
            "two-phase-1-layer"])
def test_gather_mlp_max_plain_matches_jax(centralized, widths, z0_kind,
                                          epilogue, skip_slot0, two_phase):
    """``two_phase``: the route the CUDA wrapper takes when the MLP is not
    centralized, the MLP once a point (``mlp_rows``) and then the masked
    max of those rows (``gather_max_merge``), through their plain
    versions."""
    rng = np.random.default_rng(30)
    c_in, c_out = widths[0], widths[-1]
    x = _bf16(rng.standard_normal((B, N, c_in)))
    ws = [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    affines = [(rng.uniform(-1.5, 1.5, c).astype(np.float32),
                rng.normal(0.0, 0.2, c).astype(np.float32))
               for c in widths[1:-1]]
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    idx[:, :, 0] = np.arange(N)
    mask = rng.random((B, N, K)) > 0.25
    mask[:, :, 0] = True
    mask[1, 90:] = False  # a padded tail: no valid slot
    mask[0, 7, 1:] = False  # only the self slot
    z0 = None
    if z0_kind == "const":
        z0 = _bf16(rng.standard_normal(c_out))
    elif z0_kind == "rows":
        z0 = _bf16(rng.standard_normal((B, N, c_out)))
    epi = None
    if epilogue:
        inv = rng.standard_normal(c_out).astype(np.float32)
        epi = (np.where(inv >= 0, 1.0, -1.0).astype(np.float32), inv,
               rng.normal(0.0, 0.2, c_out).astype(np.float32),
               rng.normal(0.0, 0.2, c_out).astype(np.float32))

    want = np.asarray(jax.jit(lambda x_, i_, m_: jax_gmm(
        x_.astype(jnp.bfloat16), [jnp.asarray(w) for w in ws],
        [tuple(jnp.asarray(v) for v in ab) for ab in affines], i_, m_,
        centralized=centralized, skip_slot0=skip_slot0, interpret=True,
        z0=None if z0 is None else jnp.asarray(z0),
        epilogue=None if epi is None else tuple(
            jnp.asarray(v) for v in epi)))(x, idx, mask), np.float32)
    args = (_t(x).to(torch.bfloat16), [_t(w) for w in ws],
            [tuple(_t(v) for v in ab) for ab in affines])
    z0_t = None if z0 is None else _t(z0)
    epi_t = None if epi is None else tuple(_t(v) for v in epi)
    if two_phase:
        got = ops.gather_max_merge(ops.mlp_rows(*args), _t(idx), _t(mask),
                                   1 if skip_slot0 else 0, z0_t, epi_t)
    else:
        got = ops.gather_mlp_max(*args, _t(idx), _t(mask), centralized,
                                 skip_slot0, z0_t, epi_t)
    assert got.shape == (B, N, c_out)
    if epilogue:
        assert got.dtype == torch.bfloat16
        assert not got[1, 90:].float().any()  # no valid slot: 0
        _close_to_max(got.float().numpy(), want, 1e-2)
        return
    assert got.dtype == torch.float32
    ulps = _bf16_ulps(got.numpy(), want)
    print(f"best values: {float((ulps > 0).mean()):.4%} differ, at most "
          f"{int(ulps.max())} bf16 ulps")
    assert float((ulps == 0).mean()) >= 0.99 and int(ulps.max()) <= 2
    assert (got[1, 90:] == NEG).all()


def test_mlp_weights_packed_as_mma_fragments():
    """The CUDA kernels read each weight as packed by ``_pack_b``: lane
    ``(g, t)`` of k-step ``s`` and column pair ``p`` holds the
    ``mma.m16n8k16`` B fragments of the pair's two n-tiles (``W[16s + 2t
    + {0, 1}]`` and ``W[16s + 8 + 2t + {0, 1}]`` at columns ``16p + g``
    and ``16p + 8 + g``); replaying that map recovers the zero-padded
    bf16 weight."""
    from deltaconv_tpu_torch.ops.gather_mlp_max import _pack_b

    rng = np.random.default_rng(31)
    w = torch.from_numpy(rng.standard_normal((20, 40)).astype(np.float32))
    rows, cols = 32, 48
    packed = _pack_b(w, rows, cols,
                     torch.empty(rows * cols, dtype=torch.bfloat16))
    packed = packed.view(rows // 16, cols // 16, 32, 8)
    want = torch.zeros((rows, cols))
    want[:20, :40] = w.to(torch.bfloat16).float()
    got = torch.full((rows, cols), float("nan"))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(2):
            for h in range(2):
                for e in range(2):
                    k = torch.arange(rows // 16)[:, None] * 16 + 8 * h \
                        + 2 * t + e
                    n = torch.arange(cols // 16)[None, :] * 16 + 8 * j + g
                    got[k, n] = packed[:, :, lane, 4 * j + 2 * h + e].float()
    assert torch.equal(got, want)


def test_gather_mlp_max_checks_its_arguments():
    x = torch.zeros((1, 4, 3), dtype=torch.bfloat16)
    idx = torch.zeros((1, 4, 2), dtype=torch.int32)
    mask = torch.ones((1, 4, 2), dtype=torch.bool)
    ws = [torch.zeros((3, 8)), torch.zeros((8, 8))]
    aff = [(torch.ones(8), torch.zeros(8))]
    with pytest.raises(ValueError, match="affines"):
        ops.gather_mlp_max(x, ws, [], idx, mask)
    with pytest.raises(ValueError, match="skip_slot0"):
        ops.gather_mlp_max(x, ws, aff, idx, mask, z0=torch.zeros(8))
    with pytest.raises(ValueError, match="requires z0"):
        ops.gather_mlp_max(x, ws, aff, idx, mask, skip_slot0=True,
                           epilogue=(torch.ones(8),) * 4)


# -- modules --------------------------------------------------------------


def _jax_module(layer, rng, *args):
    variables = layer.init(jax.random.PRNGKey(0), *args)
    return _variables(variables, rng)


@pytest.mark.parametrize("dtype,centralized,c_in,c_out", [
    (None, True, 3, 16), (None, False, 8, 24),
    ("bfloat16", True, 3, 16), ("bfloat16", False, 16, 136),
    ("bfloat16", False, 8, 16)],
    ids=["f32-centralized", "f32-point", "bf16-centralized-fused",
         "bf16-narrower-fused", "bf16-point"])
def test_deep_max_mlp_matches_jax(dtype, centralized, c_in, c_out,
                                  monkeypatch):
    """f32: the reference pipeline (the edge tensor through the MLP, or
    the per-point MLP and the neighbour max). bf16: the fused kernel
    (centralized, or lane-narrower), else the per-point bf16 MLP and the
    bf16 neighbour max."""
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    rng = np.random.default_rng(31)
    gd, jgd = _operators(rng, True, dtype)
    x_j, x = _inputs(rng, (B, N, c_in), dtype)
    layer = jax_dc.DeepMaxMLP((c_out, c_out), centralized=centralized,
                              dtype=dtype)
    params, stats = _jax_module(layer, rng, x_j, jgd)
    want = layer.apply({"params": params, "batch_stats": stats}, x_j, jgd,
                       train=False)
    tdt = torch.bfloat16 if dtype else None
    port = DeepMaxMLP(c_in, (c_out, c_out), centralized, tdt)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.eval()
    with torch.inference_mode():
        got = port(x, gd)
    assert got.shape == (B, N, c_out)
    assert not got[1, 90:].float().any()  # padded points: no neighbour
    if dtype is None:
        _close_to_max(got.numpy(), want, 1e-5)
    else:
        assert got.dtype == torch.bfloat16
        _close_bf16(got, want)


@pytest.mark.parametrize("dtype,centralized,c_in,c_out", [
    (None, True, 3, 8), (None, False, 8, 16),
    ("bfloat16", True, 3, 8), ("bfloat16", False, 16, 136)],
    ids=["f32-centralized", "f32-point", "bf16-centralized",
         "bf16-narrower"])
def test_deltaconv_depth2_matches_jax(dtype, centralized, c_in, c_out,
                                      monkeypatch):
    """A whole DeltaConv at depth 2: both streams, the depth-2 MLPs
    (``s_mlp``, ``v_mlp`` and the max branch)."""
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    rng = np.random.default_rng(33)
    gd, jgd = _operators(rng, True, dtype)
    x_j, x = _inputs(rng, (B, N, c_in), dtype)
    v_j, v = _inputs(rng, (B, N, 2, c_in), dtype)
    layer = jax_dc.DeltaConv(c_out, depth=2, centralized=centralized,
                             dtype=dtype)
    params, stats = _jax_module(layer, rng, x_j, v_j, jgd)
    jx, jv = layer.apply({"params": params, "batch_stats": stats}, x_j, v_j,
                         jgd, train=False)
    tdt = torch.bfloat16 if dtype else None
    port = DeltaConv(c_in, c_out, depth=2, centralized=centralized,
                     dtype=tdt)
    assert isinstance(port.s_mlp_max, DeepMaxMLP)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.eval()
    with torch.inference_mode():
        tx, tv = port(x, v, gd)
    if dtype is None:
        _close_to_max(tx.numpy(), jx, 1e-4)
        _close_to_max(tv.numpy(), jv, 1e-4)
    else:
        _close_bf16(tx, jx)
        _close_bf16(tv, jv)


# -- the model and the engine ---------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its perturbed numpy variables, the port loaded from
    them)."""
    rng = np.random.default_rng(34)
    model = JaxModel(num_classes=NUM_CLASSES, **WIDTH)
    pos, nrm, _ = _padded(*_clouds(rng, [N] * B))
    cat = np.eye(16, dtype=np.float32)[[3, 11]]
    variables = jax.jit(lambda key, p, n_, c: model.init(
        key, p, normal=n_, category=c))(jax.random.PRNGKey(0), pos, nrm, cat)
    params, stats = _variables(variables, rng)
    port = DeltaNetSegmentation(NUM_CLASSES, **WIDTH)
    port.load_state_dict(state_dict_from_flax(params, stats,
                                              head="segmentation"),
                         strict=True)
    port.eval()
    return model, {"params": params, "batch_stats": stats}, port


def _held_bf16(got, want, base):
    """Max deviation below 0.05 x max|logit|, argmax equal per point
    wherever the f32 margin exceeds twice it."""
    dev = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"bf16 port vs JAX bf16: max deviation {dev:.3e}, "
          f"{dev / scale:.3e} x max|logit|")
    assert dev < 0.05 * scale
    # bf16 really ran: the two packages agree more closely than bf16
    # differs from f32.
    assert dev < float(np.abs(want - base).max())
    top2 = np.sort(base, axis=-1)
    decisive = top2[..., -1] - top2[..., -2] > 2 * dev
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


@pytest.mark.parametrize("precision", [None, "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_segmentation_logits_match_jax_apply(pair, masked, precision,
                                             monkeypatch):
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    model, variables, port = pair
    rng = np.random.default_rng(35)
    sizes = [N, 90] if masked else [N] * B
    pos, nrm, mask = _padded(*_clouds(rng, sizes))
    cat = np.eye(16, dtype=np.float32)[[5, 0]]
    pm = mask if masked else None

    def jax_logits(m):
        return np.asarray(jax.jit(
            lambda v, p, n_, c, mk: m.apply(v, p, normal=n_, category=c,
                                            point_mask=mk, train=False))(
            variables, pos, nrm, cat, pm))

    base = jax_logits(model)
    served = port
    if precision:
        served = DeltaNetSegmentation(NUM_CLASSES, **WIDTH)
        served.load_state_dict(port.state_dict())
        served.eval().set_precision(precision, precision)
    with torch.inference_mode():
        got = served(_t(pos), _t(nrm), None if pm is None else _t(pm),
                     category=_t(cat)).numpy()
    assert got.shape == (B, N, NUM_CLASSES) and got.dtype == np.float32
    if precision is None:
        _close_to_max(got, base, 1e-4)
        return
    want = jax_logits(model.clone(compute_dtype=precision,
                                  operator_dtype=precision))
    _held_bf16(got, want, base)


def test_segmentation_requires_a_category(pair):
    _, _, port = pair
    pos, nrm, _ = _padded(*_clouds(np.random.default_rng(36), [N] * B))
    with pytest.raises(ValueError, match="category"):
        port(_t(pos), _t(nrm))


@pytest.mark.parametrize("precision", [None, "bfloat16"])
def test_segmentation_engine_matches_jax_engine(pair, precision,
                                                monkeypatch):
    """Ragged clouds with int categories and a partial last batch: the
    same list of trimmed per-point logits."""
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    model, variables, port = pair
    clouds, normals = _clouds(np.random.default_rng(37), [N, 100, 77])
    cats = [3, 15, 0]
    want = JaxEngine(model, variables, num_points=N, batch_size=B,
                     precision=precision).predict(clouds, normals,
                                                  categories=cats)
    engine = InferenceEngine(port, num_points=N, batch_size=B,
                             precision=precision, device="cpu")
    got = engine.predict(clouds, normals, categories=cats)
    assert [g.shape for g in got] == [(len(c), NUM_CLASSES) for c in clouds]
    if precision is None:
        for g, w in zip(got, want):
            _close_to_max(g, w, 1e-4)
    else:
        base = JaxEngine(model, variables, num_points=N,
                         batch_size=B).predict(clouds, normals,
                                               categories=cats)
        _held_bf16(np.concatenate(got), np.concatenate(want),
                   np.concatenate(base))
    assert engine.predict([], categories=[]) == []
    with pytest.raises(ValueError, match="category id"):
        engine.predict(clouds[:1], normals[:1], categories=[16])
    with pytest.raises(ValueError, match="one a cloud"):
        engine.predict(clouds[:2], normals[:2], categories=[1])


def test_segmentation_state_dict_matches_torch_export(pair):
    _, variables, port = pair
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              head="segmentation")
    ref = export_torch_state_dict(variables["params"],
                                  variables["batch_stats"],
                                  head="segmentation")
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert sorted(sd) == sorted(port.state_dict())
    assert any(k.startswith("lin_categorical.") for k in sd)
    assert "deltanet_base.convs.2.s_mlp_max.1.0.weight" in sd
    DeltaNetSegmentation(NUM_CLASSES, **WIDTH).load_state_dict(sd,
                                                               strict=True)
