"""Point-sharded serving of one large cloud in deltaconv_tpu_torch against
the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its Pallas kernels in interpret mode with the small tiles
of its own tests (``tile_q=32``, ``tile_c=128``); its sharded forwards
run on a sub-mesh of the virtual CPU devices, ``Mesh(jax.devices()[:D])``.
The port runs the same cloud in ``D`` processes: 2 ``gloo`` ranks spawned
from the test (a ``FileStore`` in ``tmp_path``, a 60 s
``init_process_group`` timeout, a bounded join), or in-process at D=1.
This module imports JAX inside its test functions, so the spawned ranks,
which import it again, load only torch.

Tolerances, and why:

- kNN: ``knn_topk_table`` (exact and quantized) and the quantized
  ``knn_topk_bucketed``: ids equal, order included (the scores round as
  XLA rounds the JAX function's, see ``ops/knn_topk.py``); the exact
  ``knn_topk_bucketed``: winner sets equal per row (its certified and
  repaired rows may order ties differently, as JAX's own tests allow).
- The table-form build: coefficients within 1e-5 x max (the port's WLS
  kernel against JAX's plain ``weighted_least_squares``, the tolerance
  ``wls`` is held to); the laplacian within 1e-4 x max.
- f32 forwards within 1e-4 x max|logit| (tests/test_torch_coef.py); bf16
  forwards within 0.05 x max|logit|, the JAX package's bf16 serving bound
  (tests/test_torch_bf16.py). JAX's bf16 sharded forward on the CPU takes
  its unfused routes (the port takes the TPU's, a matmul max for a
  lane-narrower PointMaxMLP), as JAX does for a ``ShardedGradDiv``.
"""

import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deltaconv_tpu_torch import (DeltaNetClassification, DeltaNetSegmentation,
                                 InferenceEngine, state_dict_from_flax)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.ops import knn_bucketed as kb
from deltaconv_tpu_torch.parallel import (pad_cloud, point_sharded_laplacian,
                                          point_sharded_operators, shard_rows)
from deltaconv_tpu_torch.parallel import point_sharding as ps

torch.set_num_threads(1)

TILES = dict(tile_q=32, tile_c=128)  # the JAX tests' interpret-mode tiles
F32_REL = 1e-4
BF16_REL = 5e-2
BUILD_REL = 1e-5
RANKS_REL = 1e-2  # bf16, 2 ranks against 1: cross-rank sums in another order
SPAWN_TIMEOUT = 240  # s: both ranks must finish within it
NARROW = dict(conv_channels=(8, 16, 16, 136), embedding_size=32,
              num_neighbors=8, dense_operators=False)
SEG = dict(conv_channels=(8, 16, 136), embedding_size=32, num_neighbors=8,
           categorical_vector=True, dense_operators=False)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax():
    """The JAX modules, imported here only (the spawned ranks never
    import them)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import deltaconv_tpu.parallel.point_sharding as jps
    return jax, jnp, Mesh, jps


def _knn_jax():
    from deltaconv_tpu.ops.knn_bucketed import knn_topk_bucketed
    from deltaconv_tpu.ops.knn_topk import knn_topk_table
    return knn_topk_table, knn_topk_bucketed


def _ellipsoid(rng, n, shift=0.0):
    """Points on a random ellipsoid with their analytic normals."""
    axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = d / axes
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (d * axes + np.float32(shift)).astype(np.float32), nrm


def _same_sets(got, want):
    assert got.shape == want.shape
    assert (got[:, 0] == want[:, 0]).all()
    for i in range(got.shape[0]):
        assert set(got[i].tolist()) == set(want[i].tolist()), i


# -- knn_topk_table (#24) --------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "masked"])
@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "q"])
def test_table_plain_matches_jax(quantized, masked):
    """Ids equal to the JAX kernel in interpret mode, rows 150.. of a
    700-point table, 30% of it masked."""
    jt, _ = _knn_jax()
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    n_t, n_q, k, off = 700, 300, 11, 150
    pos_t = rng.standard_normal((n_t, 3)).astype(np.float32)
    pm = rng.random(n_t) > 0.3
    pm[off:off + n_q] = True
    pm = pm if masked else None
    want = np.asarray(jt(jnp.asarray(pos_t[off:off + n_q]),
                         jnp.asarray(pos_t), k, row_offset=off,
                         point_mask=None if pm is None else jnp.asarray(pm),
                         interpret=True, quantized=quantized, **TILES))
    got = ops.knn_topk_table(_t(pos_t[off:off + n_q]), _t(pos_t), k,
                             row_offset=off,
                             point_mask=None if pm is None else _t(pm),
                             tile_c=TILES["tile_c"], quantized=quantized)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] == off + np.arange(n_q)).all()


@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "q"])
def test_table_row_ids_and_starved_rows(quantized):
    """``row_ids`` (the repair pass's scattered rows) and rows with fewer
    valid columns than K (masked columns fill, lowest first): ids equal
    to JAX's."""
    jt, _ = _knn_jax()
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    n_t, k, off = 700, 11, 150
    pos_t = rng.standard_normal((n_t, 3)).astype(np.float32)
    ids = rng.choice(n_t, 50, replace=False).astype(np.int32)
    want = np.asarray(jt(jnp.asarray(pos_t[ids]), jnp.asarray(pos_t), k,
                         row_ids=jnp.asarray(ids), interpret=True,
                         quantized=quantized, **TILES))
    got = ops.knn_topk_table(_t(pos_t[ids]), _t(pos_t), k, row_ids=_t(ids),
                             tile_c=TILES["tile_c"], quantized=quantized)
    np.testing.assert_array_equal(got.numpy(), want)
    pm = np.zeros(n_t, bool)
    pm[:5] = True
    pm[off:off + 8] = True
    q = pos_t[off:off + 8]
    want = np.asarray(jt(jnp.asarray(q), jnp.asarray(pos_t), k,
                         row_offset=off, point_mask=jnp.asarray(pm),
                         interpret=True, quantized=quantized, **TILES))
    got = ops.knn_topk_table(_t(q), _t(pos_t), k, row_offset=off,
                             point_mask=_t(pm), tile_c=TILES["tile_c"],
                             quantized=quantized).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(len(set(row)) == k for row in got.tolist())  # distinct


@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "q"])
def test_table_grid_ties_match_jax(quantized):
    """A coarse 9^3 grid with many duplicates (equal scores), 30% of it
    masked, rows 150.. of a 700-point table: ids equal to the JAX
    kernel's in interpret mode, order included. The quantized body orders
    equal scores of different tiles by their dequantized values, so these
    must round as XLA rounds the JAX kernel's."""
    jt, _ = _knn_jax()
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    n_t, n_q, k, off = 700, 300, 11, 150
    pos_t = (rng.integers(-4, 5, (n_t, 3)) * 0.25).astype(np.float32)
    pm = rng.random(n_t) > 0.3
    want = np.asarray(jt(jnp.asarray(pos_t[off:off + n_q]),
                         jnp.asarray(pos_t), k, row_offset=off,
                         point_mask=jnp.asarray(pm), interpret=True,
                         quantized=quantized, **TILES))
    got = ops.knn_topk_table(_t(pos_t[off:off + n_q]), _t(pos_t), k,
                             row_offset=off, point_mask=_t(pm),
                             tile_c=TILES["tile_c"], quantized=quantized)
    np.testing.assert_array_equal(got.numpy(), want)


# -- knn_topk_bucketed (#25) -------------------------------------------------


@pytest.mark.parametrize("budget,branch", [
    (dict(m_tiles=6), "repair"),
    (dict(m_tiles=1, repair_rows=400), "repair"),
    (dict(m_tiles=1, repair_rows=4), "full"),
    (dict(m_tiles=1, repair_rows=0), "full"),
], ids=["generous", "repair", "fallback", "no-budget"])
def test_bucketed_exact_matches_jax(budget, branch):
    """Exact mode: winner sets equal to the JAX function's, through each
    branch (the starved budgets fail the certificate: repair, or the full
    table kNN)."""
    _, jb = _knn_jax()
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    n_t, n_q, k, off = 1100, 400, 9, 300
    pos_t = rng.standard_normal((n_t, 3)).astype(np.float32)
    q = pos_t[off:off + n_q]
    want = np.asarray(jb(jnp.asarray(q), jnp.asarray(pos_t), k,
                         row_offset=off, interpret=True, **TILES, **budget))
    got = ops.knn_topk_bucketed(_t(q), _t(pos_t), k, row_offset=off,
                                **TILES, **budget).numpy()
    _same_sets(got, want)
    assert kb.last_branch["branch"] == branch


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "masked"])
def test_bucketed_quantized_matches_jax(masked):
    """Quantized mode on a surface cloud near the origin (the bench's
    kind), 20% masked: ids equal to the JAX function's, order included
    (keys pack the candidate lane, so the Morton sort, the candidate
    buckets and every score must agree bit for bit)."""
    _, jb = _knn_jax()
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    n_t, n_q, k, off = 2048, 512, 11, 600
    pos_t, _ = _ellipsoid(rng, n_t)
    pm = rng.random(n_t) > 0.2
    pm[off:off + n_q] = True
    pm = pm if masked else None
    q = pos_t[off:off + n_q]
    kw = dict(TILES, m_tiles=6, quantized=True)
    want = np.asarray(jb(jnp.asarray(q), jnp.asarray(pos_t), k,
                         row_offset=off,
                         point_mask=None if pm is None else jnp.asarray(pm),
                         interpret=True, **kw))
    got = ops.knn_topk_bucketed(_t(q), _t(pos_t), k, row_offset=off,
                                point_mask=None if pm is None else _t(pm),
                                **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_bucketed_certificate_far_from_the_origin():
    """A cloud 100 units from the origin: the score's f32 cancellation
    error grows with |q|^2, so the certificate's margin scales with it.
    The exact bucketed kNN keeps the exact table kNN's winner sets (most
    rows fail the certificate here and are solved again)."""
    rng = np.random.default_rng(4)
    n_t, k = 1024, 9
    pos_t, _ = _ellipsoid(rng, n_t, shift=100.0)
    got = ops.knn_topk_bucketed(_t(pos_t), _t(pos_t), k, m_tiles=4,
                                repair_rows=256, **TILES).numpy()
    want = ops.knn_topk_table(_t(pos_t), _t(pos_t), k).numpy()
    _same_sets(got, want)
    assert kb.last_branch["n_bad"] > 0
    # Near the origin the same cloud certifies most rows.
    pos_0 = pos_t - np.float32(100.0)
    got = ops.knn_topk_bucketed(_t(pos_0), _t(pos_0), k, m_tiles=4,
                                repair_rows=256, **TILES).numpy()
    _same_sets(got, ops.knn_topk_table(_t(pos_0), _t(pos_0), k).numpy())
    assert kb.last_branch["n_bad"] < n_t // 4


@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "q"])
def test_bucketed_starved_rows_emit_the_marker(quantized):
    """Rows with fewer valid candidates than K - 1 (only 6 valid table
    points): every filler is the marker id (>= Nt), where the JAX kernels
    emit masked real ids; the valid winners are JAX's. Exact mode with
    every bucket visited returns without the certificate."""
    _, jb = _knn_jax()
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    n_t, k, off = 256, 9, 0
    pos_t = rng.standard_normal((n_t, 3)).astype(np.float32)
    pm = np.zeros(n_t, bool)
    pm[:6] = True
    q = pos_t[:6]
    kw = dict(TILES, m_tiles=4, quantized=quantized)
    want = np.asarray(jb(jnp.asarray(q), jnp.asarray(pos_t), k,
                         row_offset=off, point_mask=jnp.asarray(pm),
                         interpret=True, **kw))
    got = ops.knn_topk_bucketed(_t(q), _t(pos_t), k, row_offset=off,
                                point_mask=_t(pm), **kw).numpy()
    assert (got[:, 6:] >= n_t).all() and (want[:, 6:] < n_t).all()
    assert not pm[want[:, 6:]].any()  # JAX: masked real points
    np.testing.assert_array_equal(got[:, :6], want[:, :6])


def test_gather_rows_table_longer_than_rows():
    """``gather_rows`` of a table longer than its query rows (the
    sharded build's): the rows of the whole table, and the backward
    scatters into every table row."""
    rng = np.random.default_rng(6)
    table = rng.standard_normal((2, 50, 9)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 20, 5)).astype(np.int32)
    want = np.stack([table[b][idx[b]] for b in range(2)]).transpose(
        0, 3, 2, 1)
    t = _t(table).requires_grad_()
    for fn in (ops.gather_rows, ops.gather_rows_plain):
        got = fn(t, _t(idx))
        np.testing.assert_array_equal(got.detach().numpy(), want)
        (g,) = torch.autograd.grad(got.sum(), t)
        counts = np.stack([np.bincount(idx[b].ravel(), minlength=50)
                           for b in range(2)])
        np.testing.assert_array_equal(
            g.numpy(), np.repeat(counts[:, :, None], 9, axis=2))


# -- the sharded path at world size 1 -----------------------------------------


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in dict(tree).items()}


def _perturb(tree, rng, in_bn=False):
    """Running statistics away from their init, BatchNorm scales of both
    signs and biases."""
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
            out[k] = x
    return out


def _model_pair(rng, seg, compute_dtype=None, knn_method="exact"):
    """(JAX model, numpy variables, the port loaded from them), BatchNorm
    statistics and scales randomized."""
    jax, jnp, _, _ = _jax()
    from deltaconv_tpu.models import DeltaNetClassification as JaxCls
    from deltaconv_tpu.models import DeltaNetSegmentation as JaxSeg

    widths = dict(SEG if seg else NARROW, compute_dtype=compute_dtype,
                  knn_method=knn_method)
    pos, nrm = _ellipsoid(rng, 128)
    kw = {"category": jnp.eye(16)[None, 3]} if seg else {}
    model = (JaxSeg(num_classes=6, **widths) if seg
             else JaxCls(num_classes=4, **widths))
    variables = jax.jit(lambda key, p, n_: model.init(key, p, normal=n_,
                                                      **kw))(
        jax.random.PRNGKey(0), pos[None], nrm[None])
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)
    port = (DeltaNetSegmentation(6, **widths) if seg
            else DeltaNetClassification(4, **widths))
    port.load_state_dict(state_dict_from_flax(
        params, stats, head="segmentation" if seg else "classification"),
        strict=True)
    return model, {"params": params, "batch_stats": stats}, port.eval()


def _jax_sharded(model, variables, pos, nrm, devices, category=None):
    _, jnp, Mesh, jps = _jax()
    import jax
    mesh = Mesh(np.asarray(jax.devices()[:devices]), ("points",))
    p, n, m = jps.pad_cloud(jnp.asarray(pos), devices, jnp.asarray(nrm))
    if category is None:
        return np.asarray(jax.jit(
            lambda v, p, n, m: jps.point_sharded_classification(
                mesh, model, v, p, normal=n, point_mask=m))(
            variables, p, n, m))
    return np.asarray(jax.jit(
        lambda v, p, n, m, c: jps.point_sharded_segmentation(
            mesh, model, v, p, normal=n, point_mask=m, category=c))(
        variables, p, n, m, jnp.eye(16)[category]))[:pos.shape[0]]


def _within(got, want, rel, label=""):
    scale = float(np.abs(want).max())
    dev = float(np.abs(np.asarray(got) - want).max())
    print(f"{label}: {dev / scale:.2e} x max (bound {rel})")
    assert dev <= rel * scale, f"{label}: {dev} > {rel} x {scale}"


@pytest.mark.parametrize("route,seg,dtype", [
    ("table", False, None), ("bucketed", False, None),
    ("table", True, "bfloat16"), ("bucketed", True, None)],
    ids=["table-cls-f32", "bucketed-cls-f32", "table-seg-bf16",
         "bucketed-seg-f32"])
def test_sharded_knn_routes_at_one_rank(route, seg, dtype, monkeypatch):
    """World size 1 with the thresholds shrunk (as the JAX tests shrink
    them): the table and the bucketed kNN (exact) in the whole sharded
    forward of either model, against JAX's on a 1-device mesh (its
    bucketed branch on the ``_FORCE_BUCKETED_INTERPRET`` hook): f32
    within 1e-4 x max|logit|, also of the single-device ``predict``;
    bf16 within 0.05."""
    _, _, _, jps = _jax()
    rng = np.random.default_rng(7)
    model, variables, port = _model_pair(rng, seg, dtype)
    pos, nrm = _ellipsoid(rng, 300)
    monkeypatch.setattr(jps, "_KNN_TILE", 96)
    monkeypatch.setattr(ps, "_KNN_TILE", 96)
    if route == "bucketed":
        monkeypatch.setattr(jps, "_FORCE_BUCKETED_INTERPRET", True)
        monkeypatch.setattr(ps, "_KNN_BUCKETED_MIN", 200)
    cat = 5 if seg else None
    want = _jax_sharded(model, variables, pos, nrm, 1, cat)
    engine = InferenceEngine(port, num_points=300, batch_size=1,
                             device="cpu")
    got = engine.predict_sharded(pos, nrm, cat)
    assert got.shape == ((300, 6) if seg else (4,))
    assert got.dtype == np.float32
    label = f"{route}, {'seg' if seg else 'cls'} {dtype or 'float32'}"
    rel = BF16_REL if dtype else F32_REL
    _within(got, want, rel, f"{label}, 1 rank vs JAX")
    if dtype is None:
        ref = engine.predict([pos], [nrm], [cat] if seg else None)[0]
        _within(got, ref, F32_REL, f"{label}, predict_sharded vs predict")


def test_predict_sharded_refuses_int8():
    port = DeltaNetClassification(4, **dict(NARROW, dense_operators=True))
    engine = InferenceEngine(port, num_points=64, precision="int8",
                             device="cpu")
    with pytest.raises(ValueError, match="int8"):
        engine.predict_sharded(np.zeros((64, 3), np.float32))


# -- two gloo ranks -------------------------------------------------------------


def _rank_main(rank, world, store, job, out):
    """A spawned rank: joins the group, runs ``job``'s cases on its rows,
    saves what it got (rank 0)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        job = torch.load(job, weights_only=False)
        group = dist.group.WORLD
        results = {}
        for name, case in job.items():
            results[name] = _run_case(case, group)
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def _run_case(case, group):
    pos = _t(case["pos"])
    nrm = None if case["normal"] is None else _t(case["normal"])
    if case["kind"] == "operators":
        p, n, m = pad_cloud(pos, dist.get_world_size(group), nrm)
        p, n, m = (shard_rows(t, group) for t in (p, n, m))
        gd = point_sharded_operators(p, case["k"], n, m, group)
        rows = [ps.all_gather(t[0], group).numpy() for t in
                (gd.nbr_idx, gd.nbr_mask, gd.grad_coef, gd.div_coef)]
        even = slice(0, pos.shape[0] // 2 * 2)  # unpadded
        lap = point_sharded_laplacian(
            shard_rows(pos[even], group), shard_rows(_t(case["x"]), group),
            case["k"], shard_rows(nrm[even], group), group)
        return rows + [ps.all_gather(lap, group).numpy()]
    model = (DeltaNetSegmentation(6, **case["widths"]) if case["seg"]
             else DeltaNetClassification(4, **case["widths"]))
    model.load_state_dict(case["state"], strict=True)
    engine = InferenceEngine(model, num_points=pos.shape[0], batch_size=1,
                             device="cpu")
    return engine.predict_sharded(case["pos"], case["normal"],
                                  case.get("category"), group)


def _spawn(tmp_path, job, world=2):
    """Runs ``job`` on ``world`` gloo ranks; returns rank 0's results."""
    job_path, out = tmp_path / "job.pt", tmp_path / "out.pt"
    torch.save(job, job_path)
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp_path / "store"), str(job_path),
                          str(out)),
        nprocs=world, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + SPAWN_TIMEOUT
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    return torch.load(out, weights_only=False)


def test_two_ranks_build_and_laplacian(tmp_path):
    """The table-form build on 2 ranks (a cloud of 301 points, padded to
    302 with a point mask) against JAX's ``point_sharded_operators`` on a
    2-device mesh: the global neighbour ids and masks equal, the
    coefficients within 1e-5 x max; ``point_sharded_laplacian`` of its
    first 300 points (no padding) within 1e-4 x max."""
    jax, jnp, Mesh, jps = _jax()
    rng = np.random.default_rng(8)
    n, k = 301, 10
    pos, nrm = _ellipsoid(rng, n)
    x = rng.standard_normal((n - 1, 4)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("points",))
    p, nn, m = jps.pad_cloud(jnp.asarray(pos), 2, jnp.asarray(nrm))
    jgd = jax.jit(lambda p, nn, m: jps.point_sharded_operators(
        mesh, p, k, normal=nn, point_mask=m))(p, nn, m)
    jlap = np.asarray(jax.jit(lambda p, x, nn: jps.point_sharded_laplacian(
        mesh, p, x, k, normal=nn))(pos[:n - 1], x, nrm[:n - 1]))
    got = _spawn(tmp_path, {"ops": dict(kind="operators", pos=pos,
                                        normal=nrm, k=k, x=x)})["ops"]
    idx, mask, grad, div, lap = got
    np.testing.assert_array_equal(idx, np.asarray(jgd.nbr_idx))
    np.testing.assert_array_equal(mask, np.asarray(jgd.nbr_mask))
    _within(grad, np.asarray(jgd.grad_coef), BUILD_REL, "grad_coef")
    _within(div, np.asarray(jgd.div_coef), BUILD_REL, "div_coef")
    _within(lap, jlap, F32_REL, "laplacian")


def test_two_ranks_forwards(tmp_path, monkeypatch):
    """``predict_sharded`` of both models, f32 and bf16, on 2 ranks
    against JAX's sharded forwards on a 2-device mesh (a cloud of 255
    points, padded to 256): f32 within 1e-4, bf16 within 0.05 x
    max|logit|. Then a fault of the JAX package that the port does not
    copy: JAX's DeepMaxMLP, routed as on the TPU, gathers the LOCAL rows
    with GLOBAL neighbour ids on a ``ShardedGradDiv`` (4.5e-2 x
    max|logit| off at 2 devices); the port's bf16 segmentation on 2 ranks
    stays within 1e-2 x max|logit| of its own single-rank forward (the
    two differ only in the order of the cross-rank sums)."""
    rng = np.random.default_rng(9)
    n = 255
    pos, nrm = _ellipsoid(rng, n)
    job, want = {}, {}
    for seg in (False, True):
        for dt in (None, "bfloat16"):
            name = f"{'seg' if seg else 'cls'}-{dt or 'float32'}"
            model, variables, port = _model_pair(rng, seg, dt)
            cat = 3 if seg else None
            want[name] = _jax_sharded(model, variables, pos, nrm, 2, cat)
            job[name] = dict(kind="model", seg=seg, pos=pos, normal=nrm,
                             state=port.state_dict(),
                             widths=dict(SEG if seg else NARROW,
                                         compute_dtype=dt),
                             category=cat)
            if name == "seg-bfloat16":
                single = InferenceEngine(port, num_points=n, batch_size=1,
                                         device="cpu").predict_sharded(
                    pos, nrm, cat)
    got = _spawn(tmp_path, job)
    for name, logits in got.items():
        assert logits.shape == want[name].shape, name
        _within(logits, want[name], F32_REL if "float32" in name
                else BF16_REL, f"{name}, 2 ranks vs JAX")
    _within(got["seg-bfloat16"], single, RANKS_REL,
            "seg-bfloat16, 2 ranks vs 1")


def test_two_ranks_forward_without_normals(tmp_path):
    """``predict_sharded`` of a cloud without normals (255 points, padded
    to 256, f32): each rank estimates its rows' frames on a 10-NN graph
    against the whole table. 2 ranks within 1e-4 x max|logit| of 1 rank;
    the 1-rank forward within 1e-4 of JAX's sharded forward without
    normals on a 1-device mesh and of the port's own ``predict``."""
    jax, jnp, Mesh, jps = _jax()
    rng = np.random.default_rng(10)
    n = 255
    pos, _ = _ellipsoid(rng, n)
    model, variables, port = _model_pair(rng, False)
    engine = InferenceEngine(port, num_points=n, batch_size=1, device="cpu")
    single = engine.predict_sharded(pos)
    assert single.shape == (4,) and np.isfinite(single).all()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("points",))
    p, _, m = jps.pad_cloud(jnp.asarray(pos), 1)
    want = np.asarray(jax.jit(
        lambda v, p, m: jps.point_sharded_classification(
            mesh, model, v, p, normal=None, point_mask=m))(variables, p, m))
    _within(single, want, F32_REL, "no normals, 1 rank vs JAX")
    _within(single, engine.predict([pos])[0], F32_REL,
            "no normals, predict_sharded vs predict")
    got = _spawn(tmp_path, {"cls": dict(
        kind="model", seg=False, pos=pos, normal=None,
        state=port.state_dict(), widths=NARROW)})["cls"]
    _within(got, single, F32_REL, "no normals, 2 ranks vs 1")
