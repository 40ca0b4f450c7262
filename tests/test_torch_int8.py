"""The int8 serving slice of deltaconv_tpu_torch against the JAX package
on the CPU.

int8 serving is the JAX package's third serving precision: bf16 compute
on int8 operators quantized per cloud, with the neighbour maxes in the
quantized domain. The three kernels' plain versions are held against the
JAX functions (their Pallas kernels in interpret mode): the dense int8
assembly and the quantization bit-equal, the int8 max bit-equal, the
int8 gather-then-matmul max within one bf16 ulp (f32 sums in another
order) and bit-equal where the sums are exact in any order.

The int8 applies and modules run in both packages on the same int8
operators and scales (the port's, handed to the JAX side) and the same
perturbed weights (BatchNorm scales of both signs). The applies are
bit-equal in f32; the modules are held at the JAX package's module bound
``rtol = atol = 5e-2``: a one-ulp bf16 difference before a quantization
(XLA's CPU FMA against the port's separate roundings) can move a value by
one quantization step, 1/127 of its cloud's range.

Then the slice, through the port's ``InferenceEngine(precision="int8",
device="cpu")`` and the JAX ``InferenceEngine(precision="int8")``,
uniform and ragged: classification where no conv is lane-narrower (both
packages take the same route) within 0.01 x max|logit| of JAX; at (8, 16,
16, 136), whose last conv the port serves through the int8 matmul max and
the JAX package on the CPU through the per-point branch, within the JAX
package's own bound, 0.05 x max|logit| of the f32 engine
(tests/models/test_serving.py), argmax equal wherever the f32 margin
exceeds twice the deviation; segmentation (8, 16, 136) with int
categories on the ``_FORCE_FUSED_INTERPRET`` hook; and f32 compute on int8
operators as tests/models/test_models.py holds it (0.01 x max|logit| of
f32, argmax equal).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.nn.deltaconv as jax_dc
from deltaconv_tpu.geometry.dense import DenseGradDiv as JaxDenseGradDiv
from deltaconv_tpu.geometry.dense import densify as jax_densify
from deltaconv_tpu.geometry.grad_div import GradDiv as JaxGradDiv
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.models import DeltaNetSegmentation as JaxSegModel
from deltaconv_tpu.nn.nonlin import leaky_relu02
from deltaconv_tpu.serving import InferenceEngine as JaxEngine
from deltaconv_tpu_torch import (DeltaNetClassification, DeltaNetSegmentation,
                                 InferenceEngine, state_dict_from_flax)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.models import build_operators
from deltaconv_tpu_torch.nn import (DeepMaxMLP, DeltaConv, EdgeMaxMLP,
                                    PointMaxMLP)

# The modules (the package's ``ops`` exports functions of these names).
jax_densify_op = importlib.import_module("deltaconv_tpu.ops.densify_op")
jax_gm = importlib.import_module("deltaconv_tpu.ops.gather_max")

torch.set_num_threads(1)

B, N, K = 2, 128, 8
MODULE_TOL = 5e-2
NUM_CLASSES = 5


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


def _bf16_ulps(a, b):
    """Per-element distance in bf16 ulps of two arrays of bf16 values."""
    def ordered(x):
        u = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(
            np.int64)
        return np.where(u >= 0x8000, -(u & 0x7FFF), u)

    return np.abs(ordered(a) - ordered(b))


def _inputs(rng, shape, dtype, a=None):
    """(jnp, torch) of the same values (``a``, or normal draws),
    bf16-rounded for bf16."""
    if a is None:
        a = rng.standard_normal(shape).astype(np.float32)
    if dtype is None:
        return jnp.asarray(a), _t(a)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(np.asarray(j, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _knn_like(rng, masked):
    """Neighbour lists as the kNN makes them (self in slot 0, distinct
    columns) and coefficients; ``masked`` clamps the last 3 slots of
    every row to self with zero coefficients. Cloud 0's grad scale is 128,
    so +-64 quantizes through the ties +-63.5."""
    idx = np.stack([np.stack([np.concatenate(
        [[i], rng.permutation(np.delete(np.arange(N), i))[:K - 1]])
        for i in range(N)]) for _ in range(B)]).astype(np.int32)
    gc = rng.standard_normal((B, N, K, 2)).astype(np.float32)
    dc = rng.standard_normal((B, N, K, 2)).astype(np.float32)
    gc[0] = np.clip(gc[0], -100.0, 100.0)
    gc[0, 0, 0, 0] = 128.0
    gc[0, 1, 1:3, 0] = (64.0, -64.0)
    if masked:
        idx[:, :, -3:] = np.arange(N)[None, :, None]
        gc[:, :, -3:] = 0.0
        dc[:, :, -3:] = 0.0
    return idx, gc, dc


@pytest.mark.parametrize("masked", [False, True])
def test_densify_int8_plain_matches_jax(masked):
    """Planes bit-equal and scales equal to the JAX kernel in interpret
    mode and to its CPU fallback (``densify(gd, jnp.int8)``)."""
    idx, gc, dc = _knn_like(np.random.default_rng(50), masked)
    got = ops.densify_coefs_int8_plain(_t(idx), _t(gc), _t(dc))
    want = jax_densify_op.densify_coefs_int8(
        jnp.asarray(idx), jnp.asarray(gc), jnp.asarray(dc), interpret=True)
    ref = jax_densify(JaxGradDiv(jnp.asarray(idx), jnp.ones(idx.shape, bool),
                                 jnp.asarray(gc), jnp.asarray(dc)), jnp.int8)
    assert got[0].dtype == got[1].dtype == torch.int8
    for g, w, r in zip(got, want, (ref.w_grad, ref.w_div, ref.op_scale_grad,
                                   ref.op_scale_div)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[0][0, 0, 1, idx[0, 1, 1]]) == 64  # 63.5, half to even
    assert int(got[0][0, 0, 1, idx[0, 1, 2]]) == -64
    assert ops.densify_coefs_int8 is not ops.densify_coefs_int8_plain
    for g, w in zip(ops.densify_coefs_int8(_t(idx), _t(gc), _t(dc)), got):
        assert torch.equal(g, w)  # the CPU wrapper runs the plain version


@pytest.mark.parametrize("zero", ["grad", "div"])
def test_densify_int8_plain_zero_cloud_matches_jax(zero):
    """A cloud whose grad (or div) coefficients are all zero takes the
    1e-30 floor of the scale (its planes 0, its scale 1e-30 / 127), beside
    a cloud with half-way quotients and clamped padded slots: planes
    bit-equal and scales equal to the JAX kernel in interpret mode."""
    idx, gc, dc = _knn_like(np.random.default_rng(53), True)
    (gc if zero == "grad" else dc)[1] = 0.0
    got = ops.densify_coefs_int8_plain(_t(idx), _t(gc), _t(dc))
    want = jax_densify_op.densify_coefs_int8(
        jnp.asarray(idx), jnp.asarray(gc), jnp.asarray(dc), interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    plane, scale = (got[0], got[2]) if zero == "grad" else (got[1], got[3])
    assert not plane[1].any()
    assert float(scale[1]) == float(np.float32(1e-30) / np.float32(127.0))
    assert int(got[0][0, 0, 1, idx[0, 1, 1]]) == 64  # 63.5, half to even


# Torch functions that reduce or compute: the int8 wrappers' kernels do
# that work, so the wrappers call none of them on CUDA tensors.
_COMPUTE = {"amax", "amin", "max", "min", "sum", "any", "all", "abs",
            "linalg_vector_norm", "norm", "clamp", "clamp_min", "div",
            "__truediv__", "__rtruediv__", "mul", "__mul__", "round",
            "where"}


class _Calls(torch.overrides.TorchFunctionMode):
    """Records the name of every torch function called under it."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.add(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n,k,rows,width", [
    (1024, 20, 8, 1024),   # classification: 8 rows a block
    (2048, 30, 4, 2048),   # segmentation
    (77, 30, 34, 77),      # many short rows: the slots bound them
    (8192, 20, 1, 8192),   # one row a block
    (8200, 20, 1, 8192),   # above: chunks of 8192 columns
])
def test_densify_int8_wrapper_launches(monkeypatch, n, k, rows, width):
    """``densify_coefs_int8``'s launches on CUDA tensors (recorded in
    place of the launch; meta tensors, no card): ``absmax`` on the grad
    and on the div coefficients viewed ``[B, N K, 2]``, into the two rows
    of one ``[2, B]`` buffer, then ``densify_int8`` on the task of
    ``densify_int8_block``; no torch op that reduces or computes."""
    dens = importlib.import_module("deltaconv_tpu_torch.ops.densify_op")
    calls = []
    monkeypatch.setattr(dens._lib, "launch", lambda kernel, device, *args:
                        calls.append((kernel, args)))
    b = 3
    idx = torch.empty((b, n, k), dtype=torch.int32, device="meta")
    gc = torch.empty((b, n, k, 2), dtype=torch.float32, device="meta")
    dc = torch.empty_like(gc)
    assert dens.densify_int8_block(n, k) == (rows, width)
    with _Calls() as seen:
        out = dens._densify_int8_launch(torch.device("cuda", 0), idx, gc, dc)
    assert not seen.names & _COMPUTE, seen.names & _COMPUTE
    assert [name for name, _ in calls] == ["absmax", "absmax",
                                           "densify_int8"]
    (_, g_args), (_, d_args), (_, args) = calls
    assert g_args[2:] == d_args[2:] == (b, n * k, 2, 0)
    assert d_args[1] - g_args[1] == 4 * b  # the div row of [2, B]
    assert args[3] == g_args[1] and args[8:] == (b, n, k, rows, width)
    assert [tuple(t.shape) for t in out] == [(b, 2, n, n), (b, 2, n, n),
                                             (b,), (b,)]
    assert out[0].dtype == out[1].dtype == torch.int8


def test_densify_int8_smem_counts_the_cuda_block():
    """``densify_int8_smem`` is the CUDA source's
    ``densify_int8_smem_bytes`` (four plane images of R W bytes with room
    for their alignment shift, R K slots of 8 bytes) and its limit is
    SMEM_MAX, read from ``csrc/densify.cu``; every task the chooser
    gives fits a block at the model shapes and well beyond them."""
    import re
    from pathlib import Path

    dens = importlib.import_module("deltaconv_tpu_torch.ops.densify_op")
    src = (Path(dens.__file__).resolve().parent.parent / "csrc"
           / "densify.cu").read_text()
    body = re.search(r"inline size_t densify_int8_smem_bytes\(int R, int W, "
                     r"int K\) \{\s*return ([^;]+);", src).group(1)
    expr = body.replace("(size_t)", "").replace(" / ", " // ")
    for r, w, k in ((8, 1024, 20), (4, 2048, 30), (1, 8192, 20),
                    (34, 77, 30), (3, 1001, 9)):
        assert eval(expr, {"R": r, "W": w, "K": k}) == dens.densify_int8_smem(
            r, w, k)
    limit = re.search(r"kDensifySmemMax = (\d+);", src).group(1)
    assert int(limit) == dens.SMEM_MAX
    for n in (1, 16, 77, 1000, 1024, 2048, 4096, 8191, 8192, 8193, 65536):
        for k in (1, 20, 30, 64, 200):
            rows, width = dens.densify_int8_block(n, k)
            assert rows >= 1 and rows * width <= max(dens.DENSIFY_IMAGE, n)
            assert width == min(n, dens.DENSIFY_IMAGE)
            assert rows == 1 or rows * k <= dens.DENSIFY_SLOTS
            assert dens.densify_int8_smem(rows, width, k) <= dens.SMEM_MAX


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_int8_quantize_matches_jax(dtype):
    rng = np.random.default_rng(51)
    a = rng.standard_normal((B, N, 16)).astype(np.float32)
    a[1, 0, :3] = (128.0, 64.0, -64.0)  # cloud 1: ties of the rounding
    h_j, h = _inputs(rng, None, dtype, a)
    got_q, got_s = ops.int8_quantize(h)
    want_q, want_s = jax_gm.int8_quantize(h_j)
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[1, 0, :3].tolist() == [127, 64, -64]


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("self_slot0", [False, True])
def test_gather_max_int8_plain_matches_jax(dtype, self_slot0):
    """Bit-equal to the JAX kernel in interpret mode (its self-slot read
    included), rows with no valid neighbour 0."""
    rng = np.random.default_rng(52)
    h_j, h = _inputs(rng, (B, N, 24), dtype)
    idx = rng.integers(0, N, (B, N, 10)).astype(np.int32)
    idx[:, :, 0] = np.arange(N)
    mask = rng.random((B, N, 10)) > 0.2
    mask[..., 0] = True
    mask[1, 5:9] = False  # no valid neighbour
    got = ops.gather_max_int8_plain(h, _t(idx), _t(mask))
    want = jax_gm.gather_max_int8(h_j, jnp.asarray(idx), jnp.asarray(mask),
                                  self_slot0=self_slot0, interpret=True)
    assert got.dtype == h.dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    assert not got[1, 5:9].float().any()


def _max_then_quantize(h, idx, mask):
    """The int8 max as the card's route S computes it, in torch ops
    inline: the masked max of the features themselves (an id outside [0,
    N) gathers 0), then the quantization of that max (``a = max(max |h|,
    1e-30)``, ``rint(fl(fl(v / a) * 127))`` through an int), dequantized
    (``fl(q * fl(a / 127))``), 0 on a row with no valid slot."""
    b, n, c = h.shape
    hf = torch.cat([h.float(), torch.zeros((b, 1, c))], dim=1)
    ids = torch.where((idx < 0) | (idx >= n), n, idx).long()
    rows = torch.gather(hf, 1, ids.reshape(b, -1, 1).expand(-1, -1, c))
    rows = rows.reshape(b, n, -1, c)
    best = torch.where(mask[..., None], rows, -torch.inf).amax(dim=2)
    valid = mask.any(dim=-1, keepdim=True)
    a = torch.clamp(torch.linalg.vector_norm(h.float(), float("inf"),
                                             dim=(1, 2)), min=1e-30)
    q = torch.round(torch.where(valid, best, 0.0) / a[:, None, None]
                    * 127.0).int()
    out = q.float() * (a / 127.0)[:, None, None]
    return torch.where(valid, out, 0.0).to(h.dtype)


def _zero_row_graph(h, idx, mask):
    """``h`` with a zero row appended (its quantization unchanged) and
    the ids outside [0, N) pointed at it: the port's plain version gathers
    in range only."""
    b, n, c = h.shape
    hp = torch.cat([h, torch.zeros((b, 1, c), dtype=h.dtype)], dim=1)
    ids = torch.where((idx < 0) | (idx >= n), n, idx)
    ids = torch.cat([ids, torch.zeros_like(ids[:, :1])], dim=1)
    return hp, ids, torch.cat([mask, torch.zeros_like(mask[:, :1])], dim=1)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_max_then_quantize_is_the_int8_max(dtype, seed):
    """The identity the card's route S rests on: correctly rounded
    division and multiplication by a positive constant and ``rint`` are
    monotone non-decreasing, so the max of the quantized rows is the
    quantization of the max. Max-then-quantize in torch ops is bit-equal
    to ``gather_max_int8_plain`` (quantize first) and to the JAX kernel
    in interpret mode, on features on a half-step grid whose clouds' |h|
    maximum is 128 (so ``v / a * 127`` lands on the half-way points +-63.5
    and rounds half to even), with ties, masked slots, rows with no valid
    slot and ids outside [0, N)."""
    rng = np.random.default_rng(60 + seed)
    a = (np.round(rng.standard_normal((B, N, 24)) * 8) / 2).clip(-100, 100)
    a[:, 0, 0] = -128.0 if seed else 128.0
    a[:, 1, :4] = (64.0, -64.0, 0.5, -0.5)
    h_j, h = _inputs(rng, None, dtype, a.astype(np.float32))
    idx = rng.integers(0, N, (B, N, 10)).astype(np.int32)
    idx[:, 2, :2] = 1  # gathers the half-way points, and only them
    mask = rng.random((B, N, 10)) > 0.3
    mask[:, 2, :2], mask[:, 2, 2:] = True, False
    mask[1, 5:9] = False  # no valid neighbour
    idx[0, 3, 0], mask[0, 3, 0] = N + 5, True  # outside the cloud
    idx[1, 4, 9], mask[1, 4, 9] = -1, True
    got = _max_then_quantize(h, _t(idx), _t(mask))
    plain = ops.gather_max_int8_plain(*_zero_row_graph(h, _t(idx),
                                                       _t(mask)))[:, :N]
    want = jax_gm.gather_max_int8(h_j, jnp.asarray(idx), jnp.asarray(mask),
                                  interpret=True)
    assert got.dtype == plain.dtype == h.dtype
    np.testing.assert_array_equal(_np(got), _np(plain))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    assert not got[1, 5:9].float().any()
    # +-63.5 to even, +-0.496 to 0: the steps times 128 / 127, h's dtype.
    steps = (torch.tensor([64.0, -64.0, 0.0, 0.0])
             * (torch.tensor(128.0) / 127.0)).to(h.dtype)
    assert torch.equal(got[:, 2, :4], steps.expand(B, 4))
    gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
    np.testing.assert_array_equal(gm.absmax(h).numpy(), np.abs(
        _np(h)).max(axis=(1, 2)))


@pytest.mark.parametrize("n,route,launched", [
    (1024, None, ("absmax", "gather_max_int8")),  # by shape: route S
    (14527, None, ("gather_max_int8_direct",)),   # above every slice: D
    (1024, (0, 0), ("gather_max_int8_direct",)),  # forced route D
    (1024, (32, 3), ("absmax", "gather_max_int8")),
])
def test_int8_max_wrapper_launches_the_route(monkeypatch, n, route,
                                             launched):
    """``gather_max_int8``'s launches on CUDA tensors (recorded in place
    of the launch; meta tensors, no card): route S, ``absmax`` and then
    the staged max with ``max_slice``'s slice and splits and the bf16 flag
    last; route D, the earlier kernel on the quantized features, after
    the quantization in torch ops."""
    gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
    calls = []
    monkeypatch.setattr(gm._lib, "launch", lambda kernel, device, *args:
                        calls.append((kernel, args)))
    monkeypatch.setattr(gm, "_sm_count", lambda index: 132)
    b, c, k = 32, 128, 20
    h = torch.empty((b, n, c), dtype=torch.bfloat16, device="meta")
    idx = torch.empty((b, n, k), dtype=torch.int32, device="meta")
    mask = torch.empty((b, n, k), dtype=torch.bool, device="meta")
    out = torch.empty_like(h)
    gm._int8_launch(torch.device("cuda", 0), h, idx, mask, out, route)
    assert tuple(name for name, _ in calls) == launched
    if launched[0] == "absmax":
        assert calls[0][1][2:] == (b, n, c, 1)
        want = route or gm.max_slice(b, n, c, 2, k, 132)
        assert want[0] > 0
        assert calls[1][1][5:] == (b, n, c, k, *want, 1)
    else:
        assert calls[0][1][5:] == (b, n, c, k, 1)


def test_gather_matmul_max_int8_plain_matches_jax():
    """Within one bf16 ulp of the JAX kernel in interpret mode; bit-equal
    where the sums are exact in any order (weights in 1/16 steps)."""
    rng = np.random.default_rng(53)
    x_j, _ = _inputs(rng, (B, N, 32), None)
    xq_j, _ = jax_gm.int8_quantize(x_j)
    xq = _t(np.asarray(xq_j))
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    idx[:, :, 0] = np.arange(N)
    mask = rng.random((B, N, K)) > 0.2
    mask[..., 0] = True
    mask[0, 7] = False
    w = (rng.standard_normal((32, 48)) / 32).astype(np.float32)
    w_exact = (rng.integers(-16, 17, (32, 48)) / 16).astype(np.float32)
    for wv, exact in ((w, False), (w_exact, True)):
        w_j = jnp.asarray(wv).astype(jnp.bfloat16)
        wt = _t(np.asarray(w_j, np.float32)).to(torch.bfloat16)
        got = ops.gather_matmul_max_int8_plain(xq, wt, _t(idx), _t(mask))
        want = np.asarray(jax_gm.gather_matmul_max_int8(
            xq_j, w_j, jnp.asarray(idx), jnp.asarray(mask), interpret=True,
            self_slot0=True), np.float32)
        assert got.dtype == torch.bfloat16 and got.shape == (B, N, 48)
        ulps = _bf16_ulps(_np(got), want)
        assert ulps.max() <= (0 if exact else 1), ulps.max()
    assert float(got[0, 7, 0]) < -1e38  # no valid neighbour: -3e38


def _operators(rng, masked):
    """The port's int8 dense operators of a batch (real clouds) and the
    same arrays and scales as a JAX DenseGradDiv."""
    sizes = [N, 90] if masked else [N] * B
    pos, nrm, mask = _padded(*_clouds(rng, sizes))
    gd = build_operators(_t(pos), K, _t(nrm), _t(mask) if masked else None,
                         operator_dtype="int8")
    assert gd.int8 and gd.w_grad.dtype == torch.int8
    jgd = JaxDenseGradDiv(
        jnp.asarray(gd.nbr_idx.numpy()), jnp.asarray(gd.nbr_mask.numpy()),
        jnp.asarray(gd.w_grad.numpy()), jnp.asarray(gd.w_div.numpy()),
        op_scale_grad=jnp.asarray(gd.op_scale_grad.numpy()),
        op_scale_div=jnp.asarray(gd.op_scale_div.numpy()))
    return gd, jgd


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_int8_applies_match_jax(dtype):
    """grad and div on the same int8 operators and scales: bit-equal in
    f32 (quantization, exact s8 x s8 -> s32 products, one scaling), within
    one bf16 ulp in bf16."""
    rng = np.random.default_rng(54)
    gd, jgd = _operators(rng, masked=True)
    x_j, x = _inputs(rng, (B, N, 3), dtype)
    v_j, v = _inputs(rng, (B, N, 2, 20), dtype)
    for got, want in ((gd.grad(x), jgd.grad(x_j)), (gd.div(v), jgd.div(v_j))):
        assert got.dtype == x.dtype and got.shape == want.shape
        if dtype is None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            assert _bf16_ulps(_np(got), np.asarray(want, np.float32)).max() \
                <= 1


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=MODULE_TOL, atol=MODULE_TOL)


def _narrower_int8_reference(params, stats, x_j, jgd):
    """The JAX PointMaxMLP's lane-narrower int8 branch, as it runs on the
    TPU (nn/deltaconv.py:336-352): the sign-folded weight through JAX's
    ``nbr_matmul_max`` on int8 operators (``int8_quantize``,
    ``gather_matmul_max_int8``, dequantization), then the epilogue. On
    the CPU the JAX module takes its per-point branch instead."""
    w = jnp.asarray(params["lin0"]["kernel"])
    bn, st = params["bn0"]["BatchNorm_0"], stats["bn0"]["BatchNorm_0"]
    inv = jax.lax.rsqrt(jnp.asarray(st["var"]) + 1e-5) * bn["scale"]
    sign = jnp.where(inv >= 0, 1.0, -1.0)
    wp = (w * sign[None, :]).astype(jnp.bfloat16)
    mxp = jgd.nbr_matmul_max(x_j.astype(jnp.bfloat16), wp, self_slot0=True)
    out = leaky_relu02((sign * mxp.astype(jnp.float32) - st["mean"]) * inv
                       + bn["bias"])
    any_valid = jnp.any(jgd.nbr_mask, axis=-1)[..., None]
    return jnp.where(any_valid, out, 0.0).astype(jnp.bfloat16)


@pytest.mark.parametrize("kind,c_in,c_out", [
    ("edge", 3, 8), ("point", 8, 16), ("point", 16, 136)])
def test_scalar_max_branch_int8_matches_jax(kind, c_in, c_out):
    """EdgeMaxMLP and PointMaxMLP on int8 operators, bf16 compute: the
    epilogue outside the max. 8 -> 16: the per-point MLP, then the int8
    max; 16 -> 136 (lane-narrower): the int8 matmul max, held against the
    JAX composition of that branch."""
    rng = np.random.default_rng(55)
    gd, jgd = _operators(rng, masked=True)
    x_j, x = _inputs(rng, (B, N, c_in), "bfloat16")
    jax_cls = jax_dc.EdgeMaxMLP if kind == "edge" else jax_dc.PointMaxMLP
    layer = jax_cls(c_out, dtype="bfloat16")
    params, stats = _variables(layer.init(jax.random.PRNGKey(0), x_j, jgd),
                               rng)
    if c_out == 136:
        want = _narrower_int8_reference(params, stats, x_j, jgd)
    else:
        want = layer.apply({"params": params, "batch_stats": stats}, x_j,
                           jgd, train=False)
    port = (EdgeMaxMLP if kind == "edge" else PointMaxMLP)(
        c_in, c_out, dtype=torch.bfloat16)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.eval()
    with torch.inference_mode():
        got = port(x, gd)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, c_out)
    _close(got, want)
    assert not got[1, 90:].float().any()  # padded points: no neighbour


@pytest.mark.parametrize("centralized,c_in,c_out", [
    (True, 3, 16), (False, 16, 136), (False, 8, 16)],
    ids=["centralized-fused", "narrower-fused", "point"])
def test_deep_max_mlp_int8_matches_jax(centralized, c_in, c_out,
                                       monkeypatch):
    """DeepMaxMLP keeps its fused kernel on int8 operators (it gathers
    bf16 features); its per-point branch ends in the int8 max."""
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    rng = np.random.default_rng(56)
    gd, jgd = _operators(rng, masked=True)
    x_j, x = _inputs(rng, (B, N, c_in), "bfloat16")
    layer = jax_dc.DeepMaxMLP((c_out, c_out), centralized=centralized,
                              dtype="bfloat16")
    params, stats = _variables(layer.init(jax.random.PRNGKey(0), x_j, jgd),
                               rng)
    want = layer.apply({"params": params, "batch_stats": stats}, x_j, jgd,
                       train=False)
    port = DeepMaxMLP(c_in, (c_out, c_out), centralized, torch.bfloat16)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.eval()
    with torch.inference_mode():
        got = port(x, gd)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, c_out)
    _close(got, want)


@pytest.mark.parametrize("centralized,c_in,c_out,masked", [
    (True, 3, 8, False), (True, 3, 8, True), (False, 8, 16, True)])
def test_deltaconv_int8_matches_jax(centralized, c_in, c_out, masked):
    """A whole DeltaConv on int8 operators, bf16 compute: both streams,
    the quantized applies, the int8 max with the epilogue after it."""
    rng = np.random.default_rng(57)
    gd, jgd = _operators(rng, masked)
    x_j, x = _inputs(rng, (B, N, c_in), "bfloat16")
    v_j, v = _inputs(rng, (B, N, 2, c_in), "bfloat16")
    layer = jax_dc.DeltaConv(c_out, centralized=centralized,
                             dtype="bfloat16")
    params, stats = _variables(
        layer.init(jax.random.PRNGKey(0), x_j, v_j, jgd), rng)
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


def _pair(model_cls, port_cls, width, rng, seg=False, **port_kw):
    """(JAX model, its perturbed numpy variables, the port loaded from
    them)."""
    model = model_cls(num_classes=NUM_CLASSES, **width)
    pos, nrm, _ = _padded(*_clouds(rng, [N] * B))
    kwargs = {"category": np.eye(16, dtype=np.float32)[[3, 11]]} if seg \
        else {}
    variables = model.init(jax.random.PRNGKey(0), pos, normal=nrm, **kwargs)
    params, stats = _variables(variables, rng)
    port = port_cls(NUM_CLASSES, **width, **port_kw)
    head = {"head": "segmentation"} if seg else {}
    port.load_state_dict(state_dict_from_flax(params, stats, **head),
                         strict=True)
    return model, {"params": params, "batch_stats": stats}, port


def _held(got, want, base, rel):
    """Max deviation from ``want`` below ``rel`` x max|want|; argmax equal
    wherever the f32 (``base``) margin exceeds twice the deviation."""
    dev = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"max deviation {dev:.3e}, {dev / scale:.3e} x max|logit|")
    assert dev < rel * scale
    top2 = np.sort(base, axis=-1)
    decisive = top2[..., -1] - top2[..., -2] > 2 * dev
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()
    return dev


SIZES = {"uniform": [N] * 3, "ragged": [N, 100, 77]}


@pytest.fixture(scope="module")
def same_route_pair():
    """Classification where no conv is lane-narrower."""
    return _pair(JaxModel, DeltaNetClassification,
                 dict(conv_channels=(8, 16, 16, 32), embedding_size=32,
                      num_neighbors=K), np.random.default_rng(58))


def _counted(monkeypatch, module, name, calls):
    """Counts the calls of ``module.name`` (a plain version that the
    CPU wrapper reaches through the module's globals)."""
    fn = getattr(module, name)

    def counting(*args):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args)

    monkeypatch.setattr(module, name, counting)


@pytest.mark.parametrize("sizes", ["uniform", "ragged"])
def test_int8_engine_matches_jax_engine(same_route_pair, sizes,
                                        monkeypatch):
    """Both packages take the same route: the int8 assembly once a batch,
    the int8 max at every conv (none is lane-narrower)."""
    model, variables, port = same_route_pair
    clouds, normals = _clouds(np.random.default_rng(59), SIZES[sizes])
    want = JaxEngine(model, variables, num_points=N, batch_size=B,
                     precision="int8").predict(clouds, normals)
    base = JaxEngine(model, variables, num_points=N,
                     batch_size=B).predict(clouds, normals)
    engine = InferenceEngine(port, num_points=N, batch_size=B,
                             precision="int8", device="cpu")
    calls = {}
    _counted(monkeypatch, importlib.import_module(
        "deltaconv_tpu_torch.ops.densify_op"), "densify_coefs_int8_plain",
        calls)
    _counted(monkeypatch, importlib.import_module(
        "deltaconv_tpu_torch.ops.gather_max"), "gather_max_int8_plain", calls)
    got = engine.predict(clouds, normals)
    assert got.shape == (len(clouds), NUM_CLASSES) and got.dtype == np.float32
    assert engine.model.operator_dtype == torch.int8
    assert engine.model.compute_dtype == torch.bfloat16
    assert calls == {"densify_coefs_int8_plain": 2,
                     "gather_max_int8_plain": 2 * 4}  # 2 batches
    _held(got, want, base, 0.01)


@pytest.mark.parametrize("sizes", ["uniform", "ragged"])
def test_int8_engine_narrower_conv_within_jax_bound(sizes):
    """(8, 16, 16, 136): the port's last conv takes the int8 matmul max
    (the JAX package's TPU route); JAX on the CPU takes the per-point
    branch. Both are held to the JAX package's int8 serving bound against
    the f32 engine, and the port to it against JAX's int8 engine."""
    model, variables, port = _pair(
        JaxModel, DeltaNetClassification,
        dict(conv_channels=(8, 16, 16, 136), embedding_size=32,
             num_neighbors=K), np.random.default_rng(60))
    clouds, normals = _clouds(np.random.default_rng(61), SIZES[sizes])
    base = JaxEngine(model, variables, num_points=N,
                     batch_size=B).predict(clouds, normals)
    want = JaxEngine(model, variables, num_points=N, batch_size=B,
                     precision="int8").predict(clouds, normals)
    got = InferenceEngine(port, num_points=N, batch_size=B, precision="int8",
                          device="cpu").predict(clouds, normals)
    _held(got, base, base, 0.05)
    _held(want, base, base, 0.05)
    _held(got, want, base, 0.05)


def test_int8_segmentation_engine_matches_jax_engine(monkeypatch):
    """Segmentation (8, 16, 136) with int categories, ragged with a
    partial batch: conv0 and conv2 keep gather_mlp_max, conv1 ends in the
    int8 max, in both packages (the JAX side on its interpret hook)."""
    monkeypatch.setattr(jax_dc, "_FORCE_FUSED_INTERPRET", True)
    model, variables, port = _pair(
        JaxSegModel, DeltaNetSegmentation,
        dict(conv_channels=(8, 16, 136), embedding_size=32, num_neighbors=K,
             categorical_vector=True), np.random.default_rng(62), seg=True)
    clouds, normals = _clouds(np.random.default_rng(63), [N, 100, 77])
    cats = [3, 15, 0]
    want = JaxEngine(model, variables, num_points=N, batch_size=B,
                     precision="int8").predict(clouds, normals,
                                               categories=cats)
    base = JaxEngine(model, variables, num_points=N, batch_size=B).predict(
        clouds, normals, categories=cats)
    got = InferenceEngine(port, num_points=N, batch_size=B, precision="int8",
                          device="cpu").predict(clouds, normals,
                                                categories=cats)
    assert [g.shape for g in got] == [(len(c), NUM_CLASSES) for c in clouds]
    _held(np.concatenate(got), np.concatenate(want), np.concatenate(base),
          0.05)


def test_f32_compute_on_int8_operators():
    """operator_dtype="int8" on an f32 model (tests/models/test_models.py):
    the quantized applies and maxes track the f32 path within 0.01 x
    max|logit| with the same argmax, and the JAX model of the same config
    within 1e-3 x max|logit|."""
    rng = np.random.default_rng(64)
    width = dict(conv_channels=(16, 16, 32), embedding_size=32,
                 num_neighbors=12)
    model, variables, port = _pair(JaxModel, DeltaNetClassification, width,
                                   rng)
    pos, nrm, _ = _padded(*_clouds(rng, [N] * 4))
    port.eval()
    with torch.inference_mode():
        f32 = port(_t(pos), _t(nrm)).numpy()
        port.set_precision(None, "int8")
        got = port(_t(pos), _t(nrm)).numpy()
    jax8 = np.asarray(model.clone(operator_dtype="int8").apply(
        variables, pos, normal=nrm, train=False))
    scale = float(np.abs(f32).max())
    assert np.abs(got - f32).max() < 0.01 * scale
    assert (got.argmax(-1) == f32.argmax(-1)).all()
    assert np.abs(got - jax8).max() < 1e-3 * scale
