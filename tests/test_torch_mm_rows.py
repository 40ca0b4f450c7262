"""The bf16 matmul maxes of deltaconv_tpu_torch on the CPU: the route
choice of their CUDA wrappers (pure functions, no card) and their plain
versions against the JAX package at the shapes the card tests give the
kernels (ragged N, C_out = 40, rows with no valid neighbour).

On the card ``ops.gather_matmul_max`` and ``ops.gather_matmul_max_win``
run one product a row (``csrc/gather_matmul_max_rows.cuh``: a cloud's
slice of Cs columns of ``x @ w`` in shared memory) up to the size
``mm_slice`` allows, and the K-fold kernels (``_kfold``) above it; the
kernels themselves are held against these plain versions by
``tests/test_torch_gpu.py``.

The JAX side: ``gather_matmul_max`` runs its Pallas kernel in interpret
mode; the train form through ``_mm_train_reference_fwd``, its CPU
reference path (the TPU kernel takes no interpret flag). Inputs are made
with numpy from a seed. Tolerances, and why: on inputs whose products
and sums are exact in f32 in any order, values and winners are
bit-equal; with the epilogue, XLA's CPU compiler contracts ``(h - mean)
* inv + bias`` into an FMA, so an element on a bf16 rounding boundary may
land one bf16 ulp away (at most 1e-3 of the elements); on random inputs
the f32 sums run in another order: one bf16 ulp.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu.ops.gather_max import _mm_train_reference_fwd
from deltaconv_tpu.ops.gather_max import gather_matmul_max as jax_mm_max
from deltaconv_tpu_torch import ops

GM = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
NEG_BF16 = float(torch.tensor(GM.NEG).to(torch.bfloat16))

torch.set_num_threads(1)


# -- the route: column slice of the one-product-a-row kernels, or K-fold ---


@pytest.mark.parametrize("b,n,c_in,c_out,k,sms,want", [
    (32, 1024, 128, 256, 20, 132, 64),  # classification conv3: one wave
    (4, 8192, 128, 256, 20, 132, 8),    # the large clouds: 128 tasks
    (4, 1024, 128, 256, 20, 132, 8),    # narrowed while tasks fit a wave
    (32, 1024, 128, 256, 20, 16, 64),   # no narrowing on a small card
    (2, 150, 32, 48, 9, 132, 8),        # C_out = 40 padded to 48
    (1, 10038, 128, 256, 20, 132, 8),   # the largest cloud at C_in = 128
    (1, 10039, 128, 256, 20, 132, 0),   # above it: the K-fold route
    (1, 1024, 4096, 256, 20, 132, 0),   # two x stages do not fit
    (2, 150, 32, 48, 65535, 132, 8),    # the 16-bit winner slots' limit
    (2, 150, 32, 48, 65536, 132, 0),
])
def test_mm_slice_routes(b, n, c_in, c_out, k, sms, want):
    """``mm_slice``: the widest of 64, 32, 16, 8 columns that divides
    C_out and fits a block, narrowed while twice the tasks still fit one
    wave; 0 (the K-fold kernels) when no slice fits or K exceeds 16
    bits."""
    assert GM.mm_slice(b, n, c_in, c_out, k, sms) == want


@pytest.mark.parametrize("seed", range(4))
def test_mm_slice_rules_hold(seed):
    """On random shapes: a slice divides C_out and fits the shared memory
    (``mm_rows_smem``); every wider slice that divides C_out either does
    not fit or would have kept the tasks within one wave after halving;
    0 only where no slice fits or K is out of range."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        b = int(rng.integers(1, 65))
        n = int(rng.integers(8, 20000))
        c_in = 16 * int(rng.integers(1, 17))
        c_out = 16 * int(rng.integers(1, 33))
        k = int(rng.integers(1, 80))
        sms = int(rng.choice([16, 66, 132]))
        cs = GM.mm_slice(b, n, c_in, c_out, k, sms)
        fits = [c for c in GM.MM_SLICES if c_out % c == 0
                and GM.mm_rows_smem(n, c_in, c) <= GM.SMEM_MAX]
        if not fits:
            assert cs == 0
            continue
        assert cs in fits
        for wider in fits[:fits.index(cs)]:
            assert b * (c_out // (wider // 2)) <= sms


def test_mm_rows_smem_counts_the_block():
    """The shared memory the CUDA launcher asks for at two x stages: the
    y slice and its two constant rows, the affine and W slices, two
    stages of 128 padded x rows; the classification slice (64 columns of
    1024 rows) and the large-cloud one (8 columns of 8192) fit a block,
    as does the largest cloud at C_in = 128."""
    assert GM.mm_rows_smem(1024, 128, 64) == (
        2 * 1026 * 64 + 16 * 64 + 2 * 128 * 72 + 4 * 128 * 136)
    assert GM.mm_rows_smem(8192, 128, 8) == (
        2 * 8194 * 8 + 16 * 8 + 2 * 128 * 8 + 4 * 128 * 136)
    for n, cs in ((1024, 64), (8192, 8), (10038, 8)):
        assert GM.mm_rows_smem(n, 128, cs) <= GM.SMEM_MAX
    assert GM.mm_rows_smem(10039, 128, 8) > GM.SMEM_MAX


@pytest.mark.parametrize("name", ["gather_matmul_max",
                                  "gather_matmul_max_win"])
@pytest.mark.parametrize("n,cs,launched,extra", [
    (1024, None, "", (64,)),           # route by shape: one product a row
    (10039, None, "_kfold", ()),       # above the limit: K-fold
    (1024, 0, "_kfold", ()),           # forced K-fold
    (1024, 16, "", (16,)),             # a given slice is passed on
])
def test_wrapper_launches_the_route(monkeypatch, name, n, cs, launched,
                                    extra):
    """``_mm_launch``, the wrappers' last step, launches the kernel of the
    chosen route: the one-product-a-row kernel with its slice as the last
    argument, or the ``_kfold`` kernel without it (recorded in place of
    the launch; no card)."""
    calls = []
    monkeypatch.setattr(GM._lib, "launch",
                        lambda kernel, device, *args: calls.append(
                            (kernel, args)))
    monkeypatch.setattr(GM, "_sm_count", lambda index: 132)
    GM._mm_launch(name, torch.device("cuda", 0), (11, 12), 32, n, 128, 256,
                  20, cs)
    assert calls == [(name + launched, (11, 12, 32, n, 128, 256, 20)
                      + extra)]


# -- the int8 matmul max: the same kernels on int8 rows ----------------------


@pytest.mark.parametrize("b,n,k,want", [
    (32, 1024, 20, 64),   # classification conv3: one wave
    (1, 10039, 20, 8),    # above the bf16 limit, within the int8 one
    (1, 10166, 20, 8),    # the largest cloud at C_in = 128 in int8
    (1, 10167, 20, 0),    # above it: the K-fold route
    (2, 150, 65536, 0),   # the 16-bit winner slots' limit holds here too
])
def test_mm_slice_routes_int8(b, n, k, want):
    """``mm_slice`` for int8 x (``itemsize`` 1): the same rule on the
    block that stages int8 rows (two unpadded int8 stages and one padded
    bf16 tile in place of two padded bf16 stages), so its size limit at
    C_in = 128 moves from 10,038 to 10,166 points."""
    assert GM.mm_slice(b, n, 128, 256, k, 132, 1) == want


def test_mm_rows_smem_counts_the_int8_block():
    """The int8 block: the y slice and its constant rows, the affine and
    W slices, two int8 stages of 128 rows and the bf16 tile they are
    widened into; it is smaller than the bf16 block by one padded bf16
    stage less two int8 ones, and fits the block where the bf16 one
    does not (10,039 .. 10,166 points)."""
    assert GM.mm_rows_smem(1024, 128, 64, 1) == (
        2 * 1026 * 64 + 16 * 64 + 2 * 128 * 72 + 2 * 128 * 128
        + 2 * 128 * 136)
    assert (GM.mm_rows_smem(1024, 128, 64, 2)
            - GM.mm_rows_smem(1024, 128, 64, 1)) == 128 * (2 * 136 - 2 * 128)
    for n in (10039, 10166):
        assert GM.mm_rows_smem(n, 128, 8, 2) > GM.SMEM_MAX
        assert GM.mm_rows_smem(n, 128, 8, 1) <= GM.SMEM_MAX
    assert GM.mm_rows_smem(10167, 128, 8, 1) > GM.SMEM_MAX


@pytest.mark.parametrize("n,cs,launched,extra", [
    (1024, None, "", (64,)),           # route by shape: one product a row
    (10166, None, "", (8,)),           # int8's own limit
    (10167, None, "_kfold", ()),       # above it: K-fold
    (1024, 0, "_kfold", ()),           # forced K-fold
])
def test_int8_wrapper_launches_the_route(monkeypatch, n, cs, launched,
                                         extra):
    """``_mm_launch`` with int8 x (``itemsize`` 1, as
    ``gather_matmul_max_int8`` calls it) launches the route that
    ``mm_slice`` names for int8 rows: ``gather_matmul_max_int8`` with its
    slice, or ``gather_matmul_max_int8_kfold`` without it."""
    calls = []
    monkeypatch.setattr(GM._lib, "launch",
                        lambda kernel, device, *args: calls.append(
                            (kernel, args)))
    monkeypatch.setattr(GM, "_sm_count", lambda index: 132)
    name = "gather_matmul_max_int8"
    GM._mm_launch(name, torch.device("cuda", 0), (11, 12), 32, n, 128, 256,
                  20, cs, itemsize=1)
    assert calls == [(name + launched, (11, 12, 32, n, 128, 256, 20)
                      + extra)]


# -- the neighbour max: route S (a staged channel slice) or route D --------


@pytest.mark.parametrize("b,n,c,itemsize,k,winners,want", [
    (32, 1024, 64, 4, 20, False, (32, 2)),   # f32 conv0/conv1: split in two
    (32, 1024, 128, 4, 20, True, (32, 1)),   # f32 conv2: 128 tasks
    (32, 1024, 256, 4, 20, True, (32, 1)),   # f32 conv3: 256 tasks
    (32, 1024, 64, 2, 20, True, (64, 4)),    # bf16 train, conv0/conv1
    (32, 1024, 128, 2, 20, True, (64, 2)),   # bf16 train, conv2
    (16, 2048, 128, 2, 30, False, (32, 2)),  # bf16 seg serving: 64-byte rows
    (4, 8192, 64, 4, 20, False, (4, 2)),     # large f32: 16-byte rows
    (4, 8192, 256, 4, 20, False, (4, 1)),
    (4, 8192, 128, 2, 20, True, (8, 2)),     # large bf16 step
    (2, 150, 3, 4, 9, False, (4, 2)),        # one 16-byte row, two blocks
    (2, 150, 301, 4, 9, True, (32, 2)),      # an odd width
    (1, 14526, 64, 4, 20, False, (4, 8)),    # the largest cloud
    (1, 14527, 64, 4, 20, False, (0, 0)),    # above it: route D
    (1, 65536, 64, 2, 20, False, (0, 0)),    # a point-shard table
    (32, 1024, 64, 4, 0, False, (0, 0)),     # no slot: route D
    (2, 150, 64, 2, 65536, True, (0, 0)),    # above the bf16 winners
    (2, 150, 64, 4, 65536, True, (32, 2)),   # f32 winners are whole words
    (32, 1024, 64, 4, 20, False, (32, 2)),
    # the bf16 eval max (gather_max_affine, no winners)
    (32, 1024, 64, 2, 20, False, (64, 4)),   # cls conv0/conv1
    (32, 1024, 128, 2, 20, False, (64, 2)),  # cls conv2
    (4, 8192, 64, 2, 20, False, (8, 4)),     # large clouds: 16-byte rows
    (4, 8192, 128, 2, 20, False, (8, 2)),
    (1, 14526, 64, 2, 20, False, (8, 16)),   # the largest cloud
    (1, 14527, 64, 2, 20, False, (0, 0)),    # above it: route D
    (2, 1814, 64, 2, 9, False, (64, 15)),    # 128-byte rows up to 1,814
    (2, 1815, 64, 2, 9, False, (32, 15)),
    (2, 150, 70, 2, 9, False, (64, 2)),      # an odd width
    (32, 1024, 64, 2, 0, False, (0, 0)),     # no slot: route D
])
def test_max_slice_routes(b, n, c, itemsize, k, winners, want):
    """``max_slice``: route S's slice (channels) and splits at the model
    shapes in f32 and bf16 (each block within SMEM_MAX), route D where no
    slice fits or K rules it out."""
    got = GM.max_slice(b, n, c, itemsize, k, 132, winners)
    assert got == want
    if got[0]:
        assert GM.max_smem(n, got[0] * itemsize) <= GM.SMEM_MAX


@pytest.mark.parametrize("seed", range(4))
def test_max_slice_rules_hold(seed):
    """On random shapes: a route-S row is the widest of MAX_ROW_BYTES
    whose block fits SMEM_MAX, unless a narrower row covers the features'
    row whole; the splits keep the blocks within one wave where they
    exceed one, fill it as far as MAX_SPLIT_POINTS points a block allow,
    and are 1 where the tasks fill the wave; route D only where no row
    fits or K rules route S out."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        b = int(rng.integers(1, 65))
        n = int(rng.integers(1, 20000))
        c = int(rng.integers(1, 600))
        itemsize = int(rng.choice([2, 4]))
        k = int(rng.integers(0, 80))
        sms = int(rng.choice([16, 66, 132]))
        winners = bool(rng.integers(0, 2))
        cs, splits = GM.max_slice(b, n, c, itemsize, k, sms, winners)
        need = c * itemsize
        fits = [rb for rb in GM.MAX_ROW_BYTES
                if GM.max_smem(n, rb) <= GM.SMEM_MAX
                and (rb == 16 or rb // 2 < need)]
        if not fits or k == 0:
            assert (cs, splits) == (0, 0)
            continue
        rb = cs * itemsize
        assert rb == fits[0] and GM.max_smem(n, rb) <= GM.SMEM_MAX
        tasks = b * -(-need // rb)
        most = -(-n // GM.MAX_SPLIT_POINTS)
        assert splits == max(1, min(sms // tasks, most))
        if splits > 1:
            assert tasks * splits <= sms and splits <= most


@pytest.mark.parametrize("name", ["gather_max", "gather_max_win",
                                  "gather_max_bf16", "gather_max_win_bf16"])
@pytest.mark.parametrize("n,route,launched,extra", [
    (1024, None, "", None),             # by shape: route S, max_slice's
    (14527, None, "_direct", ()),       # above every slice: route D
    (1024, (0, 0), "_direct", ()),      # forced route D
    (1024, (32, 3), "", (32, 3)),       # a given slice and split
])
def test_max_wrapper_launches_the_route(monkeypatch, name, n, route,
                                        launched, extra):
    """``_max_launch``, the last step of ``gather_max``'s and
    ``gather_max_win``'s wrappers, launches the route that ``max_slice``
    names (its slice and splits the last arguments) or route D's
    ``_direct`` kernel without them (recorded in place of the launch; no
    card)."""
    calls = []
    monkeypatch.setattr(GM._lib, "launch",
                        lambda kernel, device, *args: calls.append(
                            (kernel, args)))
    monkeypatch.setattr(GM, "_sm_count", lambda index: 132)
    dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
    c = 64
    h = torch.empty((32, n, c), dtype=dtype, device="meta")
    winners = "_win" in name
    GM._max_launch(name, torch.device("cuda", 0), (11, 12), h, 20, route,
                   winners)
    if extra is None:
        extra = GM.max_slice(32, n, c, h.element_size(), 20, 132, winners)
        assert extra[0] > 0
    assert calls == [(name + launched, (11, 12, 32, n, c, 20) + extra)]


# Torch functions that reduce or compute: the affine max's kernels do that
# work, so its wrapper calls none of them on CUDA tensors beyond the
# affine rows' stack.
_COMPUTE = {"amax", "amin", "max", "min", "sum", "any", "all", "abs",
            "linalg_vector_norm", "clamp", "div", "__truediv__", "sub",
            "__sub__", "mul", "__mul__", "add", "__add__", "where",
            "gather"}


class _Calls(torch.overrides.TorchFunctionMode):
    """Records the name of every torch function called under it."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.add(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


GS = importlib.import_module("deltaconv_tpu_torch.ops.gather_sum")


@pytest.mark.parametrize("b,n,c,k,want", [
    (4, 8192, 128, 20, (4, 1)),      # large-cloud step: 16-byte rows
    (32, 1024, 128, 20, (32, 1)),    # the streaming route at B=32
    (32, 1024, 64, 20, (32, 2)),     # conv widths below: two blocks a task
    (1, 14526, 128, 20, (4, 4)),     # the largest route-S cloud
    (1, 14527, 128, 20, (0, 0)),     # above it: route D
    (4, 8192, 128, 0, (0, 0)),       # no slot: route D
])
def test_sum_slice_routes(b, n, c, k, want):
    """``sum_slice``: the neighbour sum's route S (the staged slice and its
    splits, by ``max_slice``'s rules for f32 rows without winners) at the
    large-cloud shape, route D above 14,526 points and at K=0."""
    got = GS.sum_slice(b, n, c, k, 132)
    assert got == want == GM.max_slice(b, n, c, 4, k, 132)
    if got[0]:
        assert GM.max_smem(n, got[0] * 4) <= GM.SMEM_MAX


@pytest.mark.parametrize("n,k,route,launched,extra", [
    (8192, 20, None, "", (4, 1)),       # by shape: route S
    (14527, 20, None, "_direct", ()),   # above every slice: route D
    (8192, 0, None, "_direct", ()),     # no slot: route D
    (8192, 20, (0, 0), "_direct", ()),  # forced route D
    (1024, 20, (32, 3), "", (32, 3)),   # a given slice and split
])
def test_sum_wrapper_launches_the_route(monkeypatch, n, k, route, launched,
                                        extra):
    """The streaming forward's one launch on CUDA tensors (recorded in
    place of the launch; meta tensors, no card): ``gather_sum`` with the
    slice and splits last, or ``gather_sum_direct`` without them; no torch
    op that reduces or computes."""
    calls = []
    monkeypatch.setattr(GS._lib, "launch",
                        lambda kernel, device, *args: calls.append(
                            (kernel, args)))
    monkeypatch.setattr(GS._lib, "check_inputs",
                        lambda name, specs: torch.device("meta"))
    monkeypatch.setattr(GS, "_sm_count", lambda index: 132)
    b, c = 4, 128
    h = torch.empty((b, n, c), device="meta")
    idx = torch.empty((b, n, k), dtype=torch.int32, device="meta")
    mask = torch.empty((b, n, k), dtype=torch.bool, device="meta")
    with _Calls() as seen:
        out = GS._gather_sum_fwd(h, idx, mask, route)
    assert not seen.names & _COMPUTE, seen.names & _COMPUTE
    assert out.shape == h.shape and out.dtype == torch.float32
    assert [(name, args[4:]) for name, args in calls] == [
        ("gather_sum" + launched, (b, n, c, k) + extra)]


@pytest.mark.parametrize("n,route,launched,extra", [
    (1024, None, "", None),          # by shape: route S, max_slice's
    (8192, None, "", None),          # large clouds: 16-byte rows
    (14526, None, "", None),         # the largest route-S cloud
    (14527, None, "_direct", ()),    # above it: route D
    (1024, (0, 0), "_direct", ()),   # forced route D
    (1024, (32, 3), "", (32, 3)),    # a given slice and split
])
@pytest.mark.parametrize("sub_self", [False, True])
def test_affine_wrapper_launches_the_route(monkeypatch, n, route, launched,
                                           extra, sub_self):
    """``gather_max_affine``'s one launch on CUDA tensors (recorded in
    place of the launch; meta tensors, no card): route S with
    ``max_slice``'s slice and splits, or route D's
    ``gather_max_affine_direct``, each with ``sub_self`` last; no torch
    op that reduces or computes."""
    calls = []
    monkeypatch.setattr(GM._lib, "launch",
                        lambda kernel, device, *args: calls.append(
                            (kernel, args)))
    monkeypatch.setattr(GM._lib, "check_inputs",
                        lambda name, specs: torch.device("cuda", 0))
    monkeypatch.setattr(GM, "_sm_count", lambda index: 132)
    b, c, k = 4, 64, 20
    h = torch.empty((b, n, c), dtype=torch.bfloat16, device="meta")
    idx = torch.empty((b, n, k), dtype=torch.int32, device="meta")
    mask = torch.empty((b, n, k), dtype=torch.bool, device="meta")
    aff = tuple(torch.empty(c, device="meta") for _ in range(4))
    with _Calls() as seen:
        out = GM._gather_max_affine(h, idx, mask, aff, sub_self, route)
    assert not seen.names & _COMPUTE, seen.names & _COMPUTE
    assert out.shape == h.shape and out.dtype == torch.bfloat16
    if extra is None:
        extra = GM.max_slice(b, n, c, 2, k, 132)
        assert extra[0] > 0
    assert [(name, args[5:]) for name, args in calls] == [
        ("gather_max_affine" + launched, (b, n, c, k) + extra
         + (int(sub_self),))]


# -- the neighbour min/max (#10) and the matmul min/max (#13) ----------------


@pytest.mark.parametrize("body", ["gather_minmax", "gather_minmax_bf16",
                                  "gather_minmax_win",
                                  "gather_minmax_win_bf16"])
@pytest.mark.parametrize("n,route,launched,extra", [
    (1024, None, "", None),          # by shape: route S, max_slice's
    (8192, None, "", None),          # large clouds: 16-byte rows
    (14526, None, "", None),         # the largest route-S cloud
    (14527, None, "_direct", ()),    # above it: route D
    (1024, (0, 0), "_direct", ()),   # forced route D
    (1024, (32, 3), "", (32, 3)),    # a given slice and split
])
def test_minmax_wrapper_launches_the_route(monkeypatch, body, n, route,
                                           launched, extra):
    """The min/max forwards' one launch on CUDA tensors (``_minmax``
    without winners, ``_gather_minmax_win`` with them; recorded in place
    of the launch, meta tensors, no card): route S, the staged min/max
    with ``max_slice``'s slice and splits (the max's rule: bf16 winners
    and all), up to 14,526 points, or route D's ``_direct`` kernel above
    them; its outputs (two, or four with the winners) after h, idx and
    mask; no torch op that reduces or computes."""
    calls = []
    monkeypatch.setattr(GM._lib, "launch",
                        lambda kernel, device, *args: calls.append(
                            (kernel, args)))
    monkeypatch.setattr(GM._lib, "check_inputs",
                        lambda name, specs: torch.device("meta"))
    monkeypatch.setattr(GM, "_sm_count", lambda index: 132)
    b, c, k = 4, 64, 20
    dtype = torch.bfloat16 if body.endswith("bf16") else torch.float32
    winners = "_win" in body
    h = torch.empty((b, n, c), dtype=dtype, device="meta")
    idx = torch.empty((b, n, k), dtype=torch.int32, device="meta")
    mask = torch.empty((b, n, k), dtype=torch.bool, device="meta")
    with _Calls() as seen:
        outs = (GM._gather_minmax_win(h, idx, mask, route) if winners
                else GM._minmax(h, idx, mask, route))
    assert not seen.names & _COMPUTE, seen.names & _COMPUTE
    assert len(outs) == (4 if winners else 2)
    assert [o.dtype for o in outs] == [dtype] * 2 + [torch.int32] * (
        len(outs) - 2)
    assert all(o.shape == h.shape for o in outs)
    if extra is None:
        extra = GM.max_slice(b, n, c, h.element_size(), k, 132, winners)
        assert extra[0] > 0
    pointers = 3 + len(outs)
    assert [(name, len(args), args[pointers:]) for name, args in calls] == [
        (body + launched, pointers + 4 + len(extra), (b, n, c, k) + extra)]


@pytest.mark.parametrize("n,cs,launched,extra", [
    (1024, None, "", (64,)),           # route by shape: one product a row
    (10038, None, "", (8,)),           # the largest cloud at C_in = 128
    (10039, None, "_kfold", ()),       # above the limit: K-fold
    (1024, 0, "_kfold", ()),           # forced K-fold
    (1024, 16, "", (16,)),             # a given slice is passed on
])
def test_matmul_minmax_wrapper_launches_the_route(monkeypatch, n, cs,
                                                  launched, extra):
    """``gather_matmul_minmax``'s one launch on CUDA tensors (recorded in
    place of the launch; meta tensors, no card): the one-product-a-row
    kernel ``gather_matmul_minmax`` with ``mm_slice``'s slice last, up to
    10,038 points at C_in = 128, or the K-fold kernel
    ``gather_matmul_minmax_kfold`` without it; two bf16 outputs."""
    calls = []
    monkeypatch.setattr(GM._lib, "launch",
                        lambda kernel, device, *args: calls.append(
                            (kernel, args)))
    monkeypatch.setattr(GM._lib, "check_inputs",
                        lambda name, specs: torch.device("meta"))
    monkeypatch.setattr(GM, "_sm_count", lambda index: 132)
    b, c_in, c_out, k = 32 if n == 1024 else 1, 128, 256, 20
    x = torch.empty((b, n, c_in), dtype=torch.bfloat16, device="meta")
    w = torch.empty((c_in, c_out), dtype=torch.bfloat16, device="meta")
    idx = torch.empty((b, n, k), dtype=torch.int32, device="meta")
    mask = torch.empty((b, n, k), dtype=torch.bool, device="meta")
    mx, mn = GM._gather_matmul_minmax(x, w, idx, mask, cs)
    assert mx.shape == mn.shape == (b, n, c_out)
    assert mx.dtype == mn.dtype == torch.bfloat16
    assert [(name, args[6:]) for name, args in calls] == [
        ("gather_matmul_minmax" + launched,
         (b, n, c_in, c_out, k) + extra)]


# -- the winner-routed backward: route S (shared f64 sums) or route D ------


@pytest.mark.parametrize("n_out,c,want", [
    (1024, 64, (8, 1024)),    # the cls steps, conv0/conv1: one range
    (1024, 256, (8, 1024)),   # conv3
    (2048, 128, (8, 2048)),   # the seg steps
    (3632, 64, (8, 3632)),    # the most rows of 8 channels
    (3633, 64, (4, 3633)),    # above: 4 channels, one range
    (8192, 256, (4, 4096)),   # the large-cloud steps: two ranges
    (14528, 64, (4, 7264)),   # the most rows of two ranges
    (14529, 64, (0, 0)),      # above: route D
    (65536, 64, (0, 0)),      # a point-shard table
    (150, 3, (4, 150)),       # 3 channels: the narrowest slice
    (150, 5, (8, 150)),
    (0, 64, (0, 0)),          # nothing to write
])
def test_bwd_slice_routes(n_out, c, want):
    """``bwd_slice``: route S's slice (channels) and rows a block at the
    model shapes, each block within SMEM_MAX; route D beyond
    BWD_MAX_RANGES ranges of rows."""
    got = GM.bwd_slice(n_out, c)
    assert got == want
    if got[0]:
        assert GM.bwd_smem(got[1], got[0]) <= GM.SMEM_MAX
        assert got[0] in GM.BWD_SLICES


@pytest.mark.parametrize("seed", range(4))
def test_bwd_slice_rules_hold(seed):
    """On random shapes: BWD_SLICE channels (4 for features of at most 4)
    over one range of all rows where that block fits SMEM_MAX; else 4
    channels over the fewest equal ranges that fit, each block within
    SMEM_MAX and the ranges covering every row; route D only beyond
    BWD_MAX_RANGES ranges."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        n_out = int(rng.integers(1, 20000))
        c = int(rng.integers(1, 600))
        cs, rows = GM.bwd_slice(n_out, c)
        first = GM.BWD_SLICE if c > GM.BWD_SLICE // 2 else 4
        if GM.bwd_smem(n_out, first) <= GM.SMEM_MAX:
            assert (cs, rows) == (first, n_out)
            continue
        ranges = -(-n_out // (GM.SMEM_MAX // GM.bwd_smem(1, 4)))
        if ranges > GM.BWD_MAX_RANGES:
            assert (cs, rows) == (0, 0)
            continue
        assert cs == 4 and GM.bwd_smem(rows, cs) <= GM.SMEM_MAX
        assert -(-n_out // rows) == ranges
        if ranges > 1:  # no fewer ranges would fit
            assert GM.bwd_smem(-(-n_out // (ranges - 1)), cs) > GM.SMEM_MAX


def test_bwd_smem_counts_the_cuda_block():
    """``bwd_smem`` is the CUDA source's ``bwd_smem_bytes`` (rows x Cs
    f64 sums), the slices are those the launcher takes, and its limit is
    SMEM_MAX: the expressions read from ``csrc/gather_max.cu`` and
    ``csrc/gather_matmul_max_rows.cuh``."""
    import re
    from pathlib import Path

    csrc = Path(GM.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "gather_max.cu").read_text()
    body = re.search(r"inline size_t bwd_smem_bytes\(int rows, int CS\) "
                     r"\{\s*return ([^;]+);", src).group(1)
    expr = body.replace("(size_t)", "").replace("sizeof(double)", "8")
    for rows, cs in ((1024, 8), (2048, 4), (150, 32), (2421, 4)):
        assert eval(expr, {"rows": rows, "CS": cs}) == GM.bwd_smem(rows, cs)
    taken = re.search(r"if \(\(Cs != (\d+) && Cs != (\d+) && Cs != (\d+) "
                      r"&& Cs != (\d+)\) \|\| rows < 1", src)
    assert sorted(int(v) for v in taken.groups()) == sorted(GM.BWD_SLICES)
    rows_src = (csrc / "gather_matmul_max_rows.cuh").read_text()
    limit = re.search(r"kRowsSmemMax = (\d+);", rows_src).group(1)
    assert int(limit) == GM.SMEM_MAX


# -- the plain versions against the JAX package ----------------------------


def _bf16(a):
    """numpy f32 -> (jnp bf16, torch bf16) of the same bf16 values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _bf16_ulps(a, b):
    def ordered(x):
        u = torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16).view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

    return (ordered(a) - ordered(b)).abs()


def _graph(rng, b, n, k):
    """Random neighbours (self in slot 0, 20% masked); no valid slot on
    point 3 of the first cloud and on the last point of every cloud."""
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[:, :, 0] = np.arange(n)
    mask = rng.random((b, n, k)) > 0.2
    mask[:, :, 0] = True
    mask[0, 3] = False
    mask[:, -1] = False
    return idx, mask


def _inputs(rng, kind, b, n, c_in, c_out):
    if kind == "exact":  # products and sums exact in f32 in any order
        x = rng.integers(-32, 33, (b, n, c_in)) / 8.0
        w = rng.integers(-16, 17, (c_in, c_out)) / 16.0
    else:
        x = rng.standard_normal((b, n, c_in))
        w = rng.standard_normal((c_in, c_out)) / 4
    return _bf16(x.astype(np.float32)) + _bf16(w.astype(np.float32))


def _affine(rng, c):
    inv = rng.standard_normal(c).astype(np.float32)
    return [np.where(inv >= 0, 1.0, -1.0).astype(np.float32), inv,
            rng.standard_normal(c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32)]


@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("n", [150, 1000])
def test_gather_matmul_max_plain_matches_jax(n, affine, kind):
    """``gather_matmul_max_plain`` against JAX ``gather_matmul_max``
    (Pallas, interpret mode) at N not a multiple of the kernels' 64-row
    tiles (nor of the Pallas tile), C_out = 40: bit-equal on exact sums
    without the epilogue, within one bf16 ulp on 1e-3 of the elements
    with it (FMA contraction on the JAX side), within one bf16 ulp on
    random inputs (one ulp of the max through the affine with it); rows
    with no valid neighbour -3e38, or 0 after the epilogue."""
    rng = np.random.default_rng(20 + n + affine)
    b, k, c_in, c_out = 2, 7, 32, 40
    idx, mask = _graph(rng, b, n, k)
    aff = _affine(rng, c_out)
    x_j, x, w_j, w = _inputs(rng, kind, b, n, c_in, c_out)
    want = np.asarray(jax_mm_max(
        x_j, w_j, jnp.asarray(idx), jnp.asarray(mask), interpret=True,
        self_slot0=True,
        affine=tuple(map(jnp.asarray, aff)) if affine else None),
        np.float32)
    got = ops.gather_matmul_max_plain(
        x, w, torch.from_numpy(idx), torch.from_numpy(mask),
        tuple(map(torch.from_numpy, aff)) if affine else None)
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, c_out)
    ulps = _bf16_ulps(got.float().numpy(), want)
    if kind == "exact" and not affine:
        np.testing.assert_array_equal(got.float().numpy(), want)
    elif kind == "exact" or not affine:
        assert int(ulps.max()) <= 1
        if affine:
            assert float((ulps > 0).float().mean()) <= 1e-3
    else:
        tol = 2.0 ** -7 * np.abs(aff[1]).max() * np.abs(want).max() + 2.0 ** -7
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol)
    empty = got[0, 3].float(), got[:, -1].float()
    for rows in empty:
        if affine:
            assert not rows.any()
        else:
            assert bool((rows == NEG_BF16).all())


@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("n", [150, 1000])
def test_gather_matmul_max_win_plain_matches_jax(n, kind):
    """``gather_matmul_max_win_plain`` against the JAX train form's
    forward (``_mm_train_reference_fwd``: the bf16 product, then the
    first-winner max) at ragged N and C_out = 40: values and winners
    bit-equal on exact sums; on random inputs values within one bf16 ulp
    and winners equal wherever the values are; rows with no valid
    neighbour -3e38 with winner 0."""
    rng = np.random.default_rng(30 + n)
    b, k, c_in, c_out = 2, 7, 32, 40
    idx, mask = _graph(rng, b, n, k)
    x_j, x, w_j, w = _inputs(rng, kind, b, n, c_in, c_out)
    want, want_win = _mm_train_reference_fwd(x_j, w_j, jnp.asarray(idx),
                                             jnp.asarray(mask))
    want = np.asarray(want, np.float32)
    want_win = np.asarray(want_win)
    out, win = ops.gather_matmul_max_win_plain(
        x, w, torch.from_numpy(idx), torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16 and win.dtype == torch.int32
    same = out.float().numpy() == want
    if kind == "exact":
        assert bool(same.all())
        np.testing.assert_array_equal(win.numpy(), want_win)
    else:
        assert int(_bf16_ulps(out.float().numpy(), want).max()) <= 1
        np.testing.assert_array_equal(win.numpy()[same], want_win[same])
    for rows, wins in ((out[0, 3], win[0, 3]), (out[:, -1], win[:, -1])):
        assert bool((rows.float() == NEG_BF16).all())
        assert not wins.any()
