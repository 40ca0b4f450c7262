"""Masked neighbour max with single-winner gradients, the bf16 eval
maxes with the BatchNorm + LeakyReLU epilogue, and the differentiable
bf16 gather-then-matmul max of training (CUDA kernels + plain versions).

``gather_max(h, idx, mask)``: ``[B, N, C], [B, N, K], [B, N, K] ->
[B, N, C]``, f32 or bf16 (the output keeps ``h``'s dtype), the max over
valid slots of the gathered neighbour rows; rows with no valid neighbour
give ``-3e38``. :func:`masked_nbr_max`
turns those into 0, as the scalar-stream aggregation of every DeltaConv
needs. Counterpart of ``deltaconv_tpu/ops/gather_max.py``
(``gather_max`` and its custom VJP, ``masked_nbr_max``); the kernels are
in ``csrc/gather_max.cu``: on CUDA tensors route S (a cloud's channel
slice staged in shared memory, the max out of it) where
:func:`max_slice` finds a slice that fits a block (up to 14,526 points),
else route D (the ``_direct`` kernels, every slot's row from L2); the
same bits.

Differentiated (``h.requires_grad`` under grad mode), the max is an
autograd Function: its forward also records, per output element, the
FIRST slot that holds the maximum, and its backward routes the whole
cotangent to that one neighbour row. This is the JAX package's VJP;
torch's own ``amax`` backward splits ties evenly and would differ on
every tie. The backward accumulates in f32 and casts ``dh`` to ``h``'s
dtype, as the JAX VJP does (a bf16 cotangent is read as it is:
``gather_max_win_bf16`` and ``gather_max_bwd_bf16`` are the bf16
bodies; on CUDA tensors the backward's route S sums a cloud's slice of
destination rows in shared memory, where :func:`bwd_slice` finds one that
fits, else route D, ``_direct``, atomics into a global f64 scratch; the
same bits). Otherwise the forward runs without winner tracking, as JAX's
primal path does (``gather_max``, or its bf16 body ``gather_max_bf16``).
:func:`gather_max` runs the kernels, :func:`gather_max_plain` the plain
versions, with the same routing.

The neighbour max AND min of the ``NeighborAggregations`` hooks
(``nbr_minmax``, ``nbr_matmul_minmax``; counterparts of the JAX module's
``gather_minmax`` and ``gather_matmul_minmax``):

- :func:`gather_minmax` ``(h, idx, mask) -> (mx, mn)``, ``[B, N, C]``
  each in ``h``'s dtype (f32 or bf16), compared in f32;
  rows with no valid neighbour give ``(-3e38, +3e38)``. Differentiated,
  it is an autograd Function whose forward also records the FIRST
  winning slot of the max (strict ``>``) and of the min (strict ``<``)
  (``gather_minmax_win``), and whose backward adds both cotangents at
  their winners' rows into one f32 ``dh`` (``gather_minmax_bwd``, one
  launch for both maps), cast to ``h``'s dtype. A row with no valid
  neighbour keeps winner 0, so its cotangents go to ``idx[..., 0]``'s
  row, as JAX's. Otherwise ``gather_minmax`` runs without winners.
  Kernels in ``csrc/gather_max.cu`` (``_bf16`` bodies for bf16), on the
  neighbour max's two routes (:func:`max_slice`): route S, the staged
  kernel in its min/max mode (a running min beside the max, a masked slot
  skipped by its row id), and route D above 14,526 points (the ``_direct``
  kernels); the same bits.
- :func:`gather_matmul_minmax` ``(x [B, N, C_in] bf16, w [C_in, C_out]
  bf16, idx, mask) -> (mx, mn)`` ``[B, N, C_out]`` bf16: the masked max
  and min of ``x[idx_k] @ w`` (f32 accumulation), rounded to bf16;
  forward only (JAX's has no VJP), so it raises on a tensor that
  requires grad. The kernel is the one-product-a-row kernel of
  ``csrc/gather_matmul_max_rows.cuh`` in its min/max mode, routed by
  :func:`mm_slice` as :func:`gather_matmul_max`: above its size the
  WMMA K-fold kernel of ``csrc/gather_matmul_max.cuh``
  (``gather_matmul_minmax_kfold``).

The bf16 eval maxes (``csrc/gather_max_bf16.cu``), counterparts of
``gather_max_affine`` and ``gather_matmul_max`` of the JAX module, take
``affine = (sign, inv, mean, bias)``, four ``[C]`` f32 vectors, and end
in :func:`bn_lrelu_epilogue`:

- :func:`gather_max_affine` ``(h [B, N, C] bf16, idx, mask, affine,
  sub_self) -> [B, N, C] bf16``: the masked max of the neighbour rows;
  with ``sub_self`` (the centralized first conv) the self row
  ``h[idx[..., 0]]`` is subtracted inside the sign fold. On CUDA tensors
  the neighbour max's two routes (:func:`max_slice`): route S with the
  epilogue (the self row read from the slice), route D
  ``gather_max_affine_direct``; the same bits.
- :func:`gather_matmul_max` ``(x [B, N, C_in] bf16, w [C_in, C_out]
  bf16, idx, mask, affine=None) -> [B, N, C_out] bf16``: the masked max
  of ``x[idx_k] @ w`` (f32 accumulation); without ``affine`` the max
  rounded to bf16, ``-3e38`` on rows with no valid neighbour.

Both are forward-only (eval). The plain matmul max multiplies per point
(``x @ w`` in f32, then the gather), which sums the products in another
order than the kernel: the two agree to one bf16 ulp. On CUDA tensors
the matmul maxes, eval and train, run one product a row (the kernels of
``csrc/gather_matmul_max_rows.cuh``: a cloud's slice of ``x @ w`` in
shared memory, then the max out of it) up to the size :func:`mm_slice`
allows (10,038 points at C_in = 128), and above it the K-fold kernels
(``_kfold``, a product a gathered slot).

:func:`gather_matmul_max_train` ``(x [B, N, C_in] bf16, w [C_in, C_out]
bf16, idx, mask) -> [B, N, C_out] bf16`` is the training twin of
``gather_matmul_max`` (JAX ``gather_matmul_max_train``): the forward
(``gather_matmul_max_win``) rounds each slot's f32 product to bf16 before
the max and records the first winning slot, so values and winners are
those of the per-point bf16 product followed by the neighbour max; the
backward routes the cotangent to the winning rows at ``C_out``
(``gather_max_bwd``), rounds it to bf16, and forms ``dx = dy @ w^T`` and
``dw = x^T dy`` with f32 accumulation, cast to ``x``'s and ``w``'s dtypes
(``_gmm_train_bwd``). Rows with no valid neighbour give ``-3e38``.

The int8 serving form's maxes (``csrc/gather_max_int8.cu``, forward only),
counterparts of the JAX module's int8 functions: :func:`int8_quantize`
quantizes symmetrically per cloud (torch ops, XLA in JAX);
:func:`gather_max_int8` ``(h [B, N, C] f32 or bf16, idx, mask) -> [B, N,
C]`` in ``h``'s dtype is the masked max of the quantized rows, times the
cloud's scale, 0 on rows with no valid neighbour (max commutes with the
positive scale); on CUDA tensors route S maxes first and quantizes the
max (the quantization is monotone, so the two orders agree exactly): the
``absmax`` kernel (:func:`absmax`), then neighbour max's route S with a
quantizing epilogue; route D (``gather_max_int8_direct``, where
:func:`max_slice` finds no slice) quantizes first in torch ops;
:func:`gather_matmul_max_int8` ``(xq [B, N, C_in] int8,
w [C_in, C_out] bf16, idx, mask) -> [B, N, C_out] bf16`` is the masked max
of ``xq[idx_k] @ w`` (f32 accumulation), ``-3e38`` on rows with no valid
neighbour, which the caller dequantizes.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from . import _lib

__all__ = ["BWD_SLICE", "BWD_SLICES", "MAX_ROW_BYTES",
           "MM_SLICES", "NEG", "SMEM_MAX", "absmax", "absmax_plain",
           "bn_lrelu_epilogue",
           "bwd_slice", "bwd_smem", "gather_matmul_max",
           "gather_matmul_max_int8", "gather_matmul_max_int8_plain",
           "gather_matmul_max_plain", "gather_matmul_max_train",
           "gather_matmul_max_train_plain", "gather_matmul_max_win",
           "gather_matmul_max_win_plain", "gather_matmul_minmax",
           "gather_matmul_minmax_plain", "gather_max", "gather_max_affine",
           "gather_max_affine_plain", "gather_max_bwd",
           "gather_max_bwd_plain", "gather_max_int8", "gather_max_int8_plain",
           "gather_max_plain", "gather_max_win", "gather_max_win_plain",
           "gather_minmax", "gather_minmax_bwd", "gather_minmax_bwd_plain",
           "gather_minmax_plain", "gather_minmax_win",
           "gather_minmax_win_plain", "int8_quantize", "masked_nbr_max",
           "max_slice", "max_smem", "mm_rows_smem", "mm_slice"]

NEG = -3.0e38  # ~ -inf in f32, safe to negate and compare
_I8_NEG = -(2 ** 30)  # "-inf" in the int32 quantized domain


def _masked_rows(h, idx, mask, neg=NEG):
    """``[B, N, K, C]`` gathered neighbour rows, ``neg`` where masked."""
    b, n, c = h.shape
    k = idx.shape[-1]
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    g = torch.gather(h, 1, flat).reshape(b, n, k, c)
    return torch.where(mask[..., None], g, neg)


def _max_plain(h, idx, mask):
    """Plain forward without winners: gather, then a masked ``amax``."""
    return _masked_rows(h, idx, mask).amax(dim=2)


def gather_max_win_plain(h, idx, mask):
    """Plain forward with winners: the masked ``amax``, then the first
    slot equal to it (``argmax`` returns the first maximal index)."""
    vals = _masked_rows(h, idx, mask)
    out = vals.amax(dim=2)
    first = (vals == out[:, :, None]).to(torch.uint8).argmax(dim=2)
    return out, first.to(torch.int32)


def _route_f64(acc, idx, winner, g):
    """Adds each cotangent at its winner's row of the f64 ``acc``: resolve
    the winner slot to its neighbour with ``idx.gather``, then
    ``scatter_add_``."""
    src = torch.gather(idx.long(), 2, winner.long())  # [B, N, C]
    return acc.scatter_add_(1, src, g.double())


def gather_max_bwd_plain(idx, winner, g, n_out: int):
    """Plain backward: the cotangents routed to their winners' rows and
    summed in f64, then rounded once to f32, as the kernel does (the sum
    of one row and channel is exact in f64 unless its addends span more
    than 29 binary orders, so the result is the same in any order)."""
    b, _, c = g.shape
    acc = torch.zeros((b, n_out, c), dtype=torch.float64, device=g.device)
    return _route_f64(acc, idx, winner, g).float()


def _extremes(h, idx, mask):
    """``(vmax, vmin, mx, mn)``: the gathered rows in f32, ``-3e38`` (for
    the max) or ``+3e38`` (for the min) where masked, and their masked
    max and min over the slots, in f32."""
    vmax = _masked_rows(h.float(), idx, mask)
    vmin = torch.where(mask[..., None], vmax, -NEG)
    return vmax, vmin, vmax.amax(dim=2), vmin.amin(dim=2)


def _minmax_plain(h, idx, mask):
    """Plain forward without winners: gather, masked ``amax`` and
    ``amin`` in f32, cast to ``h``'s dtype (lossless for bf16)."""
    _, _, mx, mn = _extremes(h, idx, mask)
    return mx.to(h.dtype), mn.to(h.dtype)


def gather_minmax_win_plain(h, idx, mask):
    """Plain forward with winners ``(mx, mn, wmx, wmn)``: the masked
    ``amax``/``amin`` in f32, then the first slot equal to each (JAX's
    ``_reference_minmax``: first-index ``argmax``/``argmin``, so a row
    with no valid neighbour gets winner 0); bf16 in, bf16 out."""
    vmax, vmin, mx, mn = _extremes(h, idx, mask)
    wmx = (vmax == mx[:, :, None]).to(torch.uint8).argmax(dim=2)
    wmn = (vmin == mn[:, :, None]).to(torch.uint8).argmax(dim=2)
    return (mx.to(h.dtype), mn.to(h.dtype), wmx.to(torch.int32),
            wmn.to(torch.int32))


def gather_minmax_bwd_plain(idx, wmx, gmx, wmn, gmn, n_out: int):
    """Plain backward: both cotangents routed to their winners' rows
    (JAX's ``_route_cotangent`` twice), summed in one f64 accumulator and
    rounded once to f32, as the kernel does."""
    b, _, c = gmx.shape
    acc = torch.zeros((b, n_out, c), dtype=torch.float64, device=gmx.device)
    _route_f64(acc, idx, wmx, gmx)
    return _route_f64(acc, idx, wmn, gmn).float()


def _body(name, t):
    """The kernel of ``name`` for ``t``'s dtype, and that dtype: the f32
    body, or the ``_bf16`` one for bf16 (any other dtype is refused by
    the f32 body's check)."""
    if t.dtype == torch.bfloat16:
        return f"{name}_bf16", torch.bfloat16
    return name, torch.float32


def _check_fwd(name, h, idx, mask, dtype=torch.float32):
    b, n, c = h.shape
    k = idx.shape[-1]
    return _lib.check_inputs(name, [
        ("h", h, dtype, (b, n, c)),
        ("idx", idx, torch.int32, (b, n, k)),
        ("mask", mask, torch.bool, (b, n, k)),
    ])


SMEM_MAX = 232_448  # a block's shared memory on the H100

# Route S of the neighbour max (csrc/gather_max.cu): a block stages a
# cloud's slice of h, N + 2 rows of 16, 32, 64 or 128 bytes, in shared
# memory; a task's points are split over blocks of at least this many
# points each where the tasks are fewer than the SMs.
MAX_ROW_BYTES = (128, 64, 32, 16)
MAX_SPLIT_POINTS = 128


def max_smem(n: int, row_bytes: int) -> int:
    """Shared memory of one route-S block, as ``staged_smem_bytes`` in
    the CUDA source counts it: the slice's ``n`` rows and its two constant
    rows (zeros, -inf)."""
    return (n + 2) * row_bytes


@functools.lru_cache(maxsize=1024)
def max_slice(b: int, n: int, c: int, itemsize: int, k: int, sms: int,
              winners: bool = False) -> tuple[int, int]:
    """The route of the neighbour max for ``[b, n, c]`` features of
    ``itemsize`` bytes (f32 4, bf16 2) and ``k`` slots on a card of
    ``sms`` SMs: ``(cs, splits)``, route S's slice of ``cs`` channels and
    the blocks a task's points are split over, or ``(0, 0)`` for route D
    (a route by shape, not a fallback). The slice's row is the widest of
    128, 64, 32, 16 bytes whose block fits SMEM_MAX and that one narrower
    row would not cover whole; where the tasks (``b`` x slices) are fewer
    than the SMs, ``splits`` fills one wave (at most one block per
    MAX_SPLIT_POINTS points). On the H100 splitting a task beat narrowing
    its slice at every model shape (PERF.md, section 6). Route D where no
    slice fits (above 14,526 points), ``k`` is 0, or the bf16 winners' 16
    bits do not hold ``k``. Cached: the wrappers ask at every call."""
    need = c * itemsize
    fits = [rb for rb in MAX_ROW_BYTES
            if max_smem(n, rb) <= SMEM_MAX
            and (rb == 16 or rb // 2 < need)]
    if (not fits or k <= 0 or c <= 0
            or (winners and itemsize == 2 and k > 0xFFFF)):
        return 0, 0
    tasks = b * -(-need // fits[0])
    splits = max(1, min(sms // tasks, -(-n // MAX_SPLIT_POINTS)))
    return fits[0] // itemsize, splits


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _max_launch(name, device, args, h, k, route, winners, tail=()):
    """Launches route S of ``name`` (``route = (cs, splits)``) or, with
    ``cs`` 0, route D, ``name_direct``; ``route`` None:
    :func:`max_slice`. ``tail``: both routes' last arguments."""
    b, n, c = h.shape
    if route is None:
        route = max_slice(b, n, c, h.element_size(), k,
                          _sm_count(device.index or 0), winners)
    cs, splits = route
    if cs:
        _lib.launch(name, device, *args, b, n, c, k, cs, splits, *tail)
    else:
        _lib.launch(f"{name}_direct", device, *args, b, n, c, k, *tail)


def _max(h, idx, mask, route=None):
    """The forward without winners: plain version for CPU tensors, the
    ``gather_max`` kernel (f32) or ``gather_max_bf16`` (bf16 in, bf16
    out) for CUDA tensors, on the route :func:`max_slice` picks (route
    S; route D under the ``_direct`` names); ``route`` forces one."""
    if h.device.type == "cpu":
        return _max_plain(h, idx, mask)
    name, dtype = _body("gather_max", h)
    device = _check_fwd(name, h, idx, mask, dtype)
    out = torch.empty_like(h)
    _max_launch(name, device, (h.data_ptr(), idx.data_ptr(),
                               mask.data_ptr(), out.data_ptr()), h,
                idx.shape[-1], route, False)
    return out


def gather_max_win(h, idx, mask):
    """The forward with winners ``(out, winner [B, N, C] int32)``: plain
    version for CPU tensors, the ``gather_max_win`` kernel (f32) or
    ``gather_max_win_bf16`` (bf16 in, bf16 out) for CUDA tensors, routed
    as :func:`gather_max`."""
    if h.device.type == "cpu":
        return gather_max_win_plain(h, idx, mask)
    return _gather_max_win(h, idx, mask)


def _gather_max_win(h, idx, mask, route=None):
    """:func:`gather_max_win` on CUDA tensors through ``route`` (``(cs,
    splits)``; ``(0, 0)`` route D; None: by shape)."""
    name, dtype = _body("gather_max_win", h)
    device = _check_fwd(name, h, idx, mask, dtype)
    b, n, c = h.shape
    out = torch.empty_like(h)
    winner = torch.empty((b, n, c), dtype=torch.int32, device=device)
    _max_launch(name, device, (h.data_ptr(), idx.data_ptr(),
                               mask.data_ptr(), out.data_ptr(),
                               winner.data_ptr()), h, idx.shape[-1], route,
                True)
    return out, winner


def _bwd_buffers(b, n_out, c, device):
    """The backward's f32 output and its f64 accumulator (scratch, which
    the kernel zero-fills)."""
    return (torch.empty((b, n_out, c), dtype=torch.float32, device=device),
            torch.empty((b, n_out, c), dtype=torch.float64, device=device))


# Route S of the winner-routed backward (csrc/gather_max.cu): a block keeps
# the f64 sums of a range of destination rows over a slice of Cs channels
# in shared memory, rows x Cs x 8 bytes, and walks every point of its
# cloud over the slice. The kernel takes slices of BWD_SLICES channels;
# the chooser takes BWD_SLICE, and 4 where the features have no more.
BWD_SLICES = (32, 16, 8, 4)
BWD_SLICE = 8
BWD_MAX_RANGES = 2  # row ranges a slice may be cut into; route D above


def bwd_smem(rows: int, cs: int) -> int:
    """Shared memory of one route-S backward block, as ``bwd_smem_bytes``
    in the CUDA source counts it: ``rows`` x ``cs`` f64 sums."""
    return rows * cs * 8


@functools.lru_cache(maxsize=1024)
def bwd_slice(n_out: int, c: int) -> tuple[int, int]:
    """The route of the winner-routed backward into ``[B, n_out, c]``:
    ``(cs, rows)``, route S's slice of ``cs`` channels and the destination
    rows a block sums, or ``(0, 0)`` for route D (a route by shape, not a
    fallback). A slice of BWD_SLICE channels (4 where ``c`` is at most 4)
    over all ``n_out`` rows where that block fits SMEM_MAX (up to 3,632
    rows), else 4 channels over the fewest equal ranges that fit (7,264
    rows a block), up to BWD_MAX_RANGES of them (14,528 rows); route D
    above, or where nothing is written. On the H100 these won at every
    model shape, f32 and bf16 cotangents alike, and route S lost to route
    D from four ranges on (PERF.md, section 6). Cached: the wrappers ask
    at every call."""
    if n_out <= 0 or c <= 0:
        return 0, 0
    cs = BWD_SLICE if c > BWD_SLICE // 2 else BWD_SLICE // 2
    if bwd_smem(n_out, cs) <= SMEM_MAX:
        return cs, n_out
    cs = BWD_SLICES[-1]
    ranges = -(-n_out // (SMEM_MAX // bwd_smem(1, cs)))
    if ranges > BWD_MAX_RANGES:
        return 0, 0
    return cs, -(-n_out // ranges)


def _bwd_launch(name, device, args, dh, b, n, c, k, n_out, route):
    """Launches route S of the backward ``name`` into ``dh`` (``route =
    (cs, rows)``) or, with ``cs`` 0, route D, ``name_direct``, through an
    f64 scratch; ``route`` None: :func:`bwd_slice`."""
    cs, rows = bwd_slice(n_out, c) if route is None else route
    if cs:
        _lib.launch(name, device, *args, dh.data_ptr(), b, n, c, k, n_out,
                    cs, rows)
    else:
        acc = torch.empty((b, n_out, c), dtype=torch.float64,
                          device=dh.device)
        _lib.launch(f"{name}_direct", device, *args, dh.data_ptr(),
                    acc.data_ptr(), b, n, c, k, n_out)


def gather_max_bwd(idx, winner, g, n_out: int):
    """The winner-routed backward ``dh [B, n_out, C]`` f32, summed in f64
    and rounded once (the same bits in any order of the adds): plain
    version for CPU tensors, the ``gather_max_bwd`` kernel (f32 ``g``) or
    ``gather_max_bwd_bf16`` (bf16 ``g``) for CUDA tensors, on the route
    :func:`bwd_slice` picks (route S; route D under the ``_direct``
    names)."""
    if g.device.type == "cpu":
        return gather_max_bwd_plain(idx, winner, g, n_out)
    return _gather_max_bwd(idx, winner, g, n_out)


def _gather_max_bwd(idx, winner, g, n_out, route=None):
    """:func:`gather_max_bwd` on CUDA tensors through ``route`` (``(cs,
    rows)``; ``(0, 0)`` route D; None: by shape)."""
    b, n, c = g.shape
    k = idx.shape[-1]
    name, dtype = _body("gather_max_bwd", g)
    device = _lib.check_inputs(name, [
        ("idx", idx, torch.int32, (b, n, k)),
        ("winner", winner, torch.int32, (b, n, c)),
        ("g", g, dtype, (b, n, c)),
    ])
    dh = torch.empty((b, n_out, c), dtype=torch.float32, device=device)
    _bwd_launch(name, device, (idx.data_ptr(), winner.data_ptr(),
                               g.data_ptr()), dh, b, n, c, k, n_out, route)
    return dh


def _minmax(h, idx, mask, route=None):
    """The min/max forward without winners: plain version for CPU
    tensors, the ``gather_minmax`` kernel (f32) or ``gather_minmax_bf16``
    (bf16 in, bf16 out) for CUDA tensors, on the route :func:`max_slice`
    picks (route S; route D under the ``_direct`` names); ``route``
    forces one."""
    if h.device.type == "cpu":
        return _minmax_plain(h, idx, mask)
    name, dtype = _body("gather_minmax", h)
    device = _check_fwd(name, h, idx, mask, dtype)
    mx, mn = torch.empty_like(h), torch.empty_like(h)
    _max_launch(name, device, (h.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                               mx.data_ptr(), mn.data_ptr()), h,
                idx.shape[-1], route, False)
    return mx, mn


def gather_minmax_win(h, idx, mask):
    """The min/max forward with winners ``(mx, mn, wmx [B, N, C] int32,
    wmn)``: plain version for CPU tensors, the ``gather_minmax_win``
    kernel (f32) or ``gather_minmax_win_bf16`` for CUDA tensors, routed
    as :func:`gather_minmax`."""
    if h.device.type == "cpu":
        return gather_minmax_win_plain(h, idx, mask)
    return _gather_minmax_win(h, idx, mask)


def _gather_minmax_win(h, idx, mask, route=None):
    """:func:`gather_minmax_win` on CUDA tensors through ``route`` (``(cs,
    splits)``; ``(0, 0)`` route D; None: by shape)."""
    name, dtype = _body("gather_minmax_win", h)
    device = _check_fwd(name, h, idx, mask, dtype)
    b, n, c = h.shape
    mx, mn = torch.empty_like(h), torch.empty_like(h)
    wmx, wmn = (torch.empty((b, n, c), dtype=torch.int32, device=device)
                for _ in range(2))
    _max_launch(name, device, (h.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                               mx.data_ptr(), mn.data_ptr(), wmx.data_ptr(),
                               wmn.data_ptr()), h, idx.shape[-1], route, True)
    return mx, mn, wmx, wmn


def gather_minmax_bwd(idx, wmx, gmx, wmn, gmn, n_out: int):
    """The two-map winner-routed backward ``dh [B, n_out, C]`` f32: plain
    version for CPU tensors, one launch of the ``gather_minmax_bwd``
    kernel (f32 cotangents) or ``gather_minmax_bwd_bf16`` (bf16) for
    CUDA tensors, routed as :func:`gather_max_bwd`."""
    if gmx.device.type == "cpu":
        return gather_minmax_bwd_plain(idx, wmx, gmx, wmn, gmn, n_out)
    return _gather_minmax_bwd(idx, wmx, gmx, wmn, gmn, n_out)


def _gather_minmax_bwd(idx, wmx, gmx, wmn, gmn, n_out, route=None):
    """:func:`gather_minmax_bwd` on CUDA tensors through ``route`` (as
    :func:`_gather_max_bwd`)."""
    b, n, c = gmx.shape
    k = idx.shape[-1]
    name, dtype = _body("gather_minmax_bwd", gmx)
    device = _lib.check_inputs(name, [
        ("idx", idx, torch.int32, (b, n, k)),
        ("wmx", wmx, torch.int32, (b, n, c)),
        ("gmx", gmx, dtype, (b, n, c)),
        ("wmn", wmn, torch.int32, (b, n, c)),
        ("gmn", gmn, dtype, (b, n, c)),
    ])
    dh = torch.empty((b, n_out, c), dtype=torch.float32, device=device)
    _bwd_launch(name, device, (idx.data_ptr(), wmx.data_ptr(),
                               gmx.data_ptr(), wmn.data_ptr(),
                               gmn.data_ptr()), dh, b, n, c, k, n_out, route)
    return dh


class _GatherMax(torch.autograd.Function):
    """Neighbour max with the single-winner VJP, gradient for ``h``
    only, cast to ``h``'s dtype. The raw functions get detached tensors:
    inside ``forward`` the inputs still carry ``requires_grad``."""

    @staticmethod
    def forward(ctx, h, idx, mask, route):
        out, winner = route.win(h.detach(), idx, mask)
        ctx.save_for_backward(idx, winner)
        ctx.route, ctx.n_out, ctx.dtype = route, h.shape[1], h.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        idx, winner = ctx.saved_tensors
        dh = ctx.route.bwd(idx, winner, g.contiguous(), ctx.n_out)
        return dh.to(ctx.dtype), None, None, None


def _differentiated(h) -> bool:
    return h.requires_grad and torch.is_grad_enabled()


def gather_max(h: torch.Tensor, idx: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Neighbour max through the kernels on CUDA tensors (the plain
    versions on CPU ones); differentiable in ``h``."""
    if _differentiated(h):
        return _GatherMax.apply(h, idx, mask, _KERNELS)
    return _max(h, idx, mask)


def gather_max_plain(h: torch.Tensor, idx: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """:func:`gather_max` through the plain versions on any device."""
    if _differentiated(h):
        return _GatherMax.apply(h, idx, mask, _PLAIN)
    return _max_plain(h, idx, mask)


class _GatherMinMax(torch.autograd.Function):
    """Neighbour max and min with JAX's ``gather_minmax`` VJP: each
    cotangent to its output's first winning neighbour, both summed into
    one f32 ``dh`` (one backward launch), cast to ``h``'s dtype."""

    @staticmethod
    def forward(ctx, h, idx, mask, route):
        mx, mn, wmx, wmn = route.minmax_win(h.detach(), idx, mask)
        ctx.save_for_backward(idx, wmx, wmn)
        ctx.route, ctx.n_out, ctx.dtype = route, h.shape[1], h.dtype
        return mx, mn

    @staticmethod
    def backward(ctx, gmx, gmn):
        idx, wmx, wmn = ctx.saved_tensors
        dh = ctx.route.minmax_bwd(idx, wmx, gmx.contiguous(), wmn,
                                  gmn.contiguous(), ctx.n_out)
        return dh.to(ctx.dtype), None, None, None


def gather_minmax(h: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor):
    """Neighbour ``(max, min)`` through the kernels on CUDA tensors (the
    plain versions on CPU ones); differentiable in ``h``."""
    if _differentiated(h):
        return _GatherMinMax.apply(h, idx, mask, _KERNELS)
    return _minmax(h, idx, mask)


def gather_minmax_plain(h: torch.Tensor, idx: torch.Tensor,
                        mask: torch.Tensor):
    """:func:`gather_minmax` through the plain versions on any device."""
    if _differentiated(h):
        return _GatherMinMax.apply(h, idx, mask, _PLAIN)
    return _minmax_plain(h, idx, mask)


def masked_nbr_max(h, nbr_idx, nbr_mask, gather_max_fn=gather_max):
    """:func:`gather_max` with all-masked rows (padded points) set to 0,
    whose cotangent is then 0. ``gather_max_fn`` selects the kernels or
    the plain versions."""
    out = gather_max_fn(h, nbr_idx, nbr_mask)
    return torch.where(nbr_mask.any(dim=-1, keepdim=True), out, 0.0)


# -- bf16 eval maxes with the BatchNorm + LeakyReLU epilogue ---------------


def bn_lrelu_epilogue(best, affine, valid, self_rows=None):
    """``_bn_lrelu_epilogue`` of the JAX module, op for op in f32:
    ``best`` (f32 max) rounded to bf16; with ``self_rows``, rows with no
    valid neighbour set to 0 and ``sign * (max - self)``, else ``sign *
    max``; ``(h - mean) * inv + bias``; LeakyReLU 0.2; 0 where not
    ``valid`` (``[B, N, 1]``). Returns bf16."""
    sign, inv, mean, bias = affine
    mxb = best.to(torch.bfloat16).float()
    if self_rows is not None:
        mxb = torch.where(valid, mxb, 0.0)
        h = sign * (mxb - self_rows)
    else:
        h = sign * mxb
    o = (h - mean) * inv + bias
    o = torch.where(o >= 0, o, 0.2 * o)
    return torch.where(valid, o, 0.0).to(torch.bfloat16)


def _affine_rows(affine, c):
    """``affine`` as a contiguous ``[4, C]`` f32 tensor."""
    aff = torch.stack([torch.as_tensor(a).float().reshape(c)
                       for a in affine])
    return aff.contiguous()


def _valid_rows(mask):
    return mask.any(dim=-1, keepdim=True)


def gather_max_affine_plain(h, idx, mask, affine, sub_self: bool = False):
    """Plain version: gather, masked ``amax`` in f32, the epilogue."""
    best = _masked_rows(h.float(), idx, mask).amax(dim=2)
    self_rows = None
    if sub_self:
        self_rows = _masked_rows(h.float(), idx[..., :1],
                                 torch.ones_like(mask[..., :1]))[:, :, 0]
    return bn_lrelu_epilogue(best, affine, _valid_rows(mask), self_rows)


def gather_max_affine(h, idx, mask, affine, sub_self: bool = False):
    """Plain version for CPU tensors; for CUDA tensors one launch, on the
    route :func:`max_slice` picks: route S, ``gather_max_affine`` (the
    neighbour max's staged route with the epilogue: the cloud's channel
    slice in shared memory, the self value from the slice at the point's
    slot-0 id), or
    route D, ``gather_max_affine_direct`` (the earlier kernel, every slot's
    row from L2), above 14,526 points or at K = 0. The same bits."""
    if h.device.type == "cpu":
        return gather_max_affine_plain(h, idx, mask, affine, sub_self)
    return _gather_max_affine(h, idx, mask, affine, sub_self)


def _gather_max_affine(h, idx, mask, affine, sub_self=False, route=None):
    """:func:`gather_max_affine` on CUDA tensors through ``route`` (``(cs,
    splits)``; ``(0, 0)`` route D; None: by shape)."""
    b, n, c = h.shape
    k = idx.shape[-1]
    aff = _affine_rows(affine, c).to(h.device)
    device = _lib.check_inputs("gather_max_affine", [
        ("h", h, torch.bfloat16, (b, n, c)),
        ("idx", idx, torch.int32, (b, n, k)),
        ("mask", mask, torch.bool, (b, n, k)),
        ("affine", aff, torch.float32, (4, c)),
    ])
    out = torch.empty_like(h)
    _max_launch("gather_max_affine", device,
                (h.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                 aff.data_ptr(), out.data_ptr()), h, k, route, False,
                tail=(int(sub_self),))
    return out


def gather_matmul_max_plain(x, w, idx, mask, affine=None):
    """Plain version: ``x @ w`` per point in f32 (bf16 products are exact
    in f32), then the masked max of the gathered rows and the epilogue,
    or the max rounded to bf16."""
    y = torch.matmul(x.float(), w.float())
    best = _masked_rows(y, idx, mask).amax(dim=2)
    if affine is None:
        return best.to(torch.bfloat16)
    return bn_lrelu_epilogue(best, affine, _valid_rows(mask))


def _pad_last(t, multiple):
    pad = -t.shape[-1] % multiple
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _mm_operands(name, x, w, idx, mask, x_dtype=torch.bfloat16):
    """Checks the matmul maxes' inputs (``x`` bf16, or int8 for the int8
    form); returns the device and ``x`` and ``w`` zero-padded to widths
    that are multiples of 16 (zero columns add nothing), aligned as the
    kernel's loads need."""
    b, n, c_in = x.shape
    c_out = w.shape[-1]
    k = idx.shape[-1]
    device = _lib.check_inputs(name, [
        ("x", x, x_dtype, (b, n, c_in)),
        ("w", w, torch.bfloat16, (c_in, c_out)),
        ("idx", idx, torch.int32, (b, n, k)),
        ("mask", mask, torch.bool, (b, n, k)),
    ])
    xp = _pad_last(x, 16)
    wp = _pad_last(_pad_last(w, 16).t(), 16).t().contiguous()
    for arg, t, align in (("x", xp, 16), ("w", wp, 32)):
        if t.data_ptr() % align:
            raise ValueError(f"{name}({arg}): the kernel's loads need "
                             f"{align}-byte aligned data")
    return device, xp, wp


# The one-product-a-row kernels (csrc/gather_matmul_max_rows.cuh): a block
# takes a cloud and a slice of Cs output columns and holds the slice of
# y = x @ w, [N, Cs] bf16, in shared memory beside its staging buffers.
MM_SLICES = (64, 32, 16, 8)


def mm_rows_smem(n: int, c_in: int, cs: int, itemsize: int = 2) -> int:
    """Shared memory of one block of the one-product-a-row kernels with
    the least ring (two stages), as ``rows_smem_bytes`` in the CUDA
    source counts it: the y slice and its two constant rows, the affine
    slice, the W slice (rows padded to an odd number of 16-byte chunks)
    and two stages of 128 x rows: bf16 (``itemsize`` 2) padded by 16
    bytes, or int8 (1) unpadded beside one padded bf16 tile that each
    stage is widened into."""
    ldw = cs + 8 if cs >= 16 else cs
    tile = 2 * 128 * (c_in + 8)
    ring = 2 * tile if itemsize == 2 else 2 * 128 * c_in + tile
    return 2 * (n + 2) * cs + 16 * cs + 2 * c_in * ldw + ring


@functools.lru_cache(maxsize=1024)
def mm_slice(b: int, n: int, c_in: int, c_out: int, k: int, sms: int,
             itemsize: int = 2) -> int:
    """The route of the matmul maxes for padded widths ``c_in``,
    ``c_out`` (multiples of 16) and x of ``itemsize`` bytes (bf16 2, int8
    1) on a card of ``sms`` SMs: the column slice Cs of the
    one-product-a-row kernels, or 0 for the K-fold kernels (a route by
    shape, not a fallback). Cs is the widest of 64, 32, 16, 8 that
    divides ``c_out`` and whose block fits SMEM_MAX, narrowed while twice
    the tasks (``b * c_out / Cs``) still fit one wave of ``sms``; 0 when
    no slice fits (above 10,038 points at C_in = 128 in bf16, 10,166 in
    int8) or ``k`` exceeds the kernels' 16-bit winner slots."""
    fits = [cs for cs in MM_SLICES if c_out % cs == 0
            and mm_rows_smem(n, c_in, cs, itemsize) <= SMEM_MAX]
    if not fits or not 0 < k <= 0xFFFF:
        return 0
    i = 0
    while i + 1 < len(fits) and b * (c_out // fits[i + 1]) <= sms:
        i += 1
    return fits[i]


def _mm_launch(name, device, args, b, n, c_in, c_out, k, cs, itemsize=2):
    """Launches ``name`` (column slice ``cs``) or, with ``cs`` 0, its
    K-fold route ``name_kfold``; ``cs`` None: :func:`mm_slice` for x of
    ``itemsize`` bytes."""
    if cs is None:
        cs = mm_slice(b, n, c_in, c_out, k, _sm_count(device.index or 0),
                      itemsize)
    if cs:
        _lib.launch(name, device, *args, b, n, c_in, c_out, k, cs)
    else:
        _lib.launch(f"{name}_kfold", device, *args, b, n, c_in, c_out, k)


def gather_matmul_max(x, w, idx, mask, affine=None):
    """Plain version for CPU tensors; for CUDA tensors the
    ``gather_matmul_max`` kernel (one product a row, the slice of ``x @
    w`` in shared memory), or above its size the K-fold kernel
    ``gather_matmul_max_kfold`` (:func:`mm_slice`). The kernels take
    widths that are multiples of 16: other widths are zero-padded here
    (zero columns add nothing) and the padded outputs dropped."""
    if x.device.type == "cpu":
        return gather_matmul_max_plain(x, w, idx, mask, affine)
    return _gather_matmul_max(x, w, idx, mask, affine)


def _gather_matmul_max(x, w, idx, mask, affine=None, cs=None):
    """:func:`gather_matmul_max` on CUDA tensors through the route of
    column slice ``cs`` (0: the K-fold kernel; None: by shape)."""
    b, n, _ = x.shape
    c_out = w.shape[-1]
    k = idx.shape[-1]
    device, xp, wp = _mm_operands("gather_matmul_max", x, w, idx, mask)
    aff = None
    if affine is not None:
        aff = _pad_last(_affine_rows(affine, c_out).to(device), 16)
    out = torch.empty((b, n, wp.shape[1]), dtype=torch.bfloat16,
                      device=device)
    _mm_launch("gather_matmul_max", device,
               (xp.data_ptr(), wp.data_ptr(), idx.data_ptr(),
                mask.data_ptr(), 0 if aff is None else aff.data_ptr(),
                out.data_ptr()), b, n, xp.shape[-1], wp.shape[1], k, cs)
    return out[..., :c_out].contiguous() if wp.shape[1] != c_out else out


def _forward_only(x, w):
    """JAX's ``gather_matmul_minmax`` has no VJP: refuse a tensor that
    requires grad, on every device."""
    for arg, t in (("x", x), ("w", w)):
        if t.requires_grad:
            raise ValueError(f"gather_matmul_minmax({arg}): "
                             f"{_lib.no_grad_reason('gather_matmul_minmax')}")


def gather_matmul_minmax_plain(x, w, idx, mask):
    """Plain version: ``x @ w`` per point in f32 (bf16 products are exact
    in f32), the masked max and min of the gathered rows, each rounded to
    bf16 (rounding is monotone, so this equals rounding first)."""
    _forward_only(x, w)
    y = torch.matmul(x.float(), w.float())
    mx, mn = _minmax_plain(y, idx, mask)
    return mx.to(torch.bfloat16), mn.to(torch.bfloat16)


def gather_matmul_minmax(x, w, idx, mask):
    """``(mx, mn)``: plain version for CPU tensors; for CUDA tensors the
    ``gather_matmul_minmax`` kernel (one product a row, the slice of ``x @
    w`` in shared memory, the max and the min out of it), or above its
    size the K-fold kernel ``gather_matmul_minmax_kfold``
    (:func:`mm_slice`), with the widths zero-padded to multiples of 16 as
    in :func:`gather_matmul_max`. Forward only."""
    if x.device.type == "cpu":
        return gather_matmul_minmax_plain(x, w, idx, mask)
    return _gather_matmul_minmax(x, w, idx, mask)


def _gather_matmul_minmax(x, w, idx, mask, cs=None):
    """:func:`gather_matmul_minmax` on CUDA tensors through the route of
    column slice ``cs`` (0: the K-fold kernel; None: by shape)."""
    device, xp, wp = _mm_operands("gather_matmul_minmax", x, w, idx, mask)
    b, n, _ = x.shape
    c_out = w.shape[-1]
    mx, mn = (torch.empty((b, n, wp.shape[1]), dtype=torch.bfloat16,
                          device=device) for _ in range(2))
    _mm_launch("gather_matmul_minmax", device,
               (xp.data_ptr(), wp.data_ptr(), idx.data_ptr(),
                mask.data_ptr(), mx.data_ptr(), mn.data_ptr()), b, n,
               xp.shape[-1], wp.shape[1], idx.shape[-1], cs)
    if wp.shape[1] != c_out:
        return mx[..., :c_out].contiguous(), mn[..., :c_out].contiguous()
    return mx, mn


# -- the differentiable bf16 gather-then-matmul max (training) -------------


def gather_matmul_max_win_plain(x, w, idx, mask):
    """Plain version: ``x @ w`` per point in f32 (bf16 products are exact
    in f32), rounded to bf16, then the masked max with winners."""
    y = torch.matmul(x.float(), w.float()).to(torch.bfloat16)
    return gather_max_win_plain(y, idx, mask)


def gather_matmul_max_win(x, w, idx, mask):
    """``(out [B, N, C_out] bf16, winner [B, N, C_out] int32)``: plain
    version for CPU tensors; for CUDA tensors the
    ``gather_matmul_max_win`` kernel, or above its size
    ``gather_matmul_max_win_kfold``, routed as in
    :func:`gather_matmul_max`, with the widths zero-padded to multiples
    of 16 (a padded column is never read back)."""
    if x.device.type == "cpu":
        return gather_matmul_max_win_plain(x, w, idx, mask)
    return _gather_matmul_max_win(x, w, idx, mask)


def _gather_matmul_max_win(x, w, idx, mask, cs=None):
    """:func:`gather_matmul_max_win` on CUDA tensors through the route of
    column slice ``cs`` (0: the K-fold kernel; None: by shape)."""
    device, xp, wp = _mm_operands("gather_matmul_max_win", x, w, idx, mask)
    b, n, _ = x.shape
    c_out = w.shape[-1]
    out = torch.empty((b, n, wp.shape[1]), dtype=torch.bfloat16,
                      device=device)
    winner = torch.empty((b, n, wp.shape[1]), dtype=torch.int32,
                         device=device)
    _mm_launch("gather_matmul_max_win", device,
               (xp.data_ptr(), wp.data_ptr(), idx.data_ptr(),
                mask.data_ptr(), out.data_ptr(), winner.data_ptr()), b, n,
               xp.shape[-1], wp.shape[1], idx.shape[-1], cs)
    if wp.shape[1] != c_out:
        return out[..., :c_out].contiguous(), winner[..., :c_out].contiguous()
    return out, winner


class _Route(NamedTuple):
    win: Callable
    bwd: Callable
    mm_win: Callable
    minmax_win: Callable
    minmax_bwd: Callable


_KERNELS = _Route(gather_max_win, gather_max_bwd, gather_matmul_max_win,
                  gather_minmax_win, gather_minmax_bwd)
_PLAIN = _Route(gather_max_win_plain, gather_max_bwd_plain,
                gather_matmul_max_win_plain, gather_minmax_win_plain,
                gather_minmax_bwd_plain)


class _GatherMatmulMax(torch.autograd.Function):
    """``max_k (x @ w)[idx_k]`` with the single-winner VJP of
    ``_gmm_train_bwd``: the cotangent scattered to the winning rows at
    ``C_out`` in f32, rounded to bf16 (``dyc``), then ``dx = dyc @ w^T``
    and ``dw = x^T dyc`` over all points, f32 accumulation of the exact
    bf16 products (as f32 products of bf16 values on every device), cast
    to ``x``'s and ``w``'s dtypes."""

    @staticmethod
    def forward(ctx, x, w, idx, mask, route):
        out, winner = route.mm_win(x.detach(), w.detach(), idx, mask)
        ctx.save_for_backward(x, w, idx, winner)
        ctx.route = route
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, idx, winner = ctx.saved_tensors
        dy = ctx.route.bwd(idx, winner, g.contiguous(), x.shape[1])
        dyc = dy.to(torch.bfloat16).float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dyc, w.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.float().flatten(0, 1).t(),
                              dyc.flatten(0, 1)).to(w.dtype)
        return dx, dw, None, None, None


def gather_matmul_max_train(x, w, idx, mask):
    """Differentiable bf16 ``max_k (x @ w)[idx_k]`` over valid slots
    through the kernels on CUDA tensors (plain versions on CPU ones);
    gradients for ``x`` and ``w``."""
    return _GatherMatmulMax.apply(x, w, idx, mask, _KERNELS)


def gather_matmul_max_train_plain(x, w, idx, mask):
    """:func:`gather_matmul_max_train` through the plain versions on any
    device."""
    return _GatherMatmulMax.apply(x, w, idx, mask, _PLAIN)


# -- the int8 serving form (quantized activations) ---------------------------


def int8_quantize(h):
    """Symmetric per-cloud int8 quantization over every axis after the
    batch (JAX ``int8_quantize`` for ``[B, N, C]``, and the operator
    applies' ``_quantize_in``): ``(round(h / a * 127) as int8, a / 127
    [B])`` with ``a = max(max |h|, 1e-30)`` in f32, the division first,
    rounded half to even; ``|h| / a <= 1`` keeps every value in [-127,
    127]."""
    hf = h.float()
    amax = torch.linalg.vector_norm(hf, float("inf"),
                                    dim=tuple(range(1, h.dim())))
    a = torch.clamp(amax, min=1e-30)
    hq = torch.round(hf / a.reshape((-1,) + (1,) * (h.dim() - 1)) * 127.0)
    return hq.to(torch.int8), a / 127.0


def _dequantized(best, scale, mask, dtype):
    """``best`` (int) widened to f32 times the cloud's ``scale``, 0 on
    rows with no valid neighbour, cast to ``dtype``."""
    out = best.float() * scale[:, None, None]
    return torch.where(_valid_rows(mask), out, 0.0).to(dtype)


def gather_max_int8_plain(h, idx, mask):
    """Plain version: quantize, gather the int32 rows, masked ``amax``,
    dequantize."""
    hq, scale = int8_quantize(h)
    best = _masked_rows(hq.int(), idx, mask, _I8_NEG).amax(dim=2)
    return _dequantized(best, scale, mask, h.dtype)


def absmax_plain(h):
    """Plain version: each cloud's ``max |h|``, f32 ``[B]``
    (``vector_norm(inf)`` over every axis after the batch, as
    :func:`int8_quantize` takes it; a NaN propagates)."""
    return torch.linalg.vector_norm(h.float(), float("inf"),
                                    dim=tuple(range(1, h.dim())))


def absmax(h):
    """Each cloud's ``max |h|`` of ``h [B, N, C]`` f32 or bf16, f32
    ``[B]``: plain version for CPU tensors, the ``absmax`` kernel (a
    reduction of many blocks a cloud into the f32 bits) for CUDA
    tensors."""
    if h.device.type == "cpu":
        return absmax_plain(h)
    _, dtype = _body("absmax", h)
    device = _lib.check_inputs("absmax", [("h", h, dtype, (None,) * 3)])
    return _absmax_launch(device, h)


def _absmax_launch(device, h):
    """Launches ``absmax`` on ``h [B, N, C]`` into a new ``[B]`` f32."""
    b, n, c = h.shape
    amax = torch.empty((b,), dtype=torch.float32, device=h.device)
    _lib.launch("absmax", device, h.data_ptr(), amax.data_ptr(), b, n, c,
                int(h.dtype == torch.bfloat16))
    return amax


def gather_max_int8(h, idx, mask):
    """Plain version for CPU tensors; for CUDA tensors route S (by shape,
    :func:`max_slice`): the ``absmax`` kernel, then ``gather_max_int8``,
    the staged max of ``h`` with a quantizing epilogue (the max commutes
    with the monotone quantization), two launches and no torch ops; route
    D, ``gather_max_int8_direct``: the quantization in torch ops, then the
    earlier kernel on the int8 features. Both dequantize and zero the
    rows with no valid neighbour."""
    if h.device.type == "cpu":
        return gather_max_int8_plain(h, idx, mask)
    return _gather_max_int8(h, idx, mask)


def _gather_max_int8(h, idx, mask, route=None):
    """:func:`gather_max_int8` on CUDA tensors through ``route`` (``(cs,
    splits)``; ``(0, 0)`` route D; None: by shape)."""
    _, dtype = _body("gather_max", h)  # f32 or bf16 features
    device = _check_fwd("gather_max_int8", h, idx, mask, dtype)
    out = torch.empty_like(h)
    _int8_launch(device, h, idx, mask, out, route)
    return out


def _int8_launch(device, h, idx, mask, out, route):
    """The launches of :func:`gather_max_int8` into ``out``: ``route``
    S ``(cs, splits)`` (None: :func:`max_slice`), or ``(0, 0)``, D."""
    b, n, c = h.shape
    k = idx.shape[-1]
    bf16 = int(h.dtype == torch.bfloat16)
    if route is None:
        route = max_slice(b, n, c, h.element_size(), k,
                          _sm_count(device.index or 0))
    cs, splits = route
    if cs:
        amax = _absmax_launch(device, h)
        _lib.launch("gather_max_int8", device, h.data_ptr(), idx.data_ptr(),
                    mask.data_ptr(), amax.data_ptr(), out.data_ptr(), b, n, c,
                    k, cs, splits, bf16)
    else:
        hq, scale = int8_quantize(h)
        _lib.launch("gather_max_int8_direct", device, hq.data_ptr(),
                    idx.data_ptr(), mask.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), b, n, c, k, bf16)


def gather_matmul_max_int8_plain(xq, w, idx, mask):
    """Plain version: ``xq @ w`` per point in f32 (exact products of the
    int8 values and the bf16 weights), the masked max, rounded to bf16;
    ``-3e38`` on rows with no valid neighbour."""
    return gather_matmul_max_plain(xq, w, idx, mask)


def gather_matmul_max_int8(xq, w, idx, mask):
    """Plain version for CPU tensors; for CUDA tensors the
    ``gather_matmul_max_int8`` kernel (one product a row: the int8 rows
    widened to bf16 once a tile, the slice of ``xq @ w`` in shared
    memory), or above its size the K-fold kernel
    ``gather_matmul_max_int8_kfold`` (:func:`mm_slice` for int8 x), with
    the widths zero-padded to multiples of 16 as in
    :func:`gather_matmul_max`."""
    if xq.device.type == "cpu":
        return gather_matmul_max_int8_plain(xq, w, idx, mask)
    return _gather_matmul_max_int8(xq, w, idx, mask)


def _gather_matmul_max_int8(xq, w, idx, mask, cs=None):
    """:func:`gather_matmul_max_int8` on CUDA tensors through the route
    of column slice ``cs`` (0: the K-fold kernel; None: by shape)."""
    b, n, _ = xq.shape
    c_out = w.shape[-1]
    device, xp, wp = _mm_operands("gather_matmul_max_int8", xq, w, idx, mask,
                                  torch.int8)
    out = torch.empty((b, n, wp.shape[1]), dtype=torch.bfloat16,
                      device=device)
    _mm_launch("gather_matmul_max_int8", device,
               (xp.data_ptr(), wp.data_ptr(), idx.data_ptr(),
                mask.data_ptr(), out.data_ptr()), b, n, xp.shape[-1],
               wp.shape[1], idx.shape[-1], cs, itemsize=1)
    return out[..., :c_out].contiguous() if wp.shape[1] != c_out else out
