"""Fused kNN scores + top-k (CUDA kernels + plain versions).

``knn_topk(pos, k, quantized)``: ``pos [B, N, 3]`` f32 -> ``idx [B, N,
K]`` int32, the K columns with the largest score ``s = 2 q.p - |p|^2``
(``= |q|^2 - d^2``) of every row, the self loop pinned to slot 0, N >= K,
no mask. Counterpart of ``deltaconv_tpu/ops/knn_topk.py`` (``knn_topk``;
``return_mean_dist=True`` also returns the ``[B, N]`` f32 mean Euclidean
distance to the K winners, self counted as 0, which the fused eval build
takes for its Gaussian bandwidth; the launch is counted as
``knn_topk_mean_dist``):

- exact (``quantized=False``): K rounds of "maximum score, the lowest
  column among ties, then remove it"; the mean distance sums
  ``sqrt(max(|q|^2 - best, 0))`` over the rounds (the pinned self score
  gives 0), in round order, and divides by K;
- packed keys (``quantized=True``): each row's scores are quantized
  linearly to 16 bits over the row's range and packed with the column
  into one int32, so the order is exact at the row's range / 65534 and
  ties go to the lowest column. Above 65535 points the column no longer
  fits the low 16 bits and the exact body runs, as in JAX. The mean
  distance takes each round's winner score dequantized from its key,
  ``rmin + ((key >> 16) + 32768) / scale``, round 0 (self) skipped.

The scores are computed elementwise in the JAX kernel's order (not as a
matmul), so the kernel (``csrc/knn_topk.cu``) and the plain version
give the same indices bit for bit. Up to K = 64 the kernel selects in
one pass over each row against a register threshold; above that the
wrapper routes by shape to the earlier kernel, K rounds of "max, then
remove" over each row, counted as ``knn_topk_rounds``.

``knn_topk_table(pos_q, pos_t, k, ...)``: ``pos_q [Nq, 3], pos_t [Nt, 3]
-> idx [Nq, K]`` int32 table columns, the point-sharded local kNN
(counterpart of the JAX ``knn_topk_table``; kernel ``csrc/knn_table.cu``).
The scores are ``2 q.p - |q|^2 - |p|^2``; the column of the row's own
point (``row_offset + i``, or ``row_ids[i]``) is pinned to slot 0;
``point_mask [Nt]`` hides table rows. The columns are cut into tiles of
``tile_c``, the last one padded with masked columns ``Nt, Nt + 1, ...``.
Its sums of products round as the JAX function's do where XLA compiles
them: ``q.p = fma(qz, pz, fma(qx, px, qy py))`` and ``|p|^2 = fma(z, z,
fma(y, y, x x))`` (XLA contracts a product into the sum that follows it;
the kernel uses ``fmaf``, the plain version float64, exact for the
product and rounded once more, which can differ from one rounding only
when the float64 sum falls on a float32 midpoint):

- exact: the K columns with the largest score, ties to the lowest
  column; masked columns score -2e30, so a row with fewer than K valid
  columns is filled with masked ones, lowest column first;
- ``quantized=True``: within each tile the row's valid scores are
  quantized to 16 bits and packed with the local column (the tile's K
  best keys), dequantized, and merged across tiles by (score, lowest
  column). The order is exact to the tile's score range / 65533; the
  answer depends on ``tile_c`` as the TPU kernel's does.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["knn_topk", "knn_topk_plain", "knn_topk_table",
           "knn_topk_table_plain"]

_BIG = 1e30
_EMPTY = -3.0e38  # the TPU kernels' empty slot
_MAX_PACKED_N = 65535  # the column rides in the key's low 16 bits
_SELECT_MAX_K = 64  # knn_topk's register list; above it the rounds kernel
_TABLE_MAX_TILE = 2048  # the table kernel stages a tile in shared memory
_TABLE_MAX_K = 32  # and keeps each tile's list in registers
# Query rows the plain table version scores against the whole table at
# a time ([1024, 65536] f32: 268 MB).
_ROW_CHUNK = 1024


def _check(pos, k):
    b, n, three = pos.shape
    if three != 3 or not 0 < k <= n:
        raise ValueError(f"knn_topk: pos {tuple(pos.shape)} and k={k}; "
                         "expected [B, N, 3] with 0 < k <= N")


def _scores(pos):
    """``[B, N, N]`` ``2 (q . p) - |p|^2``, each operation rounded on
    its own, in the order of the JAX kernel's ``_scores``."""
    x, y, z = pos.float().unbind(-1)
    sq = x * x + y * y + z * z
    dot = (x[:, :, None] * x[:, None, :] + y[:, :, None] * y[:, None, :]
           + z[:, :, None] * z[:, None, :])
    return 2.0 * dot - sq[:, None, :]


def _sqrt_dist(qsq, score):
    """``sqrt(max(|q|^2 - score, 0))``."""
    return torch.sqrt(torch.clamp(qsq - score, min=0.0))


def _over_k(dsum, k):
    """``dsum / k``, a true division (on the card ``dsum / float(k)``
    would multiply by 1 / k)."""
    return dsum / torch.full_like(dsum, float(k))


def knn_topk_plain(pos, k: int, quantized: bool = False,
                   return_mean_dist: bool = False):
    """The plain PyTorch version: the score plane, then the packed keys'
    ``topk`` (unique keys: no ties) or K exact sweeps."""
    _check(pos, k)
    b, n, _ = pos.shape
    s = _scores(pos)
    x, y, z = pos.float().unbind(-1)
    qsq = x * x + y * y + z * z  # the kernel's order
    dsum = torch.zeros((b, n), dtype=torch.float32, device=pos.device)
    col = torch.arange(n, device=pos.device)
    is_self = col[:, None] == col[None, :]
    if quantized and n <= _MAX_PACKED_N:
        rmin = s.amin(dim=-1, keepdim=True)
        rmax = s.amax(dim=-1, keepdim=True)
        span = torch.clamp(rmax - rmin, min=1e-30)
        # A true division (``65534.0 / t`` would multiply by 1 / t).
        scale = torch.full_like(span, 65534.0) / span
        q = ((s - rmin) * scale).to(torch.int32)  # truncation
        low = (65535 - col).to(torch.int32)
        # (q - 32768) << 16 | low: the shifted value's low bits are 0.
        keys = torch.where(is_self, 0x7FFF0000 + low, (q - 32768) * 65536
                           + low)
        best = torch.topk(keys, k, dim=-1).values
        idx = (65535 - (best & 65535)).to(torch.int32)
        if not return_mean_dist:
            return idx
        st = rmin + ((best >> 16) + 32768).to(torch.float32) / scale
        for r in range(1, k):  # round 0 is the self loop
            dsum = dsum + _sqrt_dist(qsq, st[..., r])
        return idx, _over_k(dsum, k)
    s = torch.where(is_self, 2.0 * _BIG, s)
    wins = []
    for _ in range(k):
        best = s.amax(dim=-1, keepdim=True)
        win = torch.where(s >= best, col, n).amin(dim=-1, keepdim=True)
        wins.append(win)
        s = torch.where(col == win, -_BIG, s)
        dsum = dsum + _sqrt_dist(qsq, best[..., 0])
    idx = torch.cat(wins, dim=-1).to(torch.int32)
    return (idx, _over_k(dsum, k)) if return_mean_dist else idx


def knn_topk(pos, k: int, quantized: bool = False,
             return_mean_dist: bool = False):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors
    (``knn_topk``, or ``knn_topk_mean_dist`` with the mean distances; for
    k > 64 ``knn_topk_rounds``, either way)."""
    if pos.device.type == "cpu":
        return knn_topk_plain(pos, k, quantized, return_mean_dist)
    _check(pos, k)
    b, n, _ = pos.shape
    if k > _SELECT_MAX_K:
        name = "knn_topk_rounds"
    else:
        name = "knn_topk_mean_dist" if return_mean_dist else "knn_topk"
    device = _lib.check_inputs(name, [("pos", pos, torch.float32, (b, n, 3))])
    idx = torch.empty((b, n, k), dtype=torch.int32, device=device)
    md = (torch.empty((b, n), dtype=torch.float32, device=device)
          if return_mean_dist else None)
    quantized = int(quantized and n <= _MAX_PACKED_N)
    md_ptr = None if md is None else md.data_ptr()
    if name == "knn_topk":
        _lib.launch(name, device, pos.data_ptr(), idx.data_ptr(), b, n, k,
                    quantized)
    else:
        _lib.launch(name, device, pos.data_ptr(), idx.data_ptr(), md_ptr, b,
                    n, k, quantized)
    return idx if md is None else (idx, md)


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32 (through float64: the product is
    exact there)."""
    return (a.double() * b.double() + c.double()).float()


def _sq(x, y, z):
    """``|p|^2`` as XLA computes ``jnp.sum(p * p, -1)``."""
    return _fma(z, z, _fma(y, y, x * x))


def _dot(qx, qy, qz, px, py, pz):
    """``q . p`` as XLA computes ``qx px + qy py + qz pz``."""
    return _fma(qz, pz, _fma(qx, px, qy * py))


def _check_table(pos_q, pos_t, k, tile_c, row_ids):
    if (pos_q.dim() != 2 or pos_q.shape[1] != 3 or pos_t.dim() != 2
            or pos_t.shape[1] != 3):
        raise ValueError(f"knn_topk_table: pos_q {tuple(pos_q.shape)}, "
                         f"pos_t {tuple(pos_t.shape)}; expected [Nq, 3] "
                         "and [Nt, 3]")
    if not 0 < k <= tile_c:
        raise ValueError(f"knn_topk_table: k={k}; expected 0 < k <= "
                         f"tile_c={tile_c}")
    if row_ids is not None and tuple(row_ids.shape) != (pos_q.shape[0],):
        raise ValueError(f"knn_topk_table: row_ids {tuple(row_ids.shape)}; "
                         f"expected [{pos_q.shape[0]}]")


def _self_columns(n_q, row_offset, row_ids, device):
    """The column of each query row's own point, int32 ``[Nq]``."""
    if row_ids is not None:
        return row_ids.to(device=device, dtype=torch.int32)
    return (torch.arange(n_q, device=device, dtype=torch.int32)
            + int(row_offset))


def _table_exact(s, col, is_self, valid, k, n_t):
    """K sweeps over the whole row: the best score, the lowest column
    among ties, then remove it (the running top-K of the TPU kernel ends
    in this order)."""
    s = torch.where(is_self, 2.0 * _BIG, s)
    s = torch.where(valid, s, -2.0 * _BIG)
    wins = []
    for _ in range(k):
        best = s.amax(dim=-1, keepdim=True)
        win = torch.where(s >= best, col, n_t).amin(dim=-1, keepdim=True)
        wins.append(win)
        s = torch.where(col == win, _EMPTY, s)
    return torch.cat(wins, dim=-1)


def _table_quantized(s, is_self, valid, k, n_t, tile_c):
    """Each tile's K best packed keys, dequantized; then K sweeps over all
    tiles' entries by (score, lowest column), which is where the TPU
    kernel's tile-by-tile merge ends."""
    rows, n_cols = s.shape
    n_tiles = n_cols // tile_c
    s = s.view(rows, n_tiles, tile_c)
    is_self = is_self.view(rows, n_tiles, tile_c)
    valid = valid.view(1, n_tiles, tile_c) & ~is_self
    rmin = torch.where(valid, s, torch.inf).amin(dim=-1, keepdim=True)
    rmax = torch.where(valid, s, -torch.inf).amax(dim=-1, keepdim=True)
    rmin = torch.where(torch.isfinite(rmin), rmin, 0.0)
    rmax = torch.where(torch.isfinite(rmax), rmax, 0.0)
    span = torch.clamp(rmax - rmin, min=1e-30)
    # A true division (``65533.0 / t`` would multiply by 1 / t).
    scale = torch.full_like(span, 65533.0) / span
    qs = ((torch.where(valid, s, rmin) - rmin) * scale).to(torch.int32) + 1
    qs = torch.clamp(qs, 1, 65534)
    low = (65535 - torch.arange(tile_c, device=s.device)).to(torch.int32)
    keys = torch.where(is_self, 0x7FFF0000 + low,
                       torch.where(valid, (qs - 32768) * 65536 + low,
                                   -2**31 + low))
    best = torch.topk(keys, k, dim=-1).values  # unique keys: no ties
    qb = (best >> 16) + 32768
    # The JAX kernel's rmin + (qb - 1) / scale as XLA evaluates it: the
    # division by 65533 / span becomes a product with span, then with
    # 1 / 65533 (a constant), fused with the add.
    st = _fma((qb - 1).to(torch.float32) * span,
              torch.full_like(span, 1.0 / 65533.0), rmin)
    st = torch.where(qb == 65535, 2.0 * _BIG, st)
    st = torch.where(qb == 0, -2.0 * _BIG, st)
    base = (torch.arange(n_tiles, device=s.device) * tile_c)[:, None]
    ids = (base + 65535 - (best & 65535)).reshape(rows, n_tiles * k)
    st = st.reshape(rows, n_tiles * k)
    wins = []
    for _ in range(k):
        top = st.amax(dim=-1, keepdim=True)
        win = torch.where(st >= top, ids, n_t).amin(dim=-1, keepdim=True)
        wins.append(win)
        st = torch.where(ids == win, _EMPTY, st)
    return torch.cat(wins, dim=-1)


def knn_topk_table_plain(pos_q, pos_t, k: int, row_offset=0, point_mask=None,
                         tile_c: int = 2048, quantized: bool = False,
                         row_ids=None):
    """The plain PyTorch version: ``_ROW_CHUNK`` query rows at a time
    against the whole padded table, the scores in the kernel's order."""
    _check_table(pos_q, pos_t, k, tile_c, row_ids)
    dev = pos_q.device
    n_q, n_t = pos_q.shape[0], pos_t.shape[0]
    n_cols = -(-n_t // tile_c) * tile_c
    table = torch.zeros((n_cols, 3), dtype=torch.float32, device=dev)
    table[:n_t] = pos_t.float()
    valid = torch.arange(n_cols, device=dev) < n_t
    if point_mask is not None:
        valid[:n_t] &= point_mask.to(device=dev, dtype=torch.bool)
    px, py, pz = table.unbind(-1)
    sqt = _sq(px, py, pz)
    col = torch.arange(n_cols, device=dev, dtype=torch.int32)
    rows = _self_columns(n_q, row_offset, row_ids, dev)
    out = []
    for start in range(0, n_q, _ROW_CHUNK):
        q = pos_q[start:start + _ROW_CHUNK].float()
        qx, qy, qz = (c[:, None] for c in q.unbind(-1))
        s = 2.0 * _dot(qx, qy, qz, px, py, pz) - _sq(qx, qy, qz) - sqt
        is_self = col == rows[start:start + _ROW_CHUNK, None]
        out.append(_table_quantized(s, is_self, valid, k, n_t, tile_c)
                   if quantized else
                   _table_exact(s, col, is_self, valid, k, n_t))
    return torch.cat(out).to(torch.int32)


def knn_topk_table(pos_q, pos_t, k: int, row_offset=0, point_mask=None,
                   tile_c: int = 2048, quantized: bool = False,
                   row_ids=None):
    """Plain version for CPU tensors; the CUDA kernel (``knn_topk_table``
    or, quantized, ``knn_topk_table_q``) for CUDA tensors."""
    if pos_q.device.type == "cpu":
        return knn_topk_table_plain(pos_q, pos_t, k, row_offset, point_mask,
                                    tile_c, quantized, row_ids)
    _check_table(pos_q, pos_t, k, tile_c, row_ids)
    if k > _TABLE_MAX_K or tile_c > _TABLE_MAX_TILE or tile_c % 32:
        raise ValueError(f"knn_topk_table: the kernel takes k <= "
                         f"{_TABLE_MAX_K} and tile_c a multiple of 32 up to "
                         f"{_TABLE_MAX_TILE}; got k={k}, tile_c={tile_c}")
    n_q, n_t = pos_q.shape[0], pos_t.shape[0]
    pos_q = pos_q.float().contiguous()
    pos_t = pos_t.float().contiguous()
    rows = _self_columns(n_q, row_offset, row_ids, pos_q.device).contiguous()
    specs = [("pos_q", pos_q, torch.float32, (n_q, 3)),
             ("pos_t", pos_t, torch.float32, (n_t, 3)),
             ("row_ids", rows, torch.int32, (n_q,))]
    mask = None
    if point_mask is not None:
        mask = point_mask.to(torch.bool).contiguous().view(torch.uint8)
        specs.append(("point_mask", mask, torch.uint8, (n_t,)))
    name = "knn_topk_table_q" if quantized else "knn_topk_table"
    device = _lib.check_inputs(name, specs)
    idx = torch.empty((n_q, k), dtype=torch.int32, device=device)
    # Each (row, column tile) task's K best, which the kernel's second
    # pass merges.
    n_tiles = -(-n_t // tile_c)
    part_s = torch.empty((n_tiles, k, n_q), dtype=torch.float32,
                         device=device)
    part_i = torch.empty((n_tiles, k, n_q), dtype=torch.int32, device=device)
    _lib.launch(name, device, pos_q.data_ptr(), pos_t.data_ptr(),
                None if mask is None else mask.data_ptr(), rows.data_ptr(),
                part_s.data_ptr(), part_i.data_ptr(), idx.data_ptr(), n_q,
                n_t, k, tile_c)
    return idx
