"""Sub-quadratic kNN through Morton-sorted buckets (CUDA kernels + plain
versions), the point-sharded local kNN above 16,384 table points.

Counterpart of ``deltaconv_tpu/ops/knn_bucketed.py``:
``knn_topk_bucketed(pos_q, pos_t, k, ...)`` is a drop-in for
:func:`~.knn_topk.knn_topk_table` whose queries are table rows
(``pos_q[i] == pos_t[row_offset + i]``): ``-> idx [Nq, K]`` int32 table
columns, the row's own column in slot 0.

1. The table is sorted by 30-bit Morton code (a stable ``argsort``);
   runs of ``tile_c`` sorted points are the buckets, each with the
   bounding box of its valid points.
2. The queries are Morton-sorted too; each run of ``tile_q`` queries
   takes the ``m_tiles`` buckets nearest to its box (a stable ascending
   sort of the box-to-box distances, first index on ties, as JAX's
   ``lax.top_k``), its own points' home buckets forced in.
3. The candidate sweep (the kernel: ``csrc/knn_bucketed.cu``) gives each
   query its K - 1 best columns among its tile's ``m_tiles * tile_c``
   candidates, self excluded; self is prepended as slot 0.
4. Exact mode (``quantized=False``) certifies each row: its (K-1)-th
   score must clear the best possible score of every bucket it did not
   visit, less a margin for f32 rounding of ``1e-6 x max(|q|^2,
   |kth|)`` (the JAX margin, ``1e-6 |kth|``, does not scale with the
   cancellation error of ``2 q.p - |q|^2 - |p|^2``, which grows with
   ``|q|^2``: clouds far from the origin were certified wrongly). Rows
   that fail are solved again with the exact table kernel: ``repair_rows``
   of them (failing rows first), or the whole call when more fail. The
   winner SETS then equal the exact table kernel's.
   ``quantized=True`` quantizes each row's candidate scores to 16 bits
   packed with the candidate lane (recall below 1, no certificate).

Rows with fewer valid candidates than K - 1 are filled with the marker
id ``Nt + padding`` (>= Nt) in both modes: the JAX kernels emit the
filler columns' own ids, masked real points among them.

The Morton sort, the boxes, the candidate choice, the un-sort and the
certificate are plain torch around the kernel. Sums of products round as
XLA computes the JAX function's (:mod:`.knn_topk`): the scores and
squared norms bit-equal to it give the same candidates and keys. Which branch an exact call
took (fast, repair or full) needs the count of failing rows on the host:
one device-to-host sync a call (JAX's ``lax.switch`` kept it on the
device). :data:`last_branch` records it.
"""

from __future__ import annotations

import torch

from . import _lib
from .knn_topk import (_EMPTY, _dot, _sq, knn_topk_table,
                       knn_topk_table_plain)

__all__ = ["knn_topk_bucketed", "knn_topk_bucketed_plain", "last_branch",
           "morton_codes"]

_BIG = 1e30
_MAX_LIST = 32  # the kernel's per-query list: K - 1 <= 32
_MAX_TILE_Q = 256  # the kernel's threads a block: a query each
_SMEM_BYTES = 232448  # shared memory a block can use on the H100
_LANE_BYTES = 20  # a staged candidate lane: x, y, z, |p|^2, id
_QUEUE_BYTES = 144  # a query's queue of passing candidates
# Query tiles the plain sweep scores at a time (1024 rows at tile_q=64).
_TILE_CHUNK_ROWS = 1024

# The exact mode's last branch: {"n_bad": failing rows, "branch": "fast",
# "repair" or "full"}.
last_branch: dict = {}


def _spread3(v):
    """10-bit ints -> bits spread to every third position."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_codes(pos, mn, inv_ext):
    """``[N, 3]`` f32 positions -> int32 30-bit Morton codes over the box
    ``mn``, ``1 / extent``."""
    cells = torch.clamp((((pos - mn) * inv_ext) * 1023.0).to(torch.int32),
                        0, 1023)
    return (_spread3(cells[:, 0]) | (_spread3(cells[:, 1]) << 1)
            | (_spread3(cells[:, 2]) << 2))


def _cand_plain(posq, sqq, srow, comb, perm, cand, box, ks, marker,
                quantized):
    """The candidate sweep's plain version, ``_TILE_CHUNK_ROWS`` query
    rows at a time: the candidate planes gathered, scored in the kernel's
    order; exact: ks sweeps (best score, lowest id, remove); quantized:
    the packed keys' ``topk`` (unique keys). ``box`` (the buckets' boxes,
    which let the kernel skip buckets) is not needed here."""
    n_b, _, tile_c = comb.shape
    nqt, m = cand.shape
    tile_q = posq.shape[0] // nqt
    w = m * tile_c
    lane = torch.arange(w, device=comb.device, dtype=torch.int32)
    step = max(1, _TILE_CHUNK_ROWS // tile_q)
    idx_out, sc_out = [], []
    for t0 in range(0, nqt, step):
        cb = cand[t0:t0 + step].long()
        t = cb.shape[0]
        pts = comb[cb].permute(0, 2, 1, 3).reshape(t, 1, 4, w)
        px, py, pz, pw = pts.unbind(2)  # [t, 1, W]
        orig = perm.view(n_b, tile_c)[cb].reshape(t, 1, w)
        rows = slice(t0 * tile_q, (t0 + t) * tile_q)
        qx, qy, qz = (c.reshape(t, tile_q, 1) for c in posq[rows].unbind(-1))
        sq = sqq[rows].reshape(t, tile_q, 1)
        me = srow[rows].reshape(t, tile_q, 1)
        s = 2.0 * _dot(qx, qy, qz, px, py, pz) - pw - sq  # [t, tile_q, W]
        if quantized:
            valid = (s > -1e29) & (orig != me)
            rmin = torch.where(valid, s, torch.inf).amin(-1, keepdim=True)
            rmax = torch.where(valid, s, -torch.inf).amax(-1, keepdim=True)
            rmin = torch.where(torch.isfinite(rmin), rmin, 0.0)
            rmax = torch.where(torch.isfinite(rmax), rmax, 0.0)
            span = torch.clamp(rmax - rmin, min=1e-30)
            scale = torch.full_like(span, 65533.0) / span
            qs = ((torch.where(valid, s, rmin) - rmin) * scale).to(
                torch.int32) + 1
            qs = torch.where(valid, torch.clamp(qs, 1, 65534), 0)
            keys = (qs - 32768) * 65536 + (65535 - lane)
            keys = torch.where(orig == me, -2**31, keys)
            best = torch.topk(keys, ks, dim=-1).values
            qb = (best >> 16) + 32768
            st = rmin + (qb - 1).to(torch.float32) / scale
            empty = best == -2**31
            win = torch.gather(orig.expand(t, tile_q, w), 2,
                               (65535 - (best & 65535)).long())
            idx_out.append(torch.where(empty | (qb == 0), marker, win))
            sc_out.append(torch.where(
                empty, _EMPTY, torch.where(qb == 0, -2.0 * _BIG, st)))
        else:
            s = torch.where(orig == me, _EMPTY, s)
            wins, scores = [], []
            for _ in range(ks):
                best = s.amax(dim=-1, keepdim=True)
                win = torch.where(s >= best, orig, marker).amin(
                    dim=-1, keepdim=True)
                wins.append(torch.where(best > -1e29, win, marker))
                scores.append(best)
                s = torch.where(orig == win, _EMPTY, s)
            idx_out.append(torch.cat(wins, dim=-1))
            sc_out.append(torch.cat(scores, dim=-1))
    return (torch.cat(idx_out).reshape(-1, ks).to(torch.int32),
            torch.cat(sc_out).reshape(-1, ks))


def _cand_kernel(posq, sqq, srow, comb, perm, cand, box, ks, marker,
                 quantized):
    """The candidate sweep's CUDA kernel (``knn_topk_bucketed`` or,
    quantized, ``knn_topk_bucketed_q``). ``box [n_b, 6]``: each bucket's
    box over its valid points (min, then max; inf where it has none).
    Buckets of ``tile_c`` columns not a multiple of 4 are padded here to
    the kernel's 16-byte copies."""
    n_b, _, tile_c = comb.shape
    nqt, m = cand.shape
    nqp = posq.shape[0]
    if not 0 < ks <= _MAX_LIST:
        raise ValueError(f"knn_topk_bucketed: the kernel takes k - 1 <= "
                         f"{_MAX_LIST}, got k={ks + 1}")
    if nqp // nqt > _MAX_TILE_Q:
        raise ValueError(f"knn_topk_bucketed: the kernel takes tile_q <= "
                         f"{_MAX_TILE_Q} (a thread a query), got "
                         f"{nqp // nqt}")
    ldc = -(-tile_c // 4) * 4
    max_c = (_SMEM_BYTES - 64 - _QUEUE_BYTES * _MAX_TILE_Q) // _LANE_BYTES
    if ldc > max_c:
        raise ValueError(f"knn_topk_bucketed: a bucket of tile_c={tile_c} "
                         f"columns exceeds the kernel's shared memory "
                         f"({max_c} columns)")
    name = "knn_topk_bucketed_q" if quantized else "knn_topk_bucketed"
    device = _lib.check_inputs(name, [
        ("posq", posq, torch.float32, (nqp, 3)),
        ("sqq", sqq, torch.float32, (nqp,)),
        ("srow", srow, torch.int32, (nqp,)),
        ("comb", comb, torch.float32, (n_b, 4, tile_c)),
        ("perm", perm, torch.int32, (n_b * tile_c,)),
        ("cand", cand, torch.int32, (nqt, m)),
        ("box", box, torch.float32, (n_b, 6)),
    ])
    if ldc != tile_c:
        comb = torch.nn.functional.pad(comb, (0, ldc - tile_c))
        perm = torch.nn.functional.pad(perm.view(n_b, tile_c),
                                       (0, ldc - tile_c)).reshape(-1)
    idx = torch.empty((nqp, ks), dtype=torch.int32, device=device)
    sc = torch.empty((nqp, ks), dtype=torch.float32, device=device)
    _lib.launch(name, device, posq.data_ptr(), sqq.data_ptr(),
                srow.data_ptr(), comb.data_ptr(), perm.data_ptr(),
                cand.data_ptr(), box.data_ptr(), idx.data_ptr(),
                sc.data_ptr(), nqt,
                nqp // nqt, tile_c, ldc, m, ks, marker)
    return idx, sc


def _bucketed(pos_q, pos_t, k, row_offset, point_mask, tile_q, tile_c,
              m_tiles, quantized, repair_rows, sweep, table):
    last_branch.clear()
    n_q, n_t = pos_q.shape[0], pos_t.shape[0]
    dev = pos_q.device
    self_col = (torch.arange(n_q, device=dev, dtype=torch.int32)
                + int(row_offset))[:, None]
    if k <= 1:
        return self_col[:, :k]
    if m_tiles is None:
        m_tiles = 24 if quantized else 32
    pos_q = pos_q.float()
    pos_t = pos_t.float()
    ks = k - 1

    # --- Morton-sort the table ---------------------------------------
    n_tp = -(-n_t // tile_c) * tile_c
    pos_tp = torch.zeros((n_tp, 3), dtype=torch.float32, device=dev)
    pos_tp[:n_t] = pos_t
    valid_t = torch.arange(n_tp, device=dev) < n_t
    if point_mask is not None:
        valid_t[:n_t] &= point_mask.to(device=dev, dtype=torch.bool)
    vmask = valid_t[:, None]
    mn = torch.where(vmask, pos_tp, torch.inf).amin(dim=0)
    mx = torch.where(vmask, pos_tp, -torch.inf).amax(dim=0)
    mn = torch.where(torch.isfinite(mn), mn, 0.0)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    inv_ext = 1.0 / torch.clamp(mx - mn, min=1e-30)
    keys = torch.where(valid_t, morton_codes(pos_tp, mn, inv_ext),
                       0x7FFFFFFF)  # invalid points sort last
    perm = torch.sort(keys, stable=True).indices.to(torch.int32)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm.long()] = torch.arange(n_tp, device=dev, dtype=torch.int32)
    pos_s = pos_tp[perm.long()]
    valid_s = valid_t[perm.long()]
    n_b = n_tp // tile_c

    # Bucket boxes over the valid points (an empty bucket gets an inf box).
    p3 = pos_s.view(n_b, tile_c, 3)
    v3 = valid_s.view(n_b, tile_c, 1)
    tmin = torch.where(v3, p3, torch.inf).amin(dim=1)  # [n_b, 3]
    tmax = torch.where(v3, p3, -torch.inf).amax(dim=1)

    # --- Morton-sort the queries -------------------------------------
    qperm = torch.sort(morton_codes(pos_q, mn, inv_ext), stable=True).indices
    pad_q = (-n_q) % tile_q
    # Padding replicates the last sorted query; its rows are dropped.
    qperm_p = torch.cat([qperm, qperm[-1:].expand(pad_q)])
    posq_s = pos_q[qperm_p].contiguous()
    sqq = _sq(*posq_s.unbind(-1)).contiguous()
    g_row = int(row_offset) + qperm_p
    srow = torch.where(g_row < n_t, g_row, -1).to(torch.int32)
    spos = inv_perm[torch.clamp(g_row, 0, n_tp - 1)].long()
    nqt = posq_s.shape[0] // tile_q
    q3 = posq_s.view(nqt, tile_q, 3)
    qmin, qmax = q3.amin(dim=1), q3.amax(dim=1)

    # --- Candidate buckets per query tile ----------------------------
    gap = torch.clamp(torch.maximum(qmin[:, None] - tmax[None],
                                    tmin[None] - qmax[:, None]), min=0.0)
    d2box = _sq(*gap.unbind(-1))  # [nqt, n_b]
    m = min(m_tiles, n_b)
    # Force each query's home bucket in (box ties at 0 are common on
    # surfaces and could push it out).
    home = torch.where(g_row[:n_q] < n_t, spos[:n_q] // tile_c, 0)
    tile_of = torch.arange(n_q, device=dev) // tile_q
    d2box.view(-1).scatter_reduce_(
        0, tile_of * n_b + torch.clamp(home, 0, n_b - 1),
        torch.full((n_q,), -1.0, device=dev), "amin")
    cand = torch.sort(d2box, dim=1, stable=True).indices[:, :m]
    if m * tile_c > 65535:
        raise ValueError("knn_topk_bucketed: the quantized key packs the "
                         "lane in 16 bits: m_tiles * tile_c <= 65535")

    sq_s = torch.where(valid_s, _sq(*pos_s.unbind(-1)), 4.0e30)
    comb = (torch.cat([pos_s, sq_s[:, None]], dim=1).view(n_b, tile_c, 4)
            .transpose(1, 2).contiguous())  # [n_b, 4, tile_c]
    box = torch.cat([tmin, tmax], dim=1).contiguous()  # [n_b, 6]
    idx_s, sc_s = sweep(posq_s, sqq, srow, comb, perm,
                        cand.to(torch.int32).contiguous(), box, ks, n_tp,
                        quantized)

    # --- Un-sort, prepend self ---------------------------------------
    inv_qperm = torch.empty_like(qperm)
    inv_qperm[qperm] = torch.arange(n_q, device=dev)
    idx_o = idx_s[inv_qperm]
    fast_idx = torch.cat([self_col, idx_o], dim=1)
    if quantized or n_b <= m:
        # Quantized, or every bucket visited (exhaustive is exact).
        return fast_idx

    # --- Exactness certificate (per row) -----------------------------
    gapq = torch.clamp(torch.maximum(tmin[None] - pos_q[:, None],
                                     pos_q[:, None] - tmax[None]), min=0.0)
    d2pb = _sq(*gapq.unbind(-1))  # [n_q, n_b]
    cand_mask = torch.zeros((nqt, n_b), dtype=torch.bool, device=dev)
    cand_mask.scatter_(1, cand, True)
    visited = cand_mask[inv_qperm // tile_q]
    bound = torch.where(visited, torch.inf, d2pb).amin(dim=1)
    kth = sc_s[inv_qperm].amin(dim=1)
    margin = 1e-6 * torch.maximum(_sq(*pos_q.unbind(-1)), kth.abs())
    ok = (kth - margin - 1e-30) >= -bound
    # One device-to-host sync: the branch is chosen on the host.
    n_bad = int((~ok).sum())
    r = min(repair_rows, n_q)
    if n_bad == 0:
        branch = "fast"
    elif n_bad <= r:
        branch = "repair"
    else:
        branch = "full"
    last_branch.update(n_bad=n_bad, branch=branch)
    if branch == "fast":
        return fast_idx
    if branch == "full":
        return table(pos_q, pos_t, k, row_offset=row_offset,
                     point_mask=point_mask)
    # The failing rows first, then the lowest certified ones (re-solved
    # harmlessly), r in all, as JAX's top_k over the failure flags.
    rep = torch.sort((~ok).to(torch.int8), descending=True,
                     stable=True).indices[:r]
    rep_idx = table(pos_q[rep], pos_t, k, row_ids=int(row_offset) + rep,
                    point_mask=point_mask)
    fast_idx[rep] = rep_idx
    return fast_idx


def _check(pos_q, pos_t, k):
    if (pos_q.dim() != 2 or pos_q.shape[1] != 3 or pos_t.dim() != 2
            or pos_t.shape[1] != 3 or not 0 < k <= pos_t.shape[0]):
        raise ValueError(f"knn_topk_bucketed: pos_q {tuple(pos_q.shape)}, "
                         f"pos_t {tuple(pos_t.shape)}, k={k}; expected "
                         "[Nq, 3], [Nt, 3] and 0 < k <= Nt")


def knn_topk_bucketed_plain(pos_q, pos_t, k: int, row_offset=0,
                            point_mask=None, tile_q: int = 64,
                            tile_c: int = 256, m_tiles=None,
                            quantized: bool = False,
                            repair_rows: int = 2048):
    """:func:`knn_topk_bucketed` through the plain versions of the
    candidate sweep and of the table kNN, on any device."""
    _check(pos_q, pos_t, k)
    return _bucketed(pos_q, pos_t, k, row_offset, point_mask, tile_q, tile_c,
                     m_tiles, quantized, repair_rows, _cand_plain,
                     knn_topk_table_plain)


def knn_topk_bucketed(pos_q, pos_t, k: int, row_offset=0, point_mask=None,
                      tile_q: int = 64, tile_c: int = 256, m_tiles=None,
                      quantized: bool = False, repair_rows: int = 2048):
    """k-nearest table columns through Morton-bucketed candidates (see the
    module docstring). ``m_tiles``: candidate buckets per query tile, 24
    quantized and 32 exact by default (the JAX package's choice).
    ``repair_rows``: exact mode's budget of re-solved rows before the
    whole call falls back to the table kNN. The plain versions for CPU
    tensors; the kernels (the candidate sweep, and the table kNN of the
    repair or fallback) for CUDA tensors."""
    if pos_q.device.type == "cpu":
        return knn_topk_bucketed_plain(pos_q, pos_t, k, row_offset,
                                       point_mask, tile_q, tile_c, m_tiles,
                                       quantized, repair_rows)
    _check(pos_q, pos_t, k)
    return _bucketed(pos_q, pos_t, k, row_offset, point_mask, tile_q, tile_c,
                     m_tiles, quantized, repair_rows, _cand_kernel,
                     knn_topk_table)
