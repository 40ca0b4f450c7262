"""k-nearest neighbours with the self loop in slot 0 (counterpart of
``deltaconv_tpu/geometry/knn.py``).

``method="exact"``: the scores are one batched ``[N, 3] @ [3, N]``
product plus rank-1 terms, then a selection with the answer of XLA's
``top_k``, which the JAX package uses: the K largest scores in
descending order, equal scores lowest index first, under the total
order of the f32 bits (-0.0 below +0.0). ``torch.topk`` promises no
order among equal scores, so the route sorts the scores' ordered bits
stably (:func:`top_k`).
The product must run in full f32 (no TF32): a coarser product reorders
near-tied neighbours. The squared norms round as XLA's CPU compiler
rounds JAX's ``jnp.sum(p * p, -1)``, contracted into
``fma(z, z, fma(y, y, x x))`` (:func:`squared_norms`): with the same
product and the same selection the scores, and so the ids, are JAX's
on the CPU, near-ties of one ulp on a grid included.

``method="approx"`` takes the JAX package's TPU route: uniform batches
(no mask, N >= k) go through the fused ``knn_topk`` kernel with packed
keys (order exact to the row's score range / 65534); masked batches,
where the JAX package takes XLA's ``approx_max_k`` (recall >= 0.95),
take the exact route, which meets that contract.

:func:`knn_tiled` is the exact route of one large cloud a tile of query
rows at a time (JAX's ``knn_tiled``, XLA in JAX and torch ops here), in
``O(N tile)`` memory; :func:`knn` also takes one cloud (``[N, 3]``).
"""

from __future__ import annotations

import torch

from ..ops.knn_topk import knn_topk

__all__ = ["exact_scores", "knn", "knn_tiled", "squared_norms", "top_k"]

_BIG = 1e30


def squared_norms(pos):
    """``|p|^2`` of ``pos [..., 3]`` f32 as ``fma(z, z, fma(y, y, x x))``,
    XLA's contraction of ``jnp.sum(p * p, -1)`` on the CPU, each fused
    step computed in f64 (the product exact) and rounded to f32."""
    p = pos.double()
    acc = (p[..., 0] * p[..., 0]).float()
    for d in (1, 2):
        acc = (p[..., d] * p[..., d] + acc.double()).float()
    return acc


def top_k(s, k: int, select: bool = False):
    """XLA's ``top_k`` of ``s [..., M]`` f32 along the last axis:
    ``(values, indices [..., k] int64)``, the k largest in descending
    order, equal scores lowest index first, -0.0 below +0.0 (the order
    of XLA's CPU and TPU ``top_k``). A score's int32 key is its f32 bits
    made monotone (a negative score's magnitude bits flipped); a stable
    descending sort of the keys keeps equal ones in column order. With
    ``select`` the same answer comes from ``torch.topk`` of unique int64
    keys, the int32 key above the complemented column (a selection, not
    a sort), for rows far longer than k. (On an H100 the sort of ``[32,
    1024, 1024]`` keys costs about what ``torch.topk`` of the scores
    does, and the int64 selection 2.8 times that: ``chip_smoke.py``'s
    ``[knn-ties]``; ``[geometry-single]`` times both on one tile of
    :func:`knn_tiled`, 65,536 columns.)"""
    bits = s.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    if select:
        last = s.shape[-1] - 1
        cols = torch.arange(last, -1, -1, device=s.device)
        wide = (key.to(torch.int64) << 32) | cols
        idx = last - torch.topk(wide, k, dim=-1).values.bitwise_and(
            0xFFFFFFFF)
    else:
        idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[
            ..., :k]
    return torch.gather(s, -1, idx), idx


def knn(pos, k: int, point_mask=None, method: str = "exact",
        knn_topk_fn=knn_topk):
    """Brute-force kNN over a batch of clouds.

    Args:
      pos: ``[B, N, 3]`` positions.
      k: neighbours, **including** the self loop, always in slot 0.
      point_mask: optional ``[B, N]`` bool validity; invalid points are
        never returned as neighbours.
      method: ``"exact"`` or ``"approx"`` (see the module docstring).
      knn_topk_fn: the ``knn_topk`` kernel (default) or its plain
        version, for ``"approx"``.

    Returns:
      ``(nbr_idx [B, N, K] int32, nbr_mask [B, N, K] bool)``; padded
      slots (fewer than ``k`` valid points) are clamped to self with
      ``mask=False``. One cloud (``pos [N, 3]``, ``point_mask [N]``) is a
      batch of one, returned ``[N, K]``.
    """
    if pos.dim() == 2:
        idx, mask = knn(pos[None], k, None if point_mask is None
                        else point_mask[None], method, knn_topk_fn)
        return idx[0], mask[0]
    if method not in ("exact", "approx"):
        raise ValueError(f"knn: unknown method {method!r}; expected "
                         "'exact' or 'approx'")
    b, n, _ = pos.shape
    if method == "approx" and point_mask is None and n >= k:
        idx = knn_topk_fn(pos, k, quantized=True)
        return idx, torch.ones(idx.shape, dtype=torch.bool,
                               device=pos.device)

    uniform = point_mask is None and n >= k
    scores = exact_scores(pos, None if uniform else point_mask)
    if uniform:
        idx = top_k(scores, k)[1]
        return idx.to(torch.int32), torch.ones(idx.shape, dtype=torch.bool,
                                               device=pos.device)
    neg_d, idx = top_k(scores, k)
    nbr_mask = neg_d > -_BIG / 2
    self_idx = torch.arange(n, device=pos.device)[None, :, None]
    idx = torch.where(nbr_mask, idx, self_idx)
    return idx.to(torch.int32), nbr_mask


def knn_tiled(pos, k: int, tile: int = 2048):
    """Tiled exact kNN of one large cloud, ``pos [N, 3]``: ``O(N tile)``
    memory, the query rows a tile at a time against the whole cloud (JAX
    ``knn_tiled``, its cloud zero-padded to a multiple of ``tile`` with the
    padded columns masked). A tile's scores are ``-d^2`` as JAX rounds
    them (``squared_norms``, a full f32 product), the self loop pinned on
    top, and the selection XLA ``top_k``'s (:func:`top_k` with
    ``select``), so equal distances go lowest index first, as in JAX.

    Returns ``(nbr_idx [N, K] int32, nbr_mask [N, K] bool)``, self in slot
    0; padded slots (a cloud of fewer than ``k`` points) are clamped to
    self with ``mask=False``."""
    n = pos.shape[0]
    n_pad = n + (-n) % tile
    pos_p = torch.nn.functional.pad(pos, (0, 0, 0, n_pad - n))
    sq = squared_norms(pos_p)  # [n_pad]
    cols = torch.arange(n_pad, device=pos.device)
    idx_t, neg_t = [], []
    for q0 in range(0, n, tile):  # the padded query rows are dropped
        q1 = min(q0 + tile, n)
        d2 = sq[q0:q1, None] + sq[None, :] - 2.0 * torch.matmul(
            pos_p[q0:q1], pos_p.T)
        d2 = torch.where(cols[None, :] < n, d2, _BIG)
        d2 = torch.where(cols[q0:q1, None] == cols[None, :], -_BIG, d2)
        neg, idx = top_k(-d2, k, select=True)
        idx_t.append(idx)
        neg_t.append(neg)
    idx, neg = torch.cat(idx_t), torch.cat(neg_t)
    nbr_mask = neg > -_BIG / 2
    idx = torch.where(nbr_mask, idx, cols[:n, None])
    return idx.to(torch.int32), nbr_mask


def exact_scores(pos, point_mask=None):
    """The ``[B, N, N]`` f32 scores the exact route selects the top k of
    (JAX's, term for term). Without ``point_mask``: ``2 xi.xj - |xj|^2``
    (``|xi|^2 - d^2``: the row-constant ``|xi|^2`` does not change the
    order), the self loop pinned on top. With it: ``-d^2``, masked
    columns at ``-1e30``, the self loop pinned on top."""
    n = pos.shape[1]
    sq = squared_norms(pos)  # [B, N]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    dot = torch.matmul(pos, pos.transpose(1, 2))  # [B, N, N]
    if point_mask is None:
        s = 2.0 * dot - sq[:, None, :]
        return s + torch.where(eye, 2.0 * _BIG, 0.0)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * dot
    d2 = torch.where(point_mask.to(torch.bool)[:, None, :], d2, _BIG)
    return -(d2 - torch.where(eye, 2.0 * _BIG, 0.0))
