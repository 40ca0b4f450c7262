"""Exact k-nearest neighbours with the self loop in slot 0 (counterpart
of ``deltaconv_tpu/geometry/knn.py``, ``method="exact"``).

The scores are one batched ``[N, 3] @ [3, N]`` product plus rank-1
terms, then ``torch.topk`` per row: the JAX package uses XLA's
``top_k`` here, not a Pallas kernel. The product must run in full f32
(no TF32): a coarser product reorders near-tied neighbours.
"""

from __future__ import annotations

import torch

__all__ = ["knn"]

_BIG = 1e30


def knn(pos, k: int, point_mask=None):
    """Brute-force kNN over a batch of clouds.

    Args:
      pos: ``[B, N, 3]`` positions.
      k: neighbours, **including** the self loop, always in slot 0.
      point_mask: optional ``[B, N]`` bool validity; invalid points are
        never returned as neighbours.

    Returns:
      ``(nbr_idx [B, N, K] int32, nbr_mask [B, N, K] bool)``; padded
      slots (fewer than ``k`` valid points) are clamped to self with
      ``mask=False``.
    """
    b, n, _ = pos.shape
    sq = (pos * pos).sum(dim=-1)  # [B, N]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    dot = torch.matmul(pos, pos.transpose(1, 2))  # [B, N, N]

    if point_mask is None and n >= k:
        # score = 2 xi.xj - |xj|^2 = |xi|^2 - d^2 (the row-constant |xi|^2
        # does not change the order); the self loop is pinned on top.
        s = 2.0 * dot - sq[:, None, :]
        s = s + torch.where(eye, 2.0 * _BIG, 0.0)
        idx = torch.topk(s, k, dim=-1).indices
        return idx.to(torch.int32), torch.ones(idx.shape, dtype=torch.bool,
                                               device=pos.device)

    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * dot
    if point_mask is not None:
        d2 = torch.where(point_mask.to(torch.bool)[:, None, :], d2, _BIG)
    d2 = d2 - torch.where(eye, 2.0 * _BIG, 0.0)
    neg_d, idx = torch.topk(-d2, k, dim=-1)
    nbr_mask = neg_d > -_BIG / 2
    self_idx = torch.arange(n, device=pos.device)[None, :, None]
    idx = torch.where(nbr_mask, idx, self_idx)
    return idx.to(torch.int32), nbr_mask
