"""Fused kNN scores + top-k (CUDA kernel + plain version).

``knn_topk(pos, k, quantized)``: ``pos [B, N, 3]`` f32 -> ``idx [B, N,
K]`` int32, the K columns with the largest score ``s = 2 q.p - |p|^2``
(``= |q|^2 - d^2``) of every row, the self loop pinned to slot 0, N >= K,
no mask. Counterpart of ``deltaconv_tpu/ops/knn_topk.py`` (``knn_topk``
without ``return_mean_dist``, which only the fused operator build uses):

- exact (``quantized=False``): K rounds of "maximum score, the lowest
  column among ties, then remove it";
- packed keys (``quantized=True``): each row's scores are quantized
  linearly to 16 bits over the row's range and packed with the column
  into one int32, so the order is exact at the row's range / 65534 and
  ties go to the lowest column. Above 65535 points the column no longer
  fits the low 16 bits and the exact body runs, as in JAX.

The scores are computed elementwise in the JAX kernel's order (not as a
matmul), so the kernel (``csrc/knn_topk.cu``) and the plain version
give the same indices bit for bit.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["knn_topk", "knn_topk_plain"]

_BIG = 1e30
_MAX_PACKED_N = 65535  # the column rides in the key's low 16 bits


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


def knn_topk_plain(pos, k: int, quantized: bool = False):
    """The plain PyTorch version: the score plane, then the packed keys'
    ``topk`` (unique keys: no ties) or K exact sweeps."""
    _check(pos, k)
    b, n, _ = pos.shape
    s = _scores(pos)
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
        return (65535 - (best & 65535)).to(torch.int32)
    s = torch.where(is_self, 2.0 * _BIG, s)
    wins = []
    for _ in range(k):
        best = s.amax(dim=-1, keepdim=True)
        win = torch.where(s >= best, col, n).amin(dim=-1, keepdim=True)
        wins.append(win)
        s = torch.where(col == win, -_BIG, s)
    return torch.cat(wins, dim=-1).to(torch.int32)


def knn_topk(pos, k: int, quantized: bool = False):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if pos.device.type == "cpu":
        return knn_topk_plain(pos, k, quantized)
    _check(pos, k)
    b, n, _ = pos.shape
    device = _lib.check_inputs("knn_topk",
                               [("pos", pos, torch.float32, (b, n, 3))])
    idx = torch.empty((b, n, k), dtype=torch.int32, device=device)
    _lib.launch("knn_topk", device, pos.data_ptr(), idx.data_ptr(), b, n, k,
                int(quantized and n <= _MAX_PACKED_N))
    return idx
