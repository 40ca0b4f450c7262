"""Masked neighbour max, forward (CUDA kernel + plain version).

``gather_max(h, idx, mask)``: ``[B, N, C], [B, N, K], [B, N, K] ->
[B, N, C]``, the max over valid slots of the gathered neighbour rows;
rows with no valid neighbour give ``-3e38``. :func:`masked_nbr_max`
turns those into 0, as the scalar-stream aggregation of every DeltaConv
needs. Counterpart of ``deltaconv_tpu/ops/gather_max.py`` (``gather_max``
forward without winner tracking, ``masked_nbr_max``); the kernel is
``csrc/gather_max.cu``.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["NEG", "gather_max", "gather_max_plain", "masked_nbr_max"]

NEG = -3.0e38  # ~ -inf in f32, safe to negate and compare


def gather_max_plain(h: torch.Tensor, idx: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: gather, then a masked ``amax``."""
    b, n, c = h.shape
    k = idx.shape[-1]
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    g = torch.gather(h, 1, flat).reshape(b, n, k, c)
    return torch.where(mask[..., None], g, NEG).amax(dim=2)


def gather_max(h: torch.Tensor, idx: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if h.device.type == "cpu":
        return gather_max_plain(h, idx, mask)
    b, n, c = h.shape
    k = idx.shape[-1]
    device = _lib.check_inputs("gather_max", [
        ("h", h, torch.float32, (b, n, c)),
        ("idx", idx, torch.int32, (b, n, k)),
        ("mask", mask, torch.bool, (b, n, k)),
    ])
    out = torch.empty_like(h)
    _lib.launch("gather_max", device, h.data_ptr(), idx.data_ptr(),
                mask.data_ptr(), out.data_ptr(), b, n, c, k)
    return out


def masked_nbr_max(h, nbr_idx, nbr_mask, gather_max_fn=gather_max):
    """:func:`gather_max` with all-masked rows (padded points) set to 0.
    ``gather_max_fn`` selects the kernel or its plain version."""
    out = gather_max_fn(h, nbr_idx, nbr_mask)
    return torch.where(nbr_mask.any(dim=-1, keepdim=True), out, 0.0)
