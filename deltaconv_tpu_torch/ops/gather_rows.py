"""Component-major neighbour-table gather (CUDA kernel + plain version).

``gather_rows(table, idx)``: ``[B, N, C], [B, N, K] -> [B, C, K, N]``
with ``out[b, c, k, n] = table[b, idx[b, n, k], c]``, the layout the
edge-plane math of the operator build (:mod:`.wls_fused`) works on.
Counterpart of ``deltaconv_tpu/ops/gather_rows.py`` (forward only; the
kernel is ``csrc/gather_rows.cu``).
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["gather_rows", "gather_rows_plain"]


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``torch.gather`` + a permute."""
    b, n, c = table.shape
    k = idx.shape[-1]
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    rows = torch.gather(table, 1, flat).reshape(b, n, k, c)
    return rows.permute(0, 3, 2, 1).contiguous()


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    b, n, c = table.shape
    k = idx.shape[-1]
    device = _lib.check_inputs("gather_rows", [
        ("table", table, torch.float32, (b, n, c)),
        ("idx", idx, torch.int32, (b, n, k)),
    ])
    out = torch.empty((b, c, k, n), dtype=torch.float32, device=device)
    _lib.launch("gather_rows", device, table.data_ptr(), idx.data_ptr(),
                out.data_ptr(), b, n, c, k)
    return out
