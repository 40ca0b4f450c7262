"""Dense grad/div operator assembly, f32 (CUDA kernel + plain version).

``densify_coefs(idx, grad_coef, div_coef)``: ``[B, N, K]`` indices and
``[B, N, K, 2]`` per-edge coefficients -> ``(w_grad, w_div)``, each
``[B, 2, N, N]`` with ``w[b, d, n, idx[b, n, k]] += coef[b, n, k, d]``.
Duplicate columns SUM (padded kNN slots are clamped to self with zero
coefficients). Counterpart of ``deltaconv_tpu/ops/densify_op.py``
(``densify_coefs`` with ``dtype_name="float32"``, forward only); the
kernel is ``csrc/densify.cu``.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["densify_coefs", "densify_coefs_plain"]


def densify_coefs_plain(idx, grad_coef, div_coef):
    """The plain PyTorch version: ``scatter_add_`` on zeros."""
    b, n, k = idx.shape
    index = idx.long()[:, None].expand(b, 2, n, k)

    def one(coef):
        w = torch.zeros((b, 2, n, n), dtype=torch.float32,
                        device=coef.device)
        return w.scatter_add_(3, index, coef.permute(0, 3, 1, 2).float())

    return one(grad_coef), one(div_coef)


def densify_coefs(idx, grad_coef, div_coef):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if idx.device.type == "cpu":
        return densify_coefs_plain(idx, grad_coef, div_coef)
    b, n, k = idx.shape
    device = _lib.check_inputs("densify", [
        ("idx", idx, torch.int32, (b, n, k)),
        ("grad_coef", grad_coef, torch.float32, (b, n, k, 2)),
        ("div_coef", div_coef, torch.float32, (b, n, k, 2)),
    ])
    w_grad = torch.empty((b, 2, n, n), dtype=torch.float32, device=device)
    w_div = torch.empty_like(w_grad)
    _lib.launch("densify", device, idx.data_ptr(), grad_coef.data_ptr(),
                div_coef.data_ptr(), w_grad.data_ptr(), w_div.data_ptr(),
                b, n, k)
    return w_grad, w_div
