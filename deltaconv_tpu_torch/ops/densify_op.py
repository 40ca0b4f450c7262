"""Dense grad/div operator assembly, f32 or bf16 (CUDA kernels + plain
version).

``densify_coefs(idx, grad_coef, div_coef, dtype)``: ``[B, N, K]``
indices and ``[B, N, K, 2]`` per-edge coefficients -> ``(w_grad,
w_div)``, each ``[B, 2, N, N]`` in ``dtype`` (f32 or bf16) with
``w[b, d, n, idx[b, n, k]] += coef[b, n, k, d]``. Duplicate columns SUM
in f32 (padded kNN slots are clamped to self with zero coefficients);
bf16 rounds that sum once, to nearest even. Counterpart of
``deltaconv_tpu/ops/densify_op.py`` (``densify_coefs`` with
``dtype_name`` "float32" or "bfloat16", forward only); the kernels are
``csrc/densify.cu``.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["densify_coefs", "densify_coefs_plain"]

_KERNEL = {torch.float32: "densify", torch.bfloat16: "densify_bf16"}


def _check_dtype(dtype):
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in _KERNEL:
        raise ValueError(f"densify: dtype {dtype}, expected float32 or "
                         "bfloat16 (int8 operators: ROADMAP slice F)")
    return dtype


def densify_coefs_plain(idx, grad_coef, div_coef, dtype=torch.float32):
    """The plain PyTorch version: f32 ``scatter_add_`` on zeros, then
    the cast to ``dtype``."""
    dtype = _check_dtype(dtype)
    b, n, k = idx.shape
    index = idx.long()[:, None].expand(b, 2, n, k)

    def one(coef):
        w = torch.zeros((b, 2, n, n), dtype=torch.float32,
                        device=coef.device)
        w.scatter_add_(3, index, coef.permute(0, 3, 1, 2).float())
        return w.to(dtype)

    return one(grad_coef), one(div_coef)


def densify_coefs(idx, grad_coef, div_coef, dtype=torch.float32):
    """Plain version for CPU tensors; the CUDA kernel of ``dtype`` for
    CUDA tensors."""
    dtype = _check_dtype(dtype)
    if idx.device.type == "cpu":
        return densify_coefs_plain(idx, grad_coef, div_coef, dtype)
    b, n, k = idx.shape
    name = _KERNEL[dtype]
    device = _lib.check_inputs(name, [
        ("idx", idx, torch.int32, (b, n, k)),
        ("grad_coef", grad_coef, torch.float32, (b, n, k, 2)),
        ("div_coef", div_coef, torch.float32, (b, n, k, 2)),
    ])
    w_grad = torch.empty((b, 2, n, n), dtype=dtype, device=device)
    w_div = torch.empty_like(w_grad)
    _lib.launch(name, device, idx.data_ptr(), grad_coef.data_ptr(),
                div_coef.data_ptr(), w_grad.data_ptr(), w_div.data_ptr(),
                b, n, k)
    return w_grad, w_div
