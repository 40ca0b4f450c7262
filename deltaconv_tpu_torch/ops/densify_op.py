"""Dense grad/div operator assembly, f32, bf16 or int8 (CUDA kernels +
plain versions).

``densify_coefs(idx, grad_coef, div_coef, dtype)``: ``[B, N, K]``
indices and ``[B, N, K, 2]`` per-edge coefficients -> ``(w_grad,
w_div)``, each ``[B, 2, N, N]`` in ``dtype`` (f32 or bf16) with
``w[b, d, n, idx[b, n, k]] += coef[b, n, k, d]``. Duplicate columns SUM
in f32 (padded kNN slots are clamped to self with zero coefficients);
bf16 rounds that sum once, to nearest even. Counterpart of
``deltaconv_tpu/ops/densify_op.py`` (``densify_coefs`` with
``dtype_name`` "float32" or "bfloat16"); the kernels are
``csrc/densify.cu``. ``planes=True`` takes the coefficients as ``[B, 2,
N, K]`` planes (the fused eval build's layout, JAX's
``densify_coef_planes``), the same kernel on other strides.

Differentiable in the coefficients, as the JAX ``custom_vjp`` is: the
VJP is a row-local gather, ``d_coef[b, n, k, d] = dW[b, d, n, idx[b, n,
k]]`` (:func:`densify_bwd`, the ``densify_bwd`` kernel, counterpart of
``_densify_bwd``), the cotangents read as f32 and the result returned in
the coefficients' dtype. The models' dense applies do not take this
route: on a build differentiated in its coefficients :func:`densify`
(``geometry/dense.py``) assembles ``W`` without a graph and each apply
gives the coefficients their cotangent by ``ops.coef_cotangent``, so no
``[B, 2, N, N]`` cotangent is formed.

``densify_coefs_int8(idx, grad_coef, div_coef)`` -> ``(w_grad, w_div,
s_grad, s_div)``: the int8 serving form (``densify_coefs_int8`` of the
JAX module, forward only), ``W ~= W_q * s`` with one scale a cloud and
operator. Per cloud ``s = max(max |coef|, 1e-30)`` over the grad (or
div) coefficients, each coefficient quantized to ``clip(round(coef / s
* 127), -127, 127)`` (the division first, then the product, rounded half
to even), the quantized values of a column ADDED (a clamped padded slot
adds 0), and the scales returned as ``s / 127``. On CUDA tensors three
launches and no torch op: the ``absmax`` kernel on each coefficient
tensor (the per-cloud maxima, XLA outside the ``pallas_call`` in JAX),
then the ``densify_int8`` kernel, which forms the scales, quantizes, and
builds the rows of the four planes in shared memory, each output byte
written once by 16-byte stores.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["DENSIFY_IMAGE", "DENSIFY_SLOTS", "densify_bwd",
           "densify_bwd_plain", "densify_coefs", "densify_coefs_int8",
           "densify_coefs_int8_plain", "densify_coefs_plain",
           "densify_int8_block", "densify_int8_smem"]

_KERNEL = {torch.float32: "densify", torch.bfloat16: "densify_bf16"}


def _check_dtype(dtype):
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in _KERNEL:
        raise ValueError(f"densify: dtype {dtype}, expected float32 or "
                         "bfloat16 (int8 operators: densify_coefs_int8)")
    return dtype


def _stacked(coef, planes):
    """``coef`` as ``[B, N, K, 2]`` (a view of ``[B, 2, N, K]`` planes)."""
    return coef.permute(0, 2, 3, 1) if planes else coef


def _scatter_planes(idx, coef, dtype):
    """``[B, 2, N, N]`` f32 ``scatter_add_`` of ``coef [B, N, K, 2]`` on
    zeros, cast to ``dtype``."""
    b, n, k = idx.shape
    index = idx.long()[:, None].expand(b, 2, n, k)
    w = torch.zeros((b, 2, n, n), dtype=torch.float32, device=coef.device)
    w.scatter_add_(3, index, coef.permute(0, 3, 1, 2).float())
    return w.to(dtype)


def densify_coefs_plain(idx, grad_coef, div_coef, dtype=torch.float32,
                        planes=False):
    """The plain PyTorch version: f32 ``scatter_add_`` on zeros, then
    the cast to ``dtype`` (differentiable by autograd)."""
    dtype = _check_dtype(dtype)
    return (_scatter_planes(idx, _stacked(grad_coef, planes), dtype),
            _scatter_planes(idx, _stacked(div_coef, planes), dtype))


def _densify_kernel(idx, grad_coef, div_coef, dtype, planes):
    if idx.device.type == "cpu":
        return densify_coefs_plain(idx, grad_coef, div_coef, dtype, planes)
    b, n, k = idx.shape
    name = _KERNEL[dtype]
    shape = (b, 2, n, k) if planes else (b, n, k, 2)
    device = _lib.check_inputs(name, [
        ("idx", idx, torch.int32, (b, n, k)),
        ("grad_coef", grad_coef, torch.float32, shape),
        ("div_coef", div_coef, torch.float32, shape),
    ])
    w_grad = torch.empty((b, 2, n, n), dtype=dtype, device=device)
    w_div = torch.empty_like(w_grad)
    _lib.launch(name, device, idx.data_ptr(), grad_coef.data_ptr(),
                div_coef.data_ptr(), w_grad.data_ptr(), w_div.data_ptr(),
                b, n, k, int(planes))
    return w_grad, w_div


def densify_bwd_plain(idx, dwg, dwd):
    """The plain PyTorch version of the VJP: ``torch.gather`` of the f32
    cotangents at the edges' columns, ``[B, N, K, 2]`` each."""
    b, n, k = idx.shape
    index = idx.long()[:, None].expand(b, 2, n, k)
    return tuple(torch.gather(dw.float(), 3, index).permute(0, 2, 3, 1)
                 .contiguous() for dw in (dwg, dwd))


def densify_bwd(idx, dwg, dwd):
    """``idx [B, N, K]`` and the cotangents ``dwg, dwd [B, 2, N, N]`` (read
    as f32) -> ``(d_grad_coef, d_div_coef)`` ``[B, N, K, 2]`` f32 with
    ``d[b, n, k, c] = dW[b, c, n, idx[b, n, k]]``. Plain version for CPU
    tensors; the ``densify_bwd`` kernel for CUDA tensors."""
    if idx.device.type == "cpu":
        return densify_bwd_plain(idx, dwg, dwd)
    b, n, k = idx.shape
    dwg = dwg.float().contiguous()
    dwd = dwd.float().contiguous()
    device = _lib.check_inputs("densify_bwd", [
        ("idx", idx, torch.int32, (b, n, k)),
        ("dwg", dwg, torch.float32, (b, 2, n, n)),
        ("dwd", dwd, torch.float32, (b, 2, n, n)),
    ])
    d_grad = torch.empty((b, n, k, 2), dtype=torch.float32, device=device)
    d_div = torch.empty_like(d_grad)
    _lib.launch("densify_bwd", device, idx.data_ptr(), dwg.data_ptr(),
                dwd.data_ptr(), d_grad.data_ptr(), d_div.data_ptr(), b, n, k)
    return d_grad, d_div


class _Densify(torch.autograd.Function):
    """:func:`densify_coefs` with its VJP (:func:`densify_bwd`), gradient
    for the coefficients only."""

    @staticmethod
    def forward(ctx, idx, grad_coef, div_coef, dtype, planes):
        ctx.save_for_backward(idx)
        ctx.dtypes = (grad_coef.dtype, div_coef.dtype)
        ctx.planes = planes
        return _densify_kernel(idx, grad_coef.detach(), div_coef.detach(),
                               dtype, planes)

    @staticmethod
    def backward(ctx, dwg, dwd):
        (idx,) = ctx.saved_tensors
        d_grad, d_div = densify_bwd(idx, dwg, dwd)
        if ctx.planes:
            d_grad = d_grad.permute(0, 3, 1, 2).contiguous()
            d_div = d_div.permute(0, 3, 1, 2).contiguous()
        return (None, d_grad.to(ctx.dtypes[0]), d_div.to(ctx.dtypes[1]),
                None, None)


def densify_coefs(idx, grad_coef, div_coef, dtype=torch.float32,
                  planes=False):
    """Plain version for CPU tensors; the CUDA kernel of ``dtype`` for
    CUDA tensors. Differentiable in the coefficients (f32 and bf16
    bodies)."""
    dtype = _check_dtype(dtype)
    if torch.is_grad_enabled() and (grad_coef.requires_grad
                                    or div_coef.requires_grad):
        return _Densify.apply(idx, grad_coef, div_coef, dtype, planes)
    return _densify_kernel(idx, grad_coef, div_coef, dtype, planes)


def _cloud_scale(coef):
    """``max(max |coef|, 1e-30)`` of each cloud, ``[B]`` f32 (the plain
    version's; the kernel forms it from ``absmax``'s maxima)."""
    amax = torch.linalg.vector_norm(coef, float("inf"), dim=(1, 2, 3))
    return torch.clamp(amax, min=1e-30)


def densify_coefs_int8_plain(idx, grad_coef, div_coef):
    """The plain PyTorch version: the quantization in torch ops, the
    quantized values placed by f32 ``scatter_add_`` on zeros (exact:
    small integers), then the cast to int8."""
    sg, sd = _cloud_scale(grad_coef), _cloud_scale(div_coef)

    def quantized(coef, s):
        q = torch.round(coef / s[:, None, None, None] * 127.0)
        return _scatter_planes(idx, torch.clamp(q, -127.0, 127.0),
                               torch.int8)

    return (quantized(grad_coef, sg), quantized(div_coef, sd),
            sg / 127.0, sd / 127.0)


# The int8 assembly's tasks (csrc/densify.cu): a block builds R rows of W
# columns of the four planes in shared memory, at most DENSIFY_IMAGE bytes
# a plane (W = N up to it, R = 1 and chunks of DENSIFY_IMAGE columns
# above), R K slots at most DENSIFY_SLOTS where R > 1.
DENSIFY_IMAGE = 8192
DENSIFY_SLOTS = 1024
SMEM_MAX = 232_448  # a block's shared memory on the H100


def densify_int8_block(n: int, k: int) -> tuple[int, int]:
    """``(rows, width)`` of a ``densify_int8`` task for clouds of ``n``
    points and ``k`` slots: whole rows, as many as DENSIFY_IMAGE bytes and
    DENSIFY_SLOTS slots allow (8 at N=1024, K=20; 4 at N=2048, K=30), or
    one row in chunks of DENSIFY_IMAGE columns above that width."""
    if n > DENSIFY_IMAGE:
        return 1, DENSIFY_IMAGE
    return max(1, min(DENSIFY_IMAGE // max(n, 1),
                      DENSIFY_SLOTS // max(k, 1))), n


def densify_int8_smem(rows: int, width: int, k: int) -> int:
    """Shared memory of one ``densify_int8`` block, as
    ``densify_int8_smem_bytes`` in the CUDA source counts it: four plane
    images of ``rows * width`` bytes with room for a 16-byte alignment
    shift, and ``rows * k`` slots of 8 bytes."""
    return 4 * (rows * width // 16 + 2) * 16 + rows * k * 8


def densify_coefs_int8(idx, grad_coef, div_coef):
    """Plain version for CPU tensors; for CUDA tensors ``absmax`` of each
    coefficient tensor, then the ``densify_int8`` kernel (scales,
    quantization and the planes' rows built in shared memory)."""
    if idx.device.type == "cpu":
        return densify_coefs_int8_plain(idx, grad_coef, div_coef)
    b, n, k = idx.shape
    device = _lib.check_inputs("densify_int8", [
        ("idx", idx, torch.int32, (b, n, k)),
        ("grad_coef", grad_coef, torch.float32, (b, n, k, 2)),
        ("div_coef", div_coef, torch.float32, (b, n, k, 2)),
    ])
    return _densify_int8_launch(device, idx, grad_coef, div_coef)


def _densify_int8_launch(device, idx, grad_coef, div_coef):
    """The launches of :func:`densify_coefs_int8` into new outputs: the
    clouds' ``|coef|`` maxima of both tensors (viewed ``[B, N K, 2]``)
    into one ``[2, B]`` buffer, which ``absmax`` zero-fills, then the
    assembly on the task of :func:`densify_int8_block`."""
    b, n, k = idx.shape
    rows, width = densify_int8_block(n, k)
    if densify_int8_smem(rows, width, k) > SMEM_MAX:
        raise ValueError(f"densify_int8: {k} slots a row need more shared "
                         f"memory than a block has")
    amax = torch.empty((2, b), dtype=torch.float32, device=idx.device)
    for i, coef in enumerate((grad_coef, div_coef)):
        _lib.launch("absmax", device, coef.data_ptr(),
                    amax.data_ptr() + 4 * b * i, b, n * k, 2, 0)
    w_grad = torch.empty((b, 2, n, n), dtype=torch.int8, device=idx.device)
    w_div = torch.empty_like(w_grad)
    s_grad = torch.empty((b,), dtype=torch.float32, device=idx.device)
    s_div = torch.empty_like(s_grad)
    _lib.launch("densify_int8", device, idx.data_ptr(), grad_coef.data_ptr(),
                div_coef.data_ptr(), amax.data_ptr(), s_grad.data_ptr(),
                s_div.data_ptr(), w_grad.data_ptr(), w_div.data_ptr(), b, n,
                k, rows, width)
    return w_grad, w_div, s_grad, s_div
