"""Gather + edge planes + WLS in one kernel: the fused eval build (CUDA
kernel + plain version).

Counterpart of ``deltaconv_tpu/ops/fused_build.py``.
``fused_gather_wls(pos, normal, x_basis, y_basis, idx, mask, avg)``:
``[B, N, 3]`` f32 positions, normals and tangent frames, ``[B, N, K]``
neighbour indices (the point itself in slot 0, as JAX requires: the
centre of every edge is slot 0's row) and edge mask, ``[B]`` per-cloud
mean edge length -> ``(grad_coef, div_coef [B, 2, N, K] f32, row_norm
[B, N] f32)``. The coefficients are those of
:func:`~.wls_fused.edge_planes` + :func:`~.wls_fused.wls` with ``avg`` in
plane 11, UNNORMALIZED: the per-cloud infinity norm is deferred to the
operators' ``scale`` (``geometry/dense.py``), and ``row_norm = sqrt(s1^2
+ s2^2)`` with ``s_d = sum_k |g_d|`` gives it. Forward only, as JAX's.

The kernel (``csrc/fused_build.cu``) gathers each edge's neighbour rows
directly in f32 and builds the eleven planes in registers; nothing of
the ``[B, 12, K, N]`` plane tensor reaches device memory. Two routes on
CUDA tensors, chosen by shape as the WLS forward's
(:func:`~.wls_fused.wls_split`): the split route ``fused_gather_wls`` (a
point's K edges over S warps, each warp's edges gathered once into
registers, every sum over K in a fixed order) up to 40 edges a point, and
the direct route ``fused_gather_wls_direct`` (one thread a point over all
K edges in each pass) above. The JAX kernel
gathered the table as bf16 ``hi + lo`` halves by one-hot products (about
16 mantissa bits), a TPU artifact the port does not copy.
:func:`fused_dense_build` then assembles the bf16 dense operators with
the densify kernel on the ``[B, 2, N, K]`` planes.
"""

from __future__ import annotations

import torch

from . import _lib
from .gather_rows import gather_rows_plain
from .wls_fused import edge_planes_tables, wls_plain, wls_split

__all__ = ["fused_dense_build", "fused_gather_wls", "fused_gather_wls_plain"]


def _check(pos, idx, avg):
    if pos.dim() != 3 or pos.shape[-1] != 3 or idx.dim() != 3 or \
            idx.shape[:2] != pos.shape[:2] or avg.shape != pos.shape[:1]:
        raise ValueError(f"fused_gather_wls: pos {tuple(pos.shape)}, idx "
                         f"{tuple(idx.shape)}, avg {tuple(avg.shape)}; "
                         "expected [B, N, 3], [B, N, K] and [B]")


def fused_gather_wls_plain(pos, normal, x_basis, y_basis, idx, mask, avg,
                           kernel_width: float = 1.0,
                           regularizer: float = 0.001):
    """The plain PyTorch version: slot 0's rows as the centres,
    ``edge_planes_tables`` with ``avg`` given, ``wls_plain``, the row
    norms."""
    _check(pos, idx, avg)
    b, n, _ = pos.shape
    table = torch.cat([pos, x_basis, y_basis], dim=-1).float()
    slot0 = idx[..., :1].long().expand(b, n, 3)

    def centre(a):
        return torch.gather(a.float(), 1, slot0)

    edges = edge_planes_tables(
        table, centre(pos), centre(normal), centre(x_basis),
        centre(y_basis), idx, mask.to(torch.bool),
        torch.ones((b, n), device=pos.device), gather_rows_plain,
        lambda total, count: avg.float())
    g, d = wls_plain(edges, kernel_width, regularizer)  # [B, 2, K, N]
    s = g.abs().sum(dim=2)  # [B, 2, N]
    row_norm = torch.sqrt(s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1])
    return (g.transpose(2, 3).contiguous(), d.transpose(2, 3).contiguous(),
            row_norm)


def fused_gather_wls(pos, normal, x_basis, y_basis, idx, mask, avg,
                     kernel_width: float = 1.0, regularizer: float = 0.001):
    """Plain version for CPU tensors; for CUDA tensors the split route
    (``fused_gather_wls``) or, above 40 edges a point, the direct route
    (``fused_gather_wls_direct``)."""
    if pos.device.type == "cpu":
        return fused_gather_wls_plain(pos, normal, x_basis, y_basis, idx,
                                      mask, avg, kernel_width, regularizer)
    return _fused_gather_wls(pos, normal, x_basis, y_basis, idx, mask, avg,
                             kernel_width, regularizer)


def _fused_gather_wls(pos, normal, x_basis, y_basis, idx, mask, avg,
                      kernel_width=1.0, regularizer=0.001, slices=None):
    """:func:`fused_gather_wls` on CUDA tensors, on the split route with
    ``slices`` warps a block (None: :func:`~.wls_fused.wls_split`'s; 0:
    the direct route)."""
    _check(pos, idx, avg)
    b, n, _ = pos.shape
    k = idx.shape[-1]
    mask_u8 = mask.to(torch.bool).contiguous().view(torch.uint8)
    device = _lib.check_inputs("fused_gather_wls", [
        ("pos", pos, torch.float32, (b, n, 3)),
        ("normal", normal, torch.float32, (b, n, 3)),
        ("x_basis", x_basis, torch.float32, (b, n, 3)),
        ("y_basis", y_basis, torch.float32, (b, n, 3)),
        ("idx", idx, torch.int32, (b, n, k)),
        ("mask", mask_u8, torch.uint8, (b, n, k)),
        ("avg", avg, torch.float32, (b,)),
    ])
    gc = torch.empty((b, 2, n, k), dtype=torch.float32, device=device)
    dc = torch.empty_like(gc)
    rn = torch.empty((b, n), dtype=torch.float32, device=device)
    if slices is None:
        slices = wls_split(k)[0]
    args = (pos.data_ptr(), normal.data_ptr(), x_basis.data_ptr(),
            y_basis.data_ptr(), idx.data_ptr(), mask_u8.data_ptr(),
            avg.data_ptr(), gc.data_ptr(), dc.data_ptr(), rn.data_ptr(), b, n,
            k)
    tail = (float(kernel_width), float(regularizer))
    if slices:
        _lib.launch("fused_gather_wls", device, *args, slices, *tail)
    else:
        _lib.launch("fused_gather_wls_direct", device, *args, *tail)
    return gc, dc, rn


def fused_dense_build(pos, normal, x_basis, y_basis, idx, mask, avg,
                      kernel_width: float = 1.0, regularizer: float = 0.001,
                      ops=None):
    """The eval build's dense assembly: ``ops.fused_gather_wls``, then
    ``ops.densify_coefs`` in bf16 on its ``[B, 2, N, K]`` planes. Returns
    ``(w_grad, w_div [B, 2, N, N] bf16, row_norm [B, N] f32)``,
    unnormalized. ``ops`` (None: the kernels) selects the kernels or
    their plain versions."""
    if ops is None:
        from . import KERNEL_OPS as ops
    gc, dc, rn = ops.fused_gather_wls(pos, normal, x_basis, y_basis, idx,
                                      mask, avg, kernel_width, regularizer)
    wg, wd = ops.densify_coefs(idx, gc, dc, torch.bfloat16, planes=True)
    return wg, wd, rn
