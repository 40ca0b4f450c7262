"""Neighbour gather + eval MLP + masked max (CUDA kernels + plain
versions), the scalar max branch of a depth >= 2 DeltaConv in bf16
serving.

``gather_mlp_max(x, ws, affines, idx, mask, centralized, skip_slot0, z0,
epilogue)``: ``x [B, N, C_in]`` (gathered as bf16), per-layer weights
``ws[i] [C_i, C_{i+1}]`` (the last one sign-pre-folded by the caller),
the intermediate layers' eval BatchNorm affines ``affines[i] = (a, b)``
(``[C_{i+1}]`` f32 each), ``idx``/``mask [B, N, K]``. Per valid slot
``k >= k0`` (``k0 = 1`` with ``skip_slot0``) it computes

    e = x[idx_k]            (minus the point's own row when centralized,
                             the difference in f32 rounded to bf16)
    h = bf16(LeakyReLU(bf16(h @ W_i) * a_i + b_i))   layers 0 .. L-2
    z = bf16(h @ W_last)    (f32 accumulation)

and the max over those slots. ``z0`` (requires ``skip_slot0``) is the
self slot computed by the caller, a ``[C_out]`` row (the centralized
zero edge) or ``[B, N, C_out]`` rows (rounded to bf16), merged where
``mask[..., 0]``. With ``epilogue = (sign, inv, mean, bias)`` (requires
``z0``) the result is ``LeakyReLU((sign * best - mean) * inv + bias)``
in bf16, 0 on rows with no valid slot, the best value not rounded to
bf16 first; without it the f32 best values, ``-3e38`` on rows with no
valid covered slot.

On CUDA tensors a centralized call runs the fused kernel
``gather_mlp_max`` (the MLP of every edge, whose input depends on both
ends). Otherwise ``z(x[j])`` is the same for every point that gathers
row ``j``, so the call runs the MLP once a point (``mlp_rows``: ``[B, N,
C_in] -> [B, N, C_out]`` bf16) and then the masked max over those rows
with the self slot and the epilogue (``gather_max_merge``): the same
function at ``1 / (K - 1)`` of the products.

Counterpart of ``deltaconv_tpu/ops/gather_mlp_max.py`` (its ``_reference``
plus the self-slot merge and epilogue of its ``_kernel``); the kernels
are in ``csrc/gather_mlp_max.cu``. Forward only (eval). Every affine
operation is rounded on its own in every version; the kernels sum each
product on the tensor cores in another order than the plain version's
f32 matmul, so a bf16-rounded product may differ by one ulp and carry
through the next layer.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib
from .gather_max import NEG, _pad_last

__all__ = ["gather_max_merge", "gather_max_merge_plain", "gather_mlp_max",
           "gather_mlp_max_plain", "mlp_chain", "mlp_rows", "mlp_rows_plain"]


def _leaky(x):
    return torch.where(x >= 0, x, 0.2 * x)


def mlp_chain(h, ws, affines):
    """The eval MLP with the kernel's rounding, on ``h [..., C_in]``:
    bf16 operands, f32 products (exact for bf16 values) and sums, each
    product rounded to bf16; the intermediate affine and LeakyReLU in
    f32, rounded to bf16. Returns the last layer's bf16 values in f32."""
    h = h.to(torch.bfloat16)
    for w, (a, b) in zip(ws[:-1], affines):
        y = torch.matmul(h.float(), w.to(torch.bfloat16).float())
        y = y.to(torch.bfloat16).float()
        h = _leaky(y * a + b).to(torch.bfloat16)
    z = torch.matmul(h.float(), ws[-1].to(torch.bfloat16).float())
    return z.to(torch.bfloat16).float()


def _check_args(ws, affines, skip_slot0, z0, epilogue):
    if len(affines) != len(ws) - 1:
        raise ValueError(f"gather_mlp_max: {len(ws)} layers need "
                         f"{len(ws) - 1} intermediate affines, got "
                         f"{len(affines)}")
    if z0 is not None and not skip_slot0:
        raise ValueError("gather_mlp_max: z0 is the self slot, so it "
                         "requires skip_slot0=True")
    if epilogue is not None and z0 is None:
        raise ValueError("gather_mlp_max: the epilogue requires z0")


def _epilogue(best, epilogue, mask):
    sign, inv, mean, bias = (torch.as_tensor(a, device=best.device).float()
                             for a in epilogue)
    o = _leaky((sign * best - mean) * inv + bias)
    valid = mask.any(dim=-1, keepdim=True)
    return torch.where(valid, o, 0.0).to(torch.bfloat16)


def _masked_best(z, mask, k0, z0, epilogue):
    """The max over the valid slots ``k >= k0`` of ``z [B, N, K, C]``,
    the self slot ``z0`` where ``mask[..., 0]``, the epilogue."""
    slots = torch.arange(z.shape[2], device=mask.device) >= k0
    best = torch.where((mask & slots)[..., None], z, NEG).amax(dim=2)
    if z0 is not None:
        z0v = z0.float() if z0.dim() == 1 else z0.to(torch.bfloat16).float()
        best = torch.maximum(best, torch.where(mask[..., :1], z0v, NEG))
    if epilogue is None:
        return best
    return _epilogue(best, epilogue, mask)


def _gather(t, idx):
    """``t [B, N, C]`` rows at ``idx [B, N, K]`` -> ``[B, N, K, C]``."""
    b, n, c = t.shape
    k = idx.shape[-1]
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    return torch.gather(t, 1, flat).reshape(b, n, k, c)


def gather_mlp_max_plain(x, ws, affines, idx, mask, centralized=False,
                         skip_slot0=False, z0=None, epilogue=None):
    """Plain version: materializes the ``[B, N, K, C]`` edges (gather,
    then :func:`mlp_chain` on every slot), the masked ``amax``, the
    self-slot merge and the epilogue."""
    _check_args(ws, affines, skip_slot0, z0, epilogue)
    xb = x.to(torch.bfloat16)
    e = _gather(xb, idx)
    if centralized:
        e = (e.float() - xb.float()[:, :, None, :]).to(torch.bfloat16)
    return _masked_best(mlp_chain(e, ws, affines), mask,
                        1 if skip_slot0 else 0, z0, epilogue)


def mlp_rows_plain(x, ws, affines):
    """Plain version of :func:`mlp_rows`: :func:`mlp_chain` in bf16."""
    return mlp_chain(x, ws, affines).to(torch.bfloat16)


def gather_max_merge_plain(rows, idx, mask, k0=0, z0=None, epilogue=None):
    """Plain version of :func:`gather_max_merge`: the ``[B, N, K, C]``
    gather of the rows, the masked ``amax``, the self slot, the
    epilogue."""
    return _masked_best(_gather(rows.to(torch.bfloat16), idx).float(), mask,
                        k0, z0, epilogue)


def _pack_b(w, rows, cols, out):
    """``w [K, N]`` zero-padded to ``[rows, cols]`` (multiples of 16),
    bf16, in the B-fragment order of ``mma.m16n8k16``: for k-step ``s``,
    column pair ``p`` and lane ``(g, t)``, 8 bf16 = ``W[16s + 2t + {0, 1}]
    [16p + g]``, ``W[16s + 8 + 2t + {0, 1}][16p + g]``, then the same at
    column ``16p + 8 + g``. Written into ``out`` (``rows * cols`` bf16) in
    one copy."""
    if w.shape != (rows, cols):
        w = torch.nn.functional.pad(
            w, (0, cols - w.shape[1], 0, rows - w.shape[0]))
    # k = 16 s + 8 h + 2 t + e, n = 16 p + 8 j + g -> [s, p, g, t, j, h, e]
    src = w.reshape(rows // 16, 2, 4, 2, cols // 16, 2, 8).permute(
        0, 4, 6, 2, 5, 1, 3)
    out.view(src.shape).copy_(src)
    return out


def _mlp_operands(name, x, ws, affines):
    """Checks the MLP's widths; returns the widths padded to multiples of
    16, ``x`` padded, the packed weights, the padded affines (one f32
    vector) and the widths as a ctypes array."""
    widths = [x.shape[-1]] + [w.shape[1] for w in ws]
    for i, w in enumerate(ws):
        if w.dim() != 2 or w.shape[0] != widths[i]:
            raise ValueError(f"{name}(ws[{i}]): shape {tuple(w.shape)}, "
                             f"expected ({widths[i]}, C)")
    padded = [-(-c // 16) * 16 for c in widths]
    device = x.device
    xp = _pad_last(x.to(torch.bfloat16), 16).contiguous()
    sizes = [a * b for a, b in zip(padded[:-1], padded[1:])]
    w = torch.empty(sum(sizes), dtype=torch.bfloat16, device=device)
    for i, part in enumerate(torch.split(w, sizes)):
        _pack_b(ws[i], padded[i], padded[i + 1], part)
    aff = torch.cat([_pad_last(torch.as_tensor(v, device=device).float(),
                               padded[i + 1])
                     for i, ab in enumerate(affines) for v in ab]
                    or [torch.zeros(1, device=device)])
    for arg, t in (("x", xp), ("ws", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}({arg}): the kernel's loads need "
                             f"16-byte aligned data")
    return padded, xp, w, aff, (ctypes.c_int * len(padded))(*padded)


def _launch_mlp_rows(xp, w, aff, padded, dims):
    """``xp [..., C_0]`` (padded) -> ``[..., C_L]`` bf16 (padded)."""
    rows = xp.reshape(-1, padded[0])
    device = _lib.check_inputs("mlp_rows", [
        ("x", rows, torch.bfloat16, (None, padded[0])),
        ("ws", w, torch.bfloat16, (None,)),
        ("affines", aff, torch.float32, (None,))])
    out = torch.empty((rows.shape[0], padded[-1]), dtype=torch.bfloat16,
                      device=device)
    _lib.launch("mlp_rows", device, rows.data_ptr(), w.data_ptr(),
                aff.data_ptr(), out.data_ptr(), dims, len(padded) - 1,
                rows.shape[0])
    return out.view(*xp.shape[:-1], padded[-1])


def mlp_rows(x, ws, affines):
    """The eval MLP of every row: ``x [..., C_in] -> [..., C_out]`` bf16,
    rounded as :func:`mlp_chain`. Plain version for CPU tensors; the CUDA
    kernel (tensor cores) for CUDA tensors, on widths zero-padded to
    multiples of 16 here."""
    if x.device.type == "cpu":
        return mlp_rows_plain(x, ws, affines)
    if len(affines) != len(ws) - 1:
        raise ValueError(f"mlp_rows: {len(ws)} layers need {len(ws) - 1} "
                         f"intermediate affines, got {len(affines)}")
    padded, xp, w, aff, dims = _mlp_operands("mlp_rows", x, ws, affines)
    out = _launch_mlp_rows(xp, w, aff, padded, dims)
    c_out = ws[-1].shape[1]
    return out[..., :c_out].contiguous() if padded[-1] != c_out else out


def _self_and_epilogue(z0, epilogue, c_out, cp_out, device):
    """``(z0_mode, z0 padded, epilogue [4, cp_out] f32)``: mode 0 none, 1
    a ``[C]`` f32 row, 2 ``[B, N, C]`` rows in f32 (the kernels round them
    to bf16 as they read them; the caller's rows are f32)."""
    z0_mode, z0p = 0, None
    if z0 is not None:
        z0_mode = 1 if z0.dim() == 1 else 2
        z0p = _pad_last(z0.float(), cp_out).contiguous()
    epi = None
    if epilogue is not None:
        epi = torch.stack([_pad_last(torch.as_tensor(a, device=device)
                                     .float().reshape(c_out), cp_out)
                           for a in epilogue]).contiguous()
    return z0_mode, z0p, epi


def _z0_epi_specs(z0_mode, z0p, epi, b, n, c):
    specs = []
    if z0p is not None:
        specs.append(("z0", z0p, torch.float32,
                      (c,) if z0_mode == 1 else (b, n, c)))
    if epi is not None:
        specs.append(("epilogue", epi, torch.float32, (4, c)))
    return specs


def _launch_merge(rows, idx, mask, k0, z0_mode, z0p, epi):
    b, n, c = rows.shape
    k = idx.shape[-1]
    device = _lib.check_inputs("gather_max_merge", [
        ("rows", rows, torch.bfloat16, (b, n, c)),
        ("idx", idx, torch.int32, (b, n, k)),
        ("mask", mask, torch.bool, (b, n, k))]
        + _z0_epi_specs(z0_mode, z0p, epi, b, n, c))
    if rows.data_ptr() % 16:
        raise ValueError("gather_max_merge(rows): the kernel's loads need "
                         "16-byte aligned data")
    out = torch.empty((b, n, c),
                      dtype=torch.float32 if epi is None else torch.bfloat16,
                      device=device)
    _lib.launch("gather_max_merge", device, rows.data_ptr(), idx.data_ptr(),
                mask.data_ptr(), 0 if z0p is None else z0p.data_ptr(),
                0 if epi is None else epi.data_ptr(), out.data_ptr(), b, n,
                c, k, k0, z0_mode)
    return out


def gather_max_merge(rows, idx, mask, k0=0, z0=None, epilogue=None):
    """The masked max of ``rows [B, N, C]`` (bf16) over the slots ``k >=
    k0`` of ``idx``/``mask [B, N, K]``, the self slot ``z0`` (a ``[C]``
    row or ``[B, N, C]`` rows) merged where ``mask[..., 0]``, and the
    epilogue ``(sign, inv, mean, bias)``, as :func:`gather_mlp_max` ends:
    f32 without the epilogue (``-3e38`` on rows with no valid covered
    slot), bf16 with it (0 on rows with no valid slot). Plain version for
    CPU tensors; the CUDA kernel for CUDA tensors, on rows zero-padded
    here to a multiple of 8 channels."""
    if rows.device.type == "cpu":
        return gather_max_merge_plain(rows, idx, mask, k0, z0, epilogue)
    c = rows.shape[-1]
    cp = -(-c // 8) * 8
    rp = _pad_last(rows.to(torch.bfloat16), 8).contiguous()
    out = _launch_merge(rp, idx, mask, int(k0),
                        *_self_and_epilogue(z0, epilogue, c, cp, rows.device))
    return out[..., :c].contiguous() if cp != c else out


def gather_mlp_max(x, ws, affines, idx, mask, centralized=False,
                   skip_slot0=False, z0=None, epilogue=None):
    """Plain version for CPU tensors; the CUDA kernels (tensor cores) for
    CUDA tensors: the fused ``gather_mlp_max`` when centralized, else
    ``mlp_rows`` then ``gather_max_merge``. The kernels take widths that
    are multiples of 16: the input, the weights, the affines, ``z0`` and
    the epilogue are zero-padded here (a zero column adds nothing and a
    zero affine keeps a padded channel at 0), and the padded outputs
    dropped."""
    if x.device.type == "cpu":
        return gather_mlp_max_plain(x, ws, affines, idx, mask, centralized,
                                    skip_slot0, z0, epilogue)
    _check_args(ws, affines, skip_slot0, z0, epilogue)
    b, n, _ = x.shape
    k = idx.shape[-1]
    k0 = 1 if skip_slot0 else 0
    padded, xp, w, aff, dims = _mlp_operands("gather_mlp_max", x, ws,
                                             affines)
    c_out, cp_out = ws[-1].shape[1], padded[-1]
    z0_mode, z0p, epi = _self_and_epilogue(z0, epilogue, c_out, cp_out,
                                           x.device)
    if not centralized:
        rows = _launch_mlp_rows(xp, w, aff, padded, dims)
        out = _launch_merge(rows, idx, mask, k0, z0_mode, z0p, epi)
        return out[..., :c_out].contiguous() if cp_out != c_out else out
    device = _lib.check_inputs("gather_mlp_max", [
        ("x", xp, torch.bfloat16, (b, n, padded[0])),
        ("idx", idx, torch.int32, (b, n, k)),
        ("mask", mask, torch.bool, (b, n, k)),
        ("ws", w, torch.bfloat16, (None,)),
        ("affines", aff, torch.float32, (None,))]
        + _z0_epi_specs(z0_mode, z0p, epi, b, n, cp_out))
    out = torch.empty((b, n, cp_out),
                      dtype=torch.float32 if epi is None else torch.bfloat16,
                      device=device)
    _lib.launch("gather_mlp_max", device, xp.data_ptr(), idx.data_ptr(),
                mask.data_ptr(), w.data_ptr(), aff.data_ptr(),
                0 if z0p is None else z0p.data_ptr(),
                0 if epi is None else epi.data_ptr(), out.data_ptr(), dims,
                len(ws), b, n, k, k0, z0_mode)
    return out[..., :c_out].contiguous() if cp_out != c_out else out
