"""Fused neighbour gather + eval MLP per edge + masked max (CUDA kernel +
plain version), the scalar max branch of a depth >= 2 DeltaConv in bf16
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

Counterpart of ``deltaconv_tpu/ops/gather_mlp_max.py`` (its ``_reference``
plus the self-slot merge and epilogue of its ``_kernel``); the kernel is
``csrc/gather_mlp_max.cu``. Forward only (eval). Every affine operation
is rounded on its own in both versions; the kernel sums each product on
the tensor cores in another order than the plain version's f32 matmul,
so a bf16-rounded product may differ by one ulp and carry through the
next layer.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib
from .gather_max import NEG, _pad_last

__all__ = ["gather_mlp_max", "gather_mlp_max_plain", "mlp_chain"]


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


def gather_mlp_max_plain(x, ws, affines, idx, mask, centralized=False,
                         skip_slot0=False, z0=None, epilogue=None):
    """Plain version: materializes the ``[B, N, K, C]`` edges (gather,
    then :func:`mlp_chain` on every slot), the masked ``amax``, the
    self-slot merge and the epilogue."""
    _check_args(ws, affines, skip_slot0, z0, epilogue)
    b, n, c = x.shape
    k = idx.shape[-1]
    xb = x.to(torch.bfloat16)
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    e = torch.gather(xb, 1, flat).reshape(b, n, k, c)
    if centralized:
        e = (e.float() - xb.float()[:, :, None, :]).to(torch.bfloat16)
    z = mlp_chain(e, ws, affines)
    slots = torch.arange(k, device=idx.device) >= (1 if skip_slot0 else 0)
    best = torch.where((mask & slots)[..., None], z, NEG).amax(dim=2)
    if z0 is not None:
        z0v = z0.float() if z0.dim() == 1 else z0.to(torch.bfloat16).float()
        best = torch.maximum(best, torch.where(mask[..., :1], z0v, NEG))
    if epilogue is None:
        return best
    return _epilogue(best, epilogue, mask)


def gather_mlp_max(x, ws, affines, idx, mask, centralized=False,
                   skip_slot0=False, z0=None, epilogue=None):
    """Plain version for CPU tensors; the CUDA kernel (tensor cores) for
    CUDA tensors. The kernel takes widths that are multiples of 16: the
    input, the weights, the affines, ``z0`` and the epilogue are
    zero-padded here (a zero column adds nothing and a zero affine keeps
    a padded channel at 0), and the padded outputs dropped."""
    if x.device.type == "cpu":
        return gather_mlp_max_plain(x, ws, affines, idx, mask, centralized,
                                    skip_slot0, z0, epilogue)
    _check_args(ws, affines, skip_slot0, z0, epilogue)
    b, n, c_in = x.shape
    k = idx.shape[-1]
    widths = [c_in] + [w.shape[1] for w in ws]
    for i, w in enumerate(ws):
        if w.dim() != 2 or w.shape[0] != widths[i]:
            raise ValueError(f"gather_mlp_max(ws[{i}]): shape "
                             f"{tuple(w.shape)}, expected ({widths[i]}, C)")
    padded = [-(-c // 16) * 16 for c in widths]
    c_out, cp_out = widths[-1], padded[-1]
    device = x.device

    def pad2(t, rows, cols):
        return torch.nn.functional.pad(
            t, (0, cols - t.shape[-1], 0, rows - t.shape[-2]))

    xp = _pad_last(x.to(torch.bfloat16), 16).contiguous()
    w = torch.cat([pad2(wi.to(torch.bfloat16), padded[i], padded[i + 1])
                   .reshape(-1) for i, wi in enumerate(ws)])
    aff = torch.cat([_pad_last(torch.as_tensor(v, device=device).float(),
                               padded[i + 1])
                     for i, ab in enumerate(affines) for v in ab]
                    or [torch.zeros(1, device=device)])
    z0_mode, z0p = 0, None
    if z0 is not None:
        z0_mode = 1 if z0.dim() == 1 else 2
        z0p = _pad_last(z0.float() if z0_mode == 1 else
                        z0.to(torch.bfloat16), 16).contiguous()
    epi = None
    if epilogue is not None:
        epi = torch.stack([_pad_last(torch.as_tensor(a, device=device)
                                     .float().reshape(c_out), 16)
                           for a in epilogue]).contiguous()
    specs = [("x", xp, torch.bfloat16, (b, n, padded[0])),
             ("idx", idx, torch.int32, (b, n, k)),
             ("mask", mask, torch.bool, (b, n, k)),
             ("ws", w, torch.bfloat16, (None,)),
             ("affines", aff, torch.float32, (None,))]
    if z0p is not None:
        specs.append(("z0", z0p, z0p.dtype,
                      (cp_out,) if z0_mode == 1 else (b, n, cp_out)))
    if epi is not None:
        specs.append(("epilogue", epi, torch.float32, (4, cp_out)))
    device = _lib.check_inputs("gather_mlp_max", specs)
    for arg, t, align in (("x", xp, 16), ("ws", w, 32)):
        if t.data_ptr() % align:
            raise ValueError(f"gather_mlp_max({arg}): the kernel's loads "
                             f"need {align}-byte aligned data")
    out = torch.empty((b, n, cp_out),
                      dtype=torch.float32 if epi is None else torch.bfloat16,
                      device=device)
    dims = (ctypes.c_int * len(padded))(*padded)
    _lib.launch("gather_mlp_max", device, xp.data_ptr(), idx.data_ptr(),
                mask.data_ptr(), w.data_ptr(), aff.data_ptr(),
                0 if z0p is None else z0p.data_ptr(),
                0 if epi is None else epi.data_ptr(), out.data_ptr(), dims,
                len(ws), b, n, k, int(centralized), 1 if skip_slot0 else 0,
                z0_mode)
    return out[..., :c_out].contiguous() if cp_out != c_out else out
