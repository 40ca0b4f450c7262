"""The coefficients' cotangent of an operator apply, a sampled product
(CUDA kernel + plain version).

``coef_cotangent(feat, ct, idx)``, with ``idx [B, N, K]`` i32 and the
result ``[B, N, K, 2]`` f32, in one of two modes chosen by ``feat``:

- grad: ``feat = x [B, N, C]``, ``ct [B, N, 2, C]`` -> ``d[b, n, k, e] =
  sum_c x[b, idx[b, n, k], c] * ct[b, n, e, c]``;
- div: ``feat = v [B, N, 2, C]``, ``ct [B, N, C]`` -> ``d[b, n, k, e] =
  sum_c v[b, idx[b, n, k], e, c] * ct[b, n, c]``.

An index outside ``[0, N)`` gives 0. This is the cotangent of
``coef_apply_grad`` / ``coef_apply_div`` with respect to their
coefficients and, since a dense operator is its coefficients scattered to
their columns, of the dense applies too (:mod:`..geometry.dense`): only
the edges' entries of the ``[B, 2, N, N]`` operator cotangent, which the
dense route no longer forms. Each dot is taken in f64 (the f32 products
are exact) and rounded once to f32: the plain version is an ``einsum``
on f64 rows gathered by ``torch.gather``; the kernel
(``csrc/coef_cotangent.cu``) sums in a fixed order of its own, so two
calls give the same bits and the two agree to within one f32 ulp where
their f64 sums round apart (or to the f64 summation bound where the dot
cancels to near zero).

``ct`` may have any strides: the dense grad's cotangent is the transposed
view of a ``[B, 2, N, C]`` product. The kernel reads it through its
strides when its channels are contiguous; the wrapper makes any other
``ct`` contiguous first, and ``feat`` always. f32 only (bf16 features:
widen them first, exactly).
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["coef_cotangent", "coef_cotangent_plain"]


def _mode(feat, ct, idx):
    """``(is_div, C)``; raises on shapes that fit neither mode."""
    b, n, k = idx.shape
    if feat.dim() == 3:
        c = feat.shape[-1]
        want_f, want_c = (b, n, c), (b, n, 2, c)
    elif feat.dim() == 4 and feat.shape[2] == 2:
        c = feat.shape[-1]
        want_f, want_c = (b, n, 2, c), (b, n, c)
    else:
        raise ValueError(f"coef_cotangent(feat): shape {tuple(feat.shape)}, "
                         "expected [B, N, C] (grad) or [B, N, 2, C] (div)")
    for arg, t, want in (("feat", feat, want_f), ("ct", ct, want_c)):
        if tuple(t.shape) != want:
            raise ValueError(f"coef_cotangent({arg}): shape "
                             f"{tuple(t.shape)}, expected {want}")
    return feat.dim() == 4, c


def coef_cotangent_plain(feat: torch.Tensor, ct: torch.Tensor,
                         idx: torch.Tensor,
                         order: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: the neighbour rows gathered in f64
    (``torch.gather``; zero rows for indices outside ``[0, N)``), an f64
    ``einsum`` with the cotangent rows, rounded to f32 (``order`` changes
    nothing)."""
    div, c = _mode(feat, ct, idx)
    b, n, k = idx.shape
    inside = (idx >= 0) & (idx < n)
    j = torch.where(inside, idx, 0).long().reshape(b, n * k, 1)
    flat = feat.reshape(b, n, -1).double()
    rows = torch.gather(flat, 1, j.expand(b, n * k, flat.shape[-1]))
    rows = torch.where(inside.reshape(b, n * k, 1), rows, 0.0)
    if div:
        d = torch.einsum("bnkec,bnc->bnke", rows.view(b, n, k, 2, c),
                         ct.double())
    else:
        d = torch.einsum("bnkc,bnec->bnke", rows.view(b, n, k, c),
                         ct.double())
    return d.float()


def coef_cotangent(feat: torch.Tensor, ct: torch.Tensor, idx: torch.Tensor,
                   order: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version for CPU tensors; the ``coef_cotangent`` kernel for
    CUDA tensors (f32 ``feat`` and ``ct``). ``order`` (``[B, N]`` i32, a
    permutation of each cloud's points, e.g. a gather plan's Morton order)
    is the order in which the kernel walks the points, so that points
    that share neighbour rows run together; the result does not depend on
    it (an entry outside ``[0, N)`` walks no point: a point it leaves out
    is not written)."""
    if feat.device.type == "cpu":
        return coef_cotangent_plain(feat, ct, idx)
    div, c = _mode(feat, ct, idx)
    b, n, k = idx.shape
    feat = feat.contiguous()
    if ct.stride(-1) != 1:
        ct = ct.contiguous()
    specs = [("feat", feat, torch.float32, tuple(feat.shape)),
             ("ct", ct, torch.float32, tuple(ct.shape)),
             ("idx", idx, torch.int32, (b, n, k))]
    if order is not None:
        specs.append(("order", order, torch.int32, (b, n)))
    device = _lib.check_inputs("coef_cotangent", specs, strided=("ct",))
    out = torch.empty((b, n, k, 2), dtype=torch.float32, device=device)
    sb, sn = ct.stride(0), ct.stride(1)
    se = 0 if div else ct.stride(2)
    _lib.launch("coef_cotangent", device, feat.data_ptr(), ct.data_ptr(),
                idx.data_ptr(), 0 if order is None else order.data_ptr(),
                out.data_ptr(), b, n, c, k, int(div), sb, sn, se)
    return out
