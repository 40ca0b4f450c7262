"""Coefficient-form operator applies, the large-cloud path (CUDA kernels +
plain versions).

``coef_apply_grad(x, coef, idx)``: ``[B, N, C], [B, N, K, 2], [B, N, K]
-> [B, N, 2, C]`` with ``y[n, d, c] = sum_k coef[n, k, d] *
x[idx[n, k], c]``; ``coef_apply_div(v, coef, idx)``: ``[B, N, 2, C] ->
[B, N, C]`` with ``y[n, c] = sum_k sum_d coef[n, k, d] * v[idx[n, k], d,
c]``. Features f32 or bf16, coefficients f32; the result in the
features' dtype. The products and sums are f32, each rounded on its own,
slot by slot in order (div: component 0's product, then component 1's),
cast once at the end, as the JAX TPU kernel computes them; kernel and
plain version are bit-equal. Masked edges carry zero coefficients, so
no mask is read. Counterpart of ``deltaconv_tpu/ops/coef_apply.py``; the
kernels are ``csrc/coef_apply.cu``.

Differentiated, each apply is an autograd Function with the JAX VJP:
the features' cotangent forms the f32 edge rows edge-major, channels
fastest (``einsum`` into ``[B, N, K, C]``; for div ``[B, N, K, 2, C]``,
viewed as ``[B, N, K, 2C]``, the flattened rows of ``v``), and hands
their ``[B, C, K, N]`` view to :func:`~.gather_rows.scatter_rows`, which
reads it through its strides (no layout copy), cast to the features'
dtype; the coefficients' cotangent, the sampled product
:func:`~.coef_cotangent.coef_cotangent` (f64 dots rounded to f32, no
edge tensor, the points walked in the gather plan's Morton order where a
plan is given), is formed only when asked for. No backward kernel runs
for an input that does not require grad. :func:`coef_apply_grad` and
:func:`coef_apply_div` run the kernels (forward and backward),
``*_plain`` the plain versions.

Two kernel routes, chosen by shape (the same bits either way):

- ``coef_apply_grad`` / ``coef_apply_div``: a group of lanes a point,
  16-byte (or the widest aligned) row loads, several slots' loads in
  flight; any shape, the only route without a plan.
- ``coef_apply_grad_plan`` / ``coef_apply_div_plan``: with a
  :class:`CoefPlan` (:func:`coef_plan`, built once a forward from the
  positions and the neighbour lists), for rows of a multiple of 16 bytes
  and at least ``_PLAN_MIN_ROW_BYTES``: a block a run of ``R`` points
  adjacent in Morton order stages the run's distinct neighbour rows in
  shared memory once and sums out of it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _lib
from .coef_cotangent import coef_cotangent, coef_cotangent_plain
from .gather_rows import scatter_rows, scatter_rows_plain

__all__ = ["CoefPlan", "coef_apply_div", "coef_apply_div_plain",
           "coef_apply_grad", "coef_apply_grad_plain", "coef_plan",
           "coef_plan_plain"]

_FEATURES = (torch.float32, torch.bfloat16)

# The gather plan: points a run (fewer where R * K would exceed the runs
# kernel's 1024 edges), the narrowest component row the planned route
# takes (narrower rows gain little from shared memory: route A), and the
# shared-memory budget of its staged rows (a block's channel chunk).
_PLAN_RUN = 32
_PLAN_EDGES = 1024
_PLAN_MIN_ROW_BYTES = 256
_PLAN_SMEM = 48 * 1024
_PLAN_MAX_N = (1 << 22) - 1  # the runs kernel keys an id in 22 bits
_PLAN_CHUNK = 1024  # points a block of the order kernel sorts
_PADDED_CODE = 1 << 30  # above every 30-bit Morton code


class CoefPlan(NamedTuple):
    """The gather plan of one forward's neighbour lists.

    Attributes:
      order: ``[B, N]`` int32: per cloud, the points sorted (stably) by
        the Morton code of their positions quantized to 10 bits an axis
        in the cloud's bounding box; padded points last.
      run_rows: ``[B * n_runs, run * K]`` int32: each run's distinct
        neighbour ids, ascending (``-1`` for ids outside ``[0, N)``, and
        after ``run_count``). Run ``r`` of cloud ``b`` is ``order[b, r *
        run : (r + 1) * run]`` (row ``b * n_runs + r``); a run never
        crosses a cloud.
      run_count: ``[B * n_runs]`` int32: distinct rows of each run.
      local_slot: ``[B, N, K]`` int16: edge ``(n, k)``'s place in its
        run's ``run_rows``.
      run: points a run.
    """

    order: torch.Tensor
    run_rows: torch.Tensor
    run_count: torch.Tensor
    local_slot: torch.Tensor
    run: int


def _run_length(k: int) -> int:
    return min(_PLAN_RUN, _PLAN_EDGES // max(k, 1))


def _spread_plain(q):
    """Bit i of each 10-bit ``q`` moved to bit ``3 i`` (int64)."""
    out = torch.zeros_like(q)
    for bit in range(10):
        out |= ((q >> bit) & 1) << (3 * bit)
    return out


def _morton_codes_plain(pos, point_mask):
    """``[B, N]`` int32 Morton codes (axis ``a`` at bits ``3 i + a``) of
    the positions quantized in each cloud's box of valid points; padded
    points get ``_PADDED_CODE``. The same f32 operations as the order
    kernel: ``t = (p - lo) * (1023 / (hi - lo))``, truncated."""
    valid = (torch.ones(pos.shape[:2], dtype=torch.bool, device=pos.device)
             if point_mask is None else point_mask)
    inf = torch.tensor(float("inf"), device=pos.device)
    lo = torch.where(valid[..., None], pos, inf).amin(dim=1)
    hi = torch.where(valid[..., None], pos, -inf).amax(dim=1)
    ext = hi - lo
    scale = torch.where(hi > lo, torch.full_like(ext, 1023.0) / ext, 0.0)
    t = (pos - lo[:, None]) * scale[:, None]
    q = t.to(torch.int64).clamp(max=1023)
    code = (_spread_plain(q[..., 0]) | (_spread_plain(q[..., 1]) << 1)
            | (_spread_plain(q[..., 2]) << 2))
    return torch.where(valid, code, _PADDED_CODE).to(torch.int32)


def _plan_runs_plain(idx, order, run):
    """``(run_rows, run_count, local_slot)`` of the runs of ``order``:
    each run's edge ids (``N`` for one outside ``[0, N)``) sorted stably,
    the first of each id ranked: the rank is the edge's local slot and
    the ranked ids the run's rows, as the runs kernel computes them."""
    b, n, k = idx.shape
    n_runs = -(-n // run)
    pad = n + 1  # above every id; sorts last
    ids = torch.gather(idx.long(), 1, order.long()[..., None].expand(b, n, k))
    ids = torch.where((ids >= 0) & (ids < n), ids, n).reshape(b, n * k)
    ids = torch.nn.functional.pad(ids, (0, (n_runs * run - n) * k),
                                  value=pad).reshape(b * n_runs, run * k)
    srt, where = torch.sort(ids, dim=1, stable=True)
    fresh = srt != pad
    fresh[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    rank = torch.cumsum(fresh, dim=1) - 1
    count = fresh.sum(dim=1)
    run_rows = torch.full((b * n_runs, run * k), -1, dtype=torch.int32,
                          device=idx.device)
    rows = torch.arange(b * n_runs, device=idx.device)[:, None].expand_as(srt)
    run_rows[rows[fresh], rank[fresh]] = torch.where(
        srt[fresh] < n, srt[fresh], -1).to(torch.int32)
    by_edge = torch.empty_like(rank).scatter_(1, where, rank)
    in_order = by_edge.reshape(b, n_runs * run, k)[:, :n]
    local_slot = torch.empty((b, n, k), dtype=torch.int16, device=idx.device)
    local_slot.scatter_(1, order.long()[..., None].expand(b, n, k),
                        in_order.to(torch.int16))
    return run_rows, count.to(torch.int32), local_slot


def _plan_fits(idx) -> bool:
    b, n, k = idx.shape
    return k <= _PLAN_EDGES and n <= _PLAN_MAX_N


def coef_plan_plain(pos, idx, point_mask=None):
    """:func:`coef_plan` through torch operations on any device (None
    where no plan fits: ``K > 1024`` or ``N >= 2^22``)."""
    if not _plan_fits(idx):
        return None
    run = _run_length(idx.shape[-1])
    order = torch.sort(_morton_codes_plain(pos.float(), point_mask), dim=1,
                       stable=True).indices.to(torch.int32)
    return CoefPlan(order, *_plan_runs_plain(idx, order, run), run)


def coef_plan(pos, idx, point_mask=None):
    """The gather plan of ``idx [B, N, K]`` on the clouds ``pos [B, N,
    3]`` (``point_mask [B, N]``: padded points go last): the plain version
    on CPU tensors; on CUDA tensors the ``coef_plan_order`` kernels (the
    Morton codes of each 1024-point chunk sorted by a block, then each
    point ranked against the cloud's other chunks) and the
    ``coef_plan_runs`` kernel (a block a run). None where no plan fits
    (the applies then take route A)."""
    if pos.device.type == "cpu":
        return coef_plan_plain(pos, idx, point_mask)
    if not _plan_fits(idx):
        return None
    b, n, k = idx.shape
    run = _run_length(k)
    n_runs = -(-n // run)
    pos = pos.detach().float().contiguous()
    specs = [("pos", pos, torch.float32, (b, n, 3))]
    if point_mask is not None:
        specs.append(("point_mask", point_mask, torch.bool, (b, n)))
    device = _lib.check_inputs("coef_plan_order", specs)
    keys = torch.empty((b, -(-n // _PLAN_CHUNK) * _PLAN_CHUNK),
                       dtype=torch.int64, device=device)
    order = torch.empty((b, n), dtype=torch.int32, device=device)
    _lib.launch("coef_plan_order", device, pos.data_ptr(),
                0 if point_mask is None else point_mask.data_ptr(),
                keys.data_ptr(), order.data_ptr(), b, n)
    _lib.check_inputs("coef_plan_runs", [("idx", idx, torch.int32, (b, n, k))])
    run_rows = torch.empty((b * n_runs, run * k), dtype=torch.int32,
                           device=device)
    run_count = torch.empty((b * n_runs,), dtype=torch.int32, device=device)
    local_slot = torch.empty((b, n, k), dtype=torch.int16, device=device)
    _lib.launch("coef_plan_runs", device, idx.data_ptr(), order.data_ptr(),
                run_rows.data_ptr(), run_count.data_ptr(),
                local_slot.data_ptr(), b, n, k, run)
    return CoefPlan(order, run_rows, run_count, local_slot, run)


def _slot_rows(t, idx, k):
    """Rows ``t[b, idx[b, n, k]]`` of ``t [B, N, ...]``, in f32."""
    b, n = idx.shape[:2]
    flat = t.reshape(b, n, -1).float()
    index = idx[:, :, k, None].long().expand(b, n, flat.shape[-1])
    return torch.gather(flat, 1, index).reshape(t.shape)


def _grad_plain(x, coef, idx):
    acc0 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    acc1 = torch.zeros_like(acc0)
    for k in range(idx.shape[-1]):
        xk = _slot_rows(x, idx, k)
        acc0 = acc0 + xk * coef[:, :, k, 0, None]
        acc1 = acc1 + xk * coef[:, :, k, 1, None]
    return torch.stack([acc0, acc1], dim=2).to(x.dtype)


def _div_plain(v, coef, idx):
    acc = torch.zeros(v[:, :, 0].shape, dtype=torch.float32, device=v.device)
    for k in range(idx.shape[-1]):
        vk = _slot_rows(v, idx, k)
        acc = acc + vk[:, :, 0] * coef[:, :, k, 0, None]
        acc = acc + vk[:, :, 1] * coef[:, :, k, 1, None]
    return acc.to(v.dtype)


def _planned(feat, plan) -> bool:
    """Route B: a plan, rows of a multiple of 16 bytes and at least
    ``_PLAN_MIN_ROW_BYTES``, a 16-byte aligned table."""
    rb = feat.shape[-1] * feat.element_size()
    return (plan is not None and rb % 16 == 0 and rb >= _PLAN_MIN_ROW_BYTES
            and feat.data_ptr() % 16 == 0)


def _launch_apply(name, feat, coef, idx, out_shape, plan):
    b, n = feat.shape[:2]
    c = feat.shape[-1]
    k = idx.shape[-1]
    if feat.dtype not in _FEATURES:
        raise TypeError(f"{name}(features): dtype {feat.dtype}, expected "
                        "torch.float32 or torch.bfloat16")
    device = _lib.check_inputs(name, [
        ("features", feat, feat.dtype, tuple(feat.shape)),
        ("coef", coef, torch.float32, (b, n, k, 2)),
        ("idx", idx, torch.int32, (b, n, k)),
    ])
    out = torch.empty(out_shape, dtype=feat.dtype, device=device)
    bf16 = int(feat.dtype == torch.bfloat16)
    if not _planned(feat, plan):
        _lib.launch(name, device, feat.data_ptr(), coef.data_ptr(),
                    idx.data_ptr(), out.data_ptr(), b, n, c, k, bf16)
        return out
    name += "_plan"
    r = plan.run
    n_runs = -(-n // r)
    _lib.check_inputs(name, [
        ("order", plan.order, torch.int32, (b, n)),
        ("run_rows", plan.run_rows, torch.int32, (b * n_runs, r * k)),
        ("run_count", plan.run_count, torch.int32, (b * n_runs,)),
        ("local_slot", plan.local_slot, torch.int16, (b, n, k)),
    ])
    n_comp = 2 if feat.dim() == 4 else 1
    budget = max(_PLAN_SMEM, 16 * n_comp * r * k)
    _lib.launch(name, device, feat.data_ptr(), coef.data_ptr(),
                plan.order.data_ptr(), plan.run_rows.data_ptr(),
                plan.run_count.data_ptr(), plan.local_slot.data_ptr(),
                out.data_ptr(), b, n, c, k, r, budget, bf16)
    return out


def _grad_kernel(x, coef, idx, plan=None):
    if x.device.type == "cpu":
        return _grad_plain(x, coef, idx)
    b, n, c = x.shape
    return _launch_apply("coef_apply_grad", x, coef, idx, (b, n, 2, c), plan)


def _div_kernel(v, coef, idx, plan=None):
    if v.device.type == "cpu":
        return _div_plain(v, coef, idx)
    if v.dim() != 4 or v.shape[2] != 2:
        raise ValueError(f"coef_apply_div(v): shape {tuple(v.shape)}, "
                         "expected [B, N, 2, C]")
    b, n, _, c = v.shape
    return _launch_apply("coef_apply_div", v, coef, idx, (b, n, c), plan)


def _grad_plain_route(x, coef, idx, plan=None):
    return _grad_plain(x, coef, idx)


def _div_plain_route(v, coef, idx, plan=None):
    return _div_plain(v, coef, idx)


class _Route(NamedTuple):
    grad: Callable
    div: Callable
    cotangent: Callable
    scatter_rows: Callable


_KERNELS = _Route(_grad_kernel, _div_kernel, coef_cotangent, scatter_rows)
_PLAIN = _Route(_grad_plain_route, _div_plain_route, coef_cotangent_plain,
                scatter_rows_plain)


class _CoefApplyGrad(torch.autograd.Function):
    """``coef_apply_grad`` with the JAX VJP (``_cag_bwd``)."""

    @staticmethod
    def forward(ctx, x, coef, idx, route, plan):
        x, coef = x.detach(), coef.detach()
        ctx.save_for_backward(x, coef, idx)
        # The cotangent walks the points in the plan's Morton order:
        # neighbouring points share their rows in L1.
        ctx.route, ctx.order = route, None if plan is None else plan.order
        return route.grad(x, coef, idx, plan)

    @staticmethod
    def backward(ctx, ct):
        x, coef, idx = ctx.saved_tensors
        ctf = ct.float()
        dx = dc = None
        if ctx.needs_input_grad[0]:
            # dx[m, c] = sum over edges (n, k) with idx == m of
            #            sum_d coef[n, k, d] * ct[n, d, c]
            edge = torch.einsum("bnkd,bndc->bnkc", coef, ctf)
            dx = ctx.route.scatter_rows(edge.permute(0, 3, 2, 1), idx,
                                        x.shape[1]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # dcoef[n, k, d] = sum_c x[idx[n, k], c] * ct[n, d, c]
            dc = ctx.route.cotangent(x.float(), ctf, idx, ctx.order)
        return dx, dc, None, None, None


class _CoefApplyDiv(torch.autograd.Function):
    """``coef_apply_div`` with the JAX VJP (``_cad_bwd``): the cotangent
    rows are the flattened ``[2C]`` rows of ``v``'s layout."""

    @staticmethod
    def forward(ctx, v, coef, idx, route, plan):
        v, coef = v.detach(), coef.detach()
        ctx.save_for_backward(v, coef, idx)
        ctx.route, ctx.order = route, None if plan is None else plan.order
        return route.div(v, coef, idx, plan)

    @staticmethod
    def backward(ctx, ct):
        v, coef, idx = ctx.saved_tensors
        b, n, _, c = v.shape
        k = idx.shape[-1]
        ctf = ct.float()
        dv = dc = None
        if ctx.needs_input_grad[0]:
            # dv[m, d, c] = sum over edges with idx == m of
            #               coef[n, k, d] * ct[n, c]
            edge = torch.einsum("bnkd,bnc->bnkdc", coef, ctf).view(
                b, n, k, 2 * c)
            dv = ctx.route.scatter_rows(edge.permute(0, 3, 2, 1), idx,
                                        n).view(b, n, 2, c).to(v.dtype)
        if ctx.needs_input_grad[1]:
            # dcoef[n, k, d] = sum_c v[idx[n, k], d, c] * ct[n, c]
            dc = ctx.route.cotangent(v.float(), ctf, idx, ctx.order)
        return dv, dc, None, None, None


def _differentiated(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def coef_apply_grad(x: torch.Tensor, coef: torch.Tensor, idx: torch.Tensor,
                    plan: CoefPlan | None = None) -> torch.Tensor:
    """The gradient apply through the kernels on CUDA tensors (the plain
    versions on CPU ones); differentiable in ``x`` and ``coef``. ``plan``
    (:func:`coef_plan` of ``idx``) lets wide rows take route B."""
    if _differentiated(x, coef):
        return _CoefApplyGrad.apply(x, coef, idx, _KERNELS, plan)
    return _grad_kernel(x, coef, idx, plan)


def coef_apply_grad_plain(x: torch.Tensor, coef: torch.Tensor,
                          idx: torch.Tensor,
                          plan: CoefPlan | None = None) -> torch.Tensor:
    """:func:`coef_apply_grad` through the plain versions on any device
    (``plan`` is not needed there)."""
    if _differentiated(x, coef):
        return _CoefApplyGrad.apply(x, coef, idx, _PLAIN, plan)
    return _grad_plain(x, coef, idx)


def coef_apply_div(v: torch.Tensor, coef: torch.Tensor, idx: torch.Tensor,
                   plan: CoefPlan | None = None) -> torch.Tensor:
    """The divergence apply through the kernels on CUDA tensors (the
    plain versions on CPU ones); differentiable in ``v`` and ``coef``.
    ``plan`` as for :func:`coef_apply_grad`."""
    if _differentiated(v, coef):
        return _CoefApplyDiv.apply(v, coef, idx, _KERNELS, plan)
    return _div_kernel(v, coef, idx, plan)


def coef_apply_div_plain(v: torch.Tensor, coef: torch.Tensor,
                         idx: torch.Tensor,
                         plan: CoefPlan | None = None) -> torch.Tensor:
    """:func:`coef_apply_div` through the plain versions on any device."""
    if _differentiated(v, coef):
        return _CoefApplyDiv.apply(v, coef, idx, _PLAIN, plan)
    return _div_plain(v, coef, idx)
