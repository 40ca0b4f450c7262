"""The DeltaConv layer, f32 and bf16, train and eval (counterpart of
``deltaconv_tpu/nn/deltaconv.py``).

Scalar stream:
  ``x' = maxagg_k(s_mlp_max(x)[nbr]) + s_mlp([x, div v, curl v, |v|])``
  (the first, centralized conv runs ``s_mlp_max`` on ``x_j - x_i``;
with ``aggr="mean"`` or ``"sum"`` a masked mean or sum takes the max's
place, :class:`AggrMLP`).
Vector stream (skipped on the last layer):
  ``v' = v_mlp(I_J([v, hodge_laplacian(v), grad x']))``

Internal MLPs of depth 1 (the classification defaults) and depth >= 2
(the segmentation config, ``DeepMaxMLP``) serve and train. The
neighbour max, sum and gathers go through the operator object
(``gd.nbr_max``, ``gd.nbr_sum``, ...), which runs their kernels. A point
mask leaves padded points out of every train-mode BatchNorm statistic.
Every max over a neighbour axis routes its gradient to the first slot
that holds the maximum, as the JAX package's single-winner VJPs do.

With ``dtype=torch.bfloat16`` the layer computes as the JAX package's
mixed precision: bf16 Linear products and activations, f32 BatchNorm.
In eval both max branches are commuted through the monotone BatchNorm +
LeakyReLU by sign folding into the kernels that apply that epilogue
themselves (``gd.nbr_max_affine``, ``gd.nbr_matmul_max``), as
``_epilogue_fusible`` routes them on the TPU. In training the max runs
on bf16 values with the single-winner gradient (``gd.nbr_max``), except
in a lane-narrower ``PointMaxMLP``, which takes the commuted train
branch through ``gd.nbr_matmul_max_train``, as the JAX package's TPU
route does. The port takes the TPU's route on every device: the kernels
on the card, their plain versions on the CPU.

On int8 operators (``gd.int8``, the int8 serving mode) the epilogue
stays outside the maxes, as JAX's ``_epilogue_fusible`` rules: the
EdgeMaxMLP max and the PointMaxMLP per-point branch run ``gd.nbr_max``
(the quantized max) with the BatchNorm + LeakyReLU around it, and a
lane-narrower PointMaxMLP runs ``gd.nbr_matmul_max`` without the affine,
then the epilogue. DeepMaxMLP keeps its fused kernel (it gathers bf16
features, not the operators).

The layers pick their route by what the operator object offers, as the
JAX layers do with ``hasattr``: a point-sharded one
(``parallel.ShardedGradDiv``) has neither ``nbr_max_affine`` nor
``nbr_mlp_max``, so EdgeMaxMLP and PointMaxMLP take the int8 routes
above, and DeepMaxMLP the unfused one (the edge tensor of the gathered
rows, or the per-point MLP, then the masked max), which gathers from the
whole cloud's table and so is right at any world size. Lacking
``nbr_matmul_max_train`` too, it sends a lane-narrower bf16 PointMaxMLP
in training down the per-point BatchNorm and ``gd.nbr_max``, as the JAX
convs do.

In training a ``group`` (a ``torch.distributed`` process group: the
ranks that hold the batch's other clouds, or the cloud's other points)
completes every BatchNorm's moments and the centralized conv's edge
moments over its ranks (``nonlin.batch_moments``); None or a group of
one rank leaves them local.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..geometry.operators import I_J, J, norm
from ..ops.gather_mlp_max import mlp_chain
from .mlp import MLP, VectorMLP, linear
from ..parallel.collectives import psum, rank_and_size
from .nonlin import batch_moments, leaky_relu02

__all__ = ["AggrMLP", "DeepMaxMLP", "DeltaConv", "EdgeMaxMLP", "PointMaxMLP",
           "gather_neighbors"]

_AGGREGATIONS = ("max", "mean", "sum", "add")

# DeepMaxMLP's fused centralized depth-2 train branch (``gd.nbr_edge_mlp``,
# the ``edge_delta_mlp`` kernels): the JAX package's switch of the same
# name and meaning (``deltaconv_tpu/nn/deltaconv.py``), off by default as
# there. Flip for A/B.
_EDGE_FUSED_TRAIN = False


def _bn_affine(bn):
    """Eval BatchNorm as ``(sign, inv, mean, bias)`` for the sign-folded
    epilogue: ``inv = rsqrt(var + eps) * weight``, ``sign = sign(inv)``
    (+1 at 0)."""
    inv = bn.inv()
    return torch.where(inv >= 0, 1.0, -1.0), inv, bn.running_mean, bn.bias


def _fusible(gd) -> bool:
    """Whether the eval epilogue may run inside the gather kernels: an
    operator object with the affine kernels (a point-sharded one has
    none) that is not on int8 operators (JAX's ``_epilogue_fusible``)."""
    return not gd.int8 and hasattr(gd, "nbr_max_affine")


def gather_neighbors(x, nbr_idx):
    """Per-neighbour features ``x [..., N, C], nbr_idx [..., N, K] ->
    [..., N, K, C]`` with any number of leading batch axes (JAX
    ``gather_neighbors``); differentiable in ``x``."""
    lead, c = nbr_idx.shape[:-2], x.shape[-1]
    flat = nbr_idx.reshape(*lead, -1, 1).long().expand(
        *lead, nbr_idx.shape[-2] * nbr_idx.shape[-1], c)
    return torch.gather(x, -2, flat).view(*nbr_idx.shape, c)


def _masked_rows_to_zero(out, gd, dtype):
    """0 on the points with no valid neighbour, cast to ``dtype``."""
    out = torch.where(gd.nbr_mask.any(dim=-1, keepdim=True), out, 0.0)
    return out if dtype is None else out.to(dtype)


class _MaskedMax(torch.autograd.Function):
    """Max over ``dim`` of ``h`` where ``mask`` (broadcast to ``h``), -inf
    elsewhere, with the single-winner VJP of the JAX ``_masked_max`` and
    ``_masked_max_kmajor``: each output's cotangent goes to the FIRST slot
    that holds the maximum (torch's ``amax`` splits it over ties), in the
    cotangent's dtype."""

    @staticmethod
    def forward(ctx, h, mask, dim):
        masked = torch.where(mask, h, -torch.inf)
        out = masked.amax(dim=dim)
        if ctx.needs_input_grad[0]:  # the winners, for the backward only
            first = (masked == out.unsqueeze(dim)).to(torch.uint8).argmax(
                dim=dim)
            ctx.save_for_backward(first)
            ctx.dim, ctx.shape = dim, h.shape
        return out

    @staticmethod
    def backward(ctx, g):
        (first,) = ctx.saved_tensors
        dh = g.new_zeros(ctx.shape)
        return (dh.scatter_(ctx.dim, first.unsqueeze(ctx.dim),
                            g.unsqueeze(ctx.dim)), None, None)


def _edge_max(h, gd, dim=2):
    """Masked max over the neighbour axis of an edge tensor (``dim=2``:
    ``[B, N, K, C]``; ``dim=1``: K-major ``[B, K, N, C]``), first-winner
    gradient, 0 on the points with no valid neighbour."""
    mask = gd.nbr_mask if dim == 2 else gd.nbr_mask.transpose(1, 2)
    out = _MaskedMax.apply(h, mask[..., None], dim)
    return _masked_rows_to_zero(out, gd, None)


def _edge_moments(y, gd, stats_mask, table_dtype=None, group=None):
    """Mean and clamped variance of ``y_j - y_i`` over the edges of
    ``stats_mask`` (None: every slot), from neighbour sums ``s1, s2`` of
    ``[y, y^2]`` (``gd.nbr_sum``, the table rounded to ``table_dtype``
    when given) and the valid-slot counts ``cnt``: ``sum_e (y_j - y_i) =
    sum_n s1_n - cnt_n y_n`` and ``sum_e (y_j - y_i)^2 = sum_n s2_n - 2
    y_n s1_n + cnt_n y_n^2``; both sums and the edge count ``psum`` over
    ``group``'s ranks (JAX ``EdgeMaxMLP`` with an ``axis_name``)."""
    smask = (torch.ones_like(gd.nbr_mask) if stats_mask is None
             else stats_mask)
    c = y.shape[-1]
    table = torch.cat([y, y * y], dim=-1)
    if table_dtype is not None:
        table = table.to(table_dtype).to(y.dtype)
    s = gd.nbr_sum(table, smask)
    s1, s2 = s[..., :c], s[..., c:]
    cnt = smask.sum(dim=-1, keepdim=True).to(y.dtype)
    lead = tuple(range(y.dim() - 1))
    sum_h = (s1 - cnt * y).sum(dim=lead)
    sum_h2 = (s2 - 2.0 * y * s1 + cnt * y * y).sum(dim=lead)
    edges = cnt.sum()
    if rank_and_size(group)[1] > 1:
        sums = psum(torch.cat([sum_h, sum_h2, edges[None]]), group)
        sum_h, sum_h2, edges = sums[:c], sums[c:2 * c], sums[2 * c]
    edges = torch.clamp(edges, min=1.0)
    mean = sum_h / edges
    mean2 = sum_h2 / edges
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def _commuted_max_train(lin, bn, x, gd, stats_mask, dtype, group=None):
    """The commuted bf16 train max of one Linear + BatchNorm + LeakyReLU
    layer (JAX ``fused_train``): the per-point bf16 product feeds only
    the BatchNorm batch moments (the variance left unclamped, as the JAX
    branch computes it); the max runs on ``gd.nbr_matmul_max_train``
    with the weight's columns flipped by ``sign(inv)``, and the epilogue
    ``LeakyReLU((sign * max - mean) * inv + bias)`` in f32, cast to
    ``dtype``. The moments complete over ``group`` (count-weighted, as
    every BatchNorm of the port)."""
    y = linear(lin, x, dtype).float()
    mean, var = batch_moments(y, stats_mask, clamp=False, group=group)
    bn.update_running(mean, var)
    inv = bn.inv(var)
    sign = torch.where(inv >= 0, 1.0, -1.0)
    wp = (lin.weight.t() * sign[None, :]).to(dtype).contiguous()
    mxp = gd.nbr_matmul_max_train(x.to(dtype), wp)
    out = leaky_relu02((sign * mxp.float() - mean) * inv + bn.bias)
    return _masked_rows_to_zero(out, gd, dtype)


class EdgeMaxMLP(MLP):
    """Centralized scalar branch ``max_k MLP(x_j - x_i)`` without the
    ``[B, N, K, C]`` edge tensor.

    For a depth-1 MLP the aggregation commutes: the Linear layer is
    linear, so the edge value is ``y_j - y_i`` with ``y = Linear(x)``
    computed once per point; BatchNorm + LeakyReLU is a per-channel
    monotone map whose surviving extreme one max chain finds after
    sign-folding: with ``s = sign(inv)`` and ``y' = s * y``,
    ``max_k (y'_j - y'_i) = s * (extreme_j - y_i)``. Parameters are
    those of ``MLP([C_in, C])``.

    In training the BatchNorm statistics are those of the edge
    population, from neighbour sums ``s1, s2`` of ``[y, y^2]``
    (``gd.nbr_sum``) and the valid-slot counts ``cnt``:
    ``sum_e (y_j - y_i) = sum_n s1_n - cnt_n y_n`` and
    ``sum_e (y_j - y_i)^2 = sum_n s2_n - 2 y_n s1_n + cnt_n y_n^2``.
    In bf16 training ``y`` is the bf16 product widened to f32, the max
    runs on the sign-folded ``y`` rounded to bf16, and the epilogue in
    f32, cast to bf16 at the end.
    """

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__([in_channels, out_channels], dtype)

    def forward(self, x, gd, stats_mask=None, group=None):
        """``stats_mask``: the ``[B, N, K]`` edges of the statistics
        (None: every slot, as the reference's mask-free BatchNorm);
        ``group``: the ranks they complete over."""
        lin, bn = self[0][0], self[0][1].bn
        y = linear(lin, x, self.dtype).float()
        if self.dtype is not None and not self.training and _fusible(gd):
            # bf16 eval: the whole epilogue, self-row subtract included,
            # in the gather_max_affine kernel.
            affine = _bn_affine(bn)
            yp = (y * affine[0]).to(self.dtype)
            return gd.nbr_max_affine(yp, affine, sub_self=True)
        if self.training:
            mean, var = _edge_moments(y, gd, stats_mask, group=group)
            bn.update_running(mean, var)
        else:
            mean, var = bn.running_mean, bn.running_var
        inv = bn.inv(var)
        sign = torch.where(inv >= 0, 1.0, -1.0)
        yp = y * sign
        if self.dtype is not None:
            yp = yp.to(self.dtype)
        mxp = gd.nbr_max(yp)
        h_star = sign * (mxp.float() - yp.float())
        out = leaky_relu02((h_star - mean) * inv + bn.bias)
        return _masked_rows_to_zero(out, gd, self.dtype)


def _pad128(c: int) -> int:
    return -(-c // 128) * 128


class PointMaxMLP(MLP):
    """Non-centralized scalar max branch
    ``max_k LeakyReLU(BN(Linear(x)))[nbr_k]``: the per-point MLP, then
    the masked neighbour max. ``stats_mask`` (``[B, N]`` points) leaves
    padded points out of the train-mode BatchNorm statistics.

    bf16 takes the JAX package's branches by its ``narrower`` rule (a TPU
    lane rule, kept as it is): when the input is lane-narrower than the
    output (``pad128(C_in) < pad128(C_out)``) the matmul max gathers the
    input rows and applies the sign-folded weight per neighbour (eval:
    ``gather_matmul_max`` with the epilogue; training: the commuted
    branch below); otherwise the per-point product goes through
    ``gather_max_affine`` (eval) or, in training, the per-point
    BatchNorm + LeakyReLU, cast to bf16, then ``gd.nbr_max``.

    The commuted train branch is :func:`_commuted_max_train` (JAX
    ``fused_train``), on an operator object that offers
    ``nbr_matmul_max_train`` (not a point-sharded one)."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__([in_channels, out_channels], dtype)

    def forward(self, x, gd, stats_mask=None, group=None):
        lin, bn = self[0][0], self[0][1].bn
        narrower = _pad128(lin.in_features) < _pad128(lin.out_features)
        if self.dtype is None or (
                (self.training or not _fusible(gd)) and not narrower) or (
                self.training and not hasattr(gd, "nbr_matmul_max_train")):
            return gd.nbr_max(super().forward(x, stats_mask, group))
        if self.training:
            return _commuted_max_train(lin, bn, x, gd, stats_mask,
                                       self.dtype, group)
        affine = _bn_affine(bn)
        sign = affine[0]
        if narrower:
            wp = (lin.weight.t() * sign[None, :]).to(self.dtype).contiguous()
            if _fusible(gd):
                return gd.nbr_matmul_max(x.to(self.dtype), wp, affine)
            # int8 or point-sharded: the matmul max, then the epilogue.
            _, inv, mean, bias = affine
            mxp = gd.nbr_matmul_max(x.to(self.dtype), wp)
            out = leaky_relu02((sign * mxp.float() - mean) * inv + bias)
            return _masked_rows_to_zero(out, gd, self.dtype)
        y = linear(lin, x, self.dtype)
        yp = (y.float() * sign).to(self.dtype)
        return gd.nbr_max_affine(yp, affine)


class DeepMaxMLP(MLP):
    """Scalar max branch of a depth >= 2 conv, centralized or not:
    ``max_k MLP(x_j - x_i)`` or ``max_k MLP(x)[nbr_k]``. Its parameters
    are those of ``MLP([C_in, *channels])``; ``stats_mask`` (the edges
    ``[B, N, K]`` when centralized, else the points ``[B, N]``) leaves
    padded ones out of the train-mode BatchNorm statistics.

    The branches follow the JAX gates, the TPU's route on every device.
    In bf16 eval, when the conv is centralized or its input is
    lane-narrower than its output (``pad128(C_in) < pad128(C_out)``, a
    TPU lane rule kept as it is), the fused kernel (``gd.nbr_mlp_max``)
    gathers the input rows and runs the whole eval MLP per edge, the last
    layer sign-folded so that one max finds the surviving extreme of its
    BatchNorm + LeakyReLU, which the kernel then applies; the self slot
    (kNN slot 0) is the MLP of the zero edge (centralized) or of the
    point itself, a per-point composition outside the kernel. In bf16
    training (not on int8 operators):

    - (a) with ``_EDGE_FUSED_TRAIN``, a centralized conv of depth 2 on an
      operator object with the affine kernels: layer 0 commutes through
      the edge difference (``y = x W0`` per point; its BatchNorm's edge
      moments from neighbour sums of the bf16 table ``[y, y^2]``), the
      edge MLP ``gd.nbr_edge_mlp`` forms ``lrelu(affine0(y_j - y_i)) @
      W1`` per edge (K-major, the self slot ``z0 = bf16(lrelu(b0)) @
      W1``), then BatchNorm 1 over the edges of ``stats_mask`` (JAX takes
      ``gd.nbr_mask`` there whenever a mask is given; the two differ
      when the caller's mask is not the graph's), LeakyReLU and the masked
      max;
    - (b) a non-centralized conv whose last layer is lane-narrower
      (``pad128(C_{L-1}) < pad128(C_L)``): the per-point prefix layers,
      then :func:`_commuted_max_train` of the last (never at
      ``DeltaConv``'s ``[C_out] * depth``, where the two are equal).

    Otherwise, and in f32, the reference pipeline: the ``[B, N, K, C]``
    edge tensor (``gd.nbr_gather``) through the MLP and the masked max
    (centralized; rows with no valid neighbour give 0), or the per-point
    MLP then ``gd.nbr_max``.
    """

    def __init__(self, in_channels: int, channels: Sequence[int],
                 centralized: bool = False, dtype=None):
        super().__init__([in_channels, *channels], dtype)
        self.centralized = centralized

    def forward(self, x, gd, stats_mask=None, group=None):
        if self.dtype is not None:
            x = x.to(self.dtype)
        c_out = self[-1][0].out_features
        if self.dtype is not None and not self.training and hasattr(
                gd, "nbr_mlp_max") and (
                self.centralized or _pad128(x.shape[-1]) < _pad128(c_out)):
            return self._fused(x, gd)
        if self.dtype is not None and self.training and not gd.int8:
            if (_EDGE_FUSED_TRAIN and self.centralized and len(self) == 2
                    and hasattr(gd, "nbr_max_affine")):
                return self._edge_fused_train(x, gd, stats_mask, group)
            if (not self.centralized and hasattr(gd, "nbr_matmul_max_train")
                    and _pad128(self[-1][0].in_features) < _pad128(c_out)):
                h = x
                for lin, norm in list(self)[:-1]:
                    h = leaky_relu02(norm(linear(lin, h, self.dtype),
                                          stats_mask, group)).to(self.dtype)
                return _commuted_max_train(self[-1][0], self[-1][1].bn, h,
                                           gd, stats_mask, self.dtype, group)
        if not self.centralized:
            return gd.nbr_max(super().forward(x, stats_mask, group))
        h = super().forward(gd.nbr_gather(x) - x[:, :, None, :], stats_mask,
                            group)
        return _edge_max(h, gd)

    def _edge_fused_train(self, x, gd, stats_mask, group=None):
        """Branch (a) of the class docstring."""
        (lin0, norm0), (lin1, norm1) = self
        bn0, bn1 = norm0.bn, norm1.bn
        y = linear(lin0, x, self.dtype)
        mean0, var0 = _edge_moments(y.float(), gd, stats_mask,
                                    torch.bfloat16, group)
        bn0.update_running(mean0, var0)
        a0 = bn0.inv(var0)
        b0 = bn0.bias - mean0 * a0
        w1 = lin1.weight.t()
        z0 = torch.matmul(leaky_relu02(b0).to(self.dtype).float()[None],
                          w1.to(self.dtype).float())[0]
        y1 = gd.nbr_edge_mlp(y, a0, b0, w1, z0).float()  # [B, K, N, C1]
        mean1, var1 = batch_moments(
            y1, None if stats_mask is None else stats_mask.transpose(1, 2),
            group=group)
        bn1.update_running(mean1, var1)
        h1 = leaky_relu02((y1 - mean1) * bn1.inv(var1) + bn1.bias)
        return _edge_max(h1.to(self.dtype), gd, dim=1)

    def _fused(self, x, gd):
        ws, affines = [], []
        for i, (lin, norm) in enumerate(self):
            bn = norm.bn
            inv = bn.inv()
            ws.append(lin.weight.t())
            if i < len(self) - 1:
                affines.append((inv, bn.bias - bn.running_mean * inv))
        sign = torch.where(inv >= 0, 1.0, -1.0)
        ws[-1] = ws[-1] * sign[None, :]
        if self.centralized:
            z0 = mlp_chain(x.new_zeros((1, x.shape[-1])), ws, affines)[0]
        else:
            z0 = mlp_chain(x, ws, affines)
        return gd.nbr_mlp_max(x, ws, affines, self.centralized, z0,
                              (sign, inv, bn.running_mean, bn.bias))


def _per_count(out, gd):
    """``out`` over each point's count of valid slots (at least 1), in
    ``out``'s dtype (JAX's ``sum / maximum(sum(mask), 1)``)."""
    cnt = torch.clamp(gd.nbr_mask.sum(dim=-1, keepdim=True), min=1)
    return out / cnt.to(out.dtype)


class AggrMLP(MLP):
    """Scalar branch of a conv whose aggregation is ``"mean"`` or
    ``"sum"`` (``"add"``), JAX ``DeltaConv``'s ``aggr`` branches with
    ``_aggregate``: centralized, the MLP on the gathered edge
    differences ``x_j - x_i`` (``gd.nbr_gather``; ``stats_mask`` the
    edges of its BatchNorm statistics), then the masked sum over the
    neighbour axis in f32 (bf16 values widened exactly, as ``jnp.sum``
    upcasts), cast to the compute dtype; otherwise the MLP once a point,
    then the masked neighbour sum of its output (``gd.nbr_sum`` on the
    f32-widened rows, cast back; ``stats_mask`` its points). The mean
    divides the sum by the point's valid-slot count (at least 1).
    Parameters are those of ``MLP([C_in, *channels])``."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 centralized: bool, aggr: str, dtype=None):
        super().__init__([in_channels, *channels], dtype)
        self.centralized = centralized
        self.aggr = aggr

    def forward(self, x, gd, stats_mask=None, group=None):
        if self.centralized:
            h = super().forward(gd.nbr_gather(x) - x[:, :, None, :],
                                stats_mask, group)
            out = torch.where(gd.nbr_mask[..., None], h.float(), 0.0).sum(
                dim=-2).to(h.dtype)
        else:
            h = super().forward(x, stats_mask, group)
            out = gd.nbr_sum(h.float()).to(h.dtype)
        return _per_count(out, gd) if self.aggr == "mean" else out


class DeltaConv(nn.Module):
    """One DeltaConv block.

    Args:
      in_channels: width of the scalar input ``x`` and of the vector
        input ``v`` (``[B, N, 2, in_channels]``).
      out_channels: output width of both streams.
      depth: layers of each internal MLP (1: ``EdgeMaxMLP`` or
        ``PointMaxMLP`` for the max branch; 2 or more: ``DeepMaxMLP``).
      centralized: centralize scalar features before the max (the first
        conv, on raw positions).
      vector: propagate the vector stream (False on the last layer).
      dtype: compute dtype (None for f32, or ``torch.bfloat16``), handed
        to the three MLPs.
      aggr: the scalar branch's aggregation over the neighbours
        (JAX's): ``"max"`` (the default: the max branches above), or
        ``"mean"`` or ``"sum"`` (``"add"``): :class:`AggrMLP`.
    """

    def __init__(self, in_channels: int, out_channels: int, depth: int = 1,
                 centralized: bool = False, vector: bool = True,
                 dtype=None, aggr: str = "max"):
        super().__init__()
        if aggr not in _AGGREGATIONS:
            raise ValueError(f"unknown aggregation {aggr!r}: one of "
                             f"{_AGGREGATIONS}")
        self.centralized = centralized
        channels = [out_channels] * depth
        if aggr != "max":
            self.s_mlp_max = AggrMLP(in_channels, channels, centralized,
                                     aggr, dtype)
        elif depth == 1:
            branch = EdgeMaxMLP if centralized else PointMaxMLP
            self.s_mlp_max = branch(in_channels, out_channels, dtype)
        else:
            self.s_mlp_max = DeepMaxMLP(in_channels, channels, centralized,
                                        dtype)
        self.s_mlp = MLP([4 * in_channels, *channels], dtype)
        self.v_mlp = (VectorMLP([2 * (2 * in_channels + out_channels),
                                 *channels], dtype) if vector else None)

    def forward(self, x, v, gd, point_mask=None, group=None):
        """``x [B, N, C]``, ``v [B, N, 2, C]``, ``gd`` the operators
        (dense, or in coefficient form for large clouds, or a
        point-sharded ``ShardedGradDiv``), ``point_mask`` optional ``[B,
        N]`` validity (left out of the BatchNorm statistics), ``group``
        the ranks the train-mode statistics complete over. Returns
        ``(x', v')`` (``v'`` is None on the last layer). On the operators
        of one cloud (``nbr_idx [N, K]``) every input and output lacks
        its batch axis, and the layer runs as the batch of one (the same
        kernels, the same bits)."""
        if gd.nbr_idx.dim() == 2:
            x, v = self(x[None], v[None], gd.batched(),
                        None if point_mask is None else point_mask[None],
                        group)
            return x[0], None if v is None else v[0]
        if self.centralized:  # the edges of valid points
            stats_mask = gd.nbr_mask if point_mask is not None else None
        else:
            stats_mask = point_mask
        x_max = self.s_mlp_max(x, gd, stats_mask, group)

        # div([v, Jv]) yields div(v) and -curl(v) in ONE apply.
        c = x.shape[-1]
        dd = gd.div(torch.cat([v, J(v)], dim=-1))  # [B, N, 2C]
        div_v = dd[..., :c]
        curl_v = -dd[..., c:]
        x_cat = torch.cat([x, div_v, curl_v, norm(v)], dim=-1)
        x = x_max + self.s_mlp(x_cat, point_mask, group)

        if self.v_mlp is None:
            return x, None
        # Both Hodge-Laplacian terms and grad(x') ride ONE 3C-wide apply.
        gg = gd.grad(torch.cat([div_v, curl_v, x], dim=-1))
        hodge = -(gg[..., :c] + J(gg[..., c:2 * c]))
        v_cat = torch.cat([v, hodge, gg[..., 2 * c:]], dim=-1)
        return x, self.v_mlp(I_J(v_cat), point_mask, group)
