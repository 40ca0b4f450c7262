"""The DeltaConv layer, f32 and bf16, train and eval (counterpart of
``deltaconv_tpu/nn/deltaconv.py``).

Scalar stream:
  ``x' = maxagg_k(s_mlp_max(x)[nbr]) + s_mlp([x, div v, curl v, |v|])``
  (the first, centralized conv runs ``s_mlp_max`` on ``x_j - x_i``).
Vector stream (skipped on the last layer):
  ``v' = v_mlp(I_J([v, hodge_laplacian(v), grad x']))``

Internal MLPs of depth 1 (the classification defaults) serve and train;
depth >= 2 (the segmentation config, ``DeepMaxMLP``) serves only. The
neighbour max, sum and gathers go through the operator object
(``gd.nbr_max``, ``gd.nbr_sum``, ...), which runs their kernels. A point
mask leaves padded points out of every train-mode BatchNorm statistic.

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
whole cloud's table and so is right at any world size.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..geometry.operators import I_J, J, norm
from ..ops.gather_mlp_max import mlp_chain
from .mlp import MLP, VectorMLP, linear
from .nonlin import batch_moments, leaky_relu02

__all__ = ["DeepMaxMLP", "DeltaConv", "EdgeMaxMLP", "PointMaxMLP"]


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


def _masked_rows_to_zero(out, gd, dtype):
    """0 on the points with no valid neighbour, cast to ``dtype``."""
    out = torch.where(gd.nbr_mask.any(dim=-1, keepdim=True), out, 0.0)
    return out if dtype is None else out.to(dtype)


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

    def forward(self, x, gd, stats_mask=None):
        """``stats_mask``: the ``[B, N, K]`` edges of the statistics
        (None: every slot, as the reference's mask-free BatchNorm)."""
        lin, bn = self[0][0], self[0][1].bn
        y = linear(lin, x, self.dtype).float()
        if self.dtype is not None and not self.training and _fusible(gd):
            # bf16 eval: the whole epilogue, self-row subtract included,
            # in the gather_max_affine kernel.
            affine = _bn_affine(bn)
            yp = (y * affine[0]).to(self.dtype)
            return gd.nbr_max_affine(yp, affine, sub_self=True)
        if self.training:
            mean, var = self._edge_moments(y, gd, stats_mask)
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

    @staticmethod
    def _edge_moments(y, gd, stats_mask):
        """Mean and clamped variance of ``y_j - y_i`` over the edges."""
        smask = (torch.ones_like(gd.nbr_mask) if stats_mask is None
                 else stats_mask)
        c = y.shape[-1]
        s = gd.nbr_sum(torch.cat([y, y * y], dim=-1), smask)
        s1, s2 = s[..., :c], s[..., c:]
        cnt = smask.sum(dim=-1, keepdim=True).to(y.dtype)
        edges = torch.clamp(cnt.sum(), min=1.0)
        lead = tuple(range(y.dim() - 1))
        mean = (s1 - cnt * y).sum(dim=lead) / edges
        mean2 = (s2 - 2.0 * y * s1 + cnt * y * y).sum(dim=lead) / edges
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)


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

    The commuted train branch (JAX ``fused_train``): the per-point bf16
    product feeds only the BatchNorm batch moments (the variance left
    unclamped, as the JAX branch computes it); the max runs on
    ``gd.nbr_matmul_max_train`` with the weight's columns flipped by
    ``sign(inv)``, and the epilogue ``LeakyReLU((sign * max - mean) * inv
    + bias)`` in f32, cast to bf16."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__([in_channels, out_channels], dtype)

    def forward(self, x, gd, stats_mask=None):
        lin, bn = self[0][0], self[0][1].bn
        narrower = _pad128(lin.in_features) < _pad128(lin.out_features)
        if self.dtype is None or (
                (self.training or not _fusible(gd)) and not narrower):
            return gd.nbr_max(super().forward(x, stats_mask))
        if self.training:
            y = linear(lin, x, self.dtype).float()
            mean, var = batch_moments(y, stats_mask, clamp=False)
            bn.update_running(mean, var)
            inv = bn.inv(var)
            sign = torch.where(inv >= 0, 1.0, -1.0)
            wp = (lin.weight.t() * sign[None, :]).to(self.dtype).contiguous()
            mxp = gd.nbr_matmul_max_train(x.to(self.dtype), wp)
            out = leaky_relu02((sign * mxp.float() - mean) * inv + bn.bias)
            return _masked_rows_to_zero(out, gd, self.dtype)
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
    ``max_k MLP(x_j - x_i)`` or ``max_k MLP(x)[nbr_k]``, eval only. Its
    parameters are those of ``MLP([C_in, *channels])``.

    The branches follow the JAX gate: in bf16, when the conv is
    centralized or its input is lane-narrower than its output
    (``pad128(C_in) < pad128(C_out)``, a TPU lane rule kept as it is),
    the fused kernel (``gd.nbr_mlp_max``) gathers the input rows and runs
    the whole eval MLP per edge, the last layer sign-folded so that one
    max finds the surviving extreme of its BatchNorm + LeakyReLU, which
    the kernel then applies; the self slot (kNN slot 0) is the MLP of
    the zero edge (centralized) or of the point itself, a per-point
    composition outside the kernel. Otherwise the reference pipeline:
    the ``[B, N, K, C]`` edge tensor through the MLP and a masked max
    (centralized; rows with no valid neighbour give 0), or the per-point
    MLP then ``gd.nbr_max``. The port takes the TPU's route on every
    device.
    """

    def __init__(self, in_channels: int, channels: Sequence[int],
                 centralized: bool = False, dtype=None):
        super().__init__([in_channels, *channels], dtype)
        self.centralized = centralized

    def forward(self, x, gd, stats_mask=None):
        if self.training:
            raise NotImplementedError(
                "DeepMaxMLP (mlp_depth >= 2) in training: segmentation "
                "training is ROADMAP queue 1 item 7, not ported yet")
        if self.dtype is not None:
            x = x.to(self.dtype)
        c_out = self[-1][0].out_features
        if self.dtype is not None and hasattr(gd, "nbr_mlp_max") and (
                self.centralized or _pad128(x.shape[-1]) < _pad128(c_out)):
            return self._fused(x, gd)
        if not self.centralized:
            return gd.nbr_max(super().forward(x))
        h = super().forward(gd.nbr_gather(x) - x[:, :, None, :])
        out = torch.where(gd.nbr_mask[..., None], h, -torch.inf).amax(dim=2)
        return torch.where(gd.nbr_mask.any(dim=-1, keepdim=True), out, 0.0)

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


class DeltaConv(nn.Module):
    """One DeltaConv block.

    Args:
      in_channels: width of the scalar input ``x`` and of the vector
        input ``v`` (``[B, N, 2, in_channels]``).
      out_channels: output width of both streams.
      depth: layers of each internal MLP (1: ``EdgeMaxMLP`` or
        ``PointMaxMLP`` for the max branch, which serve and train; 2 or
        more: ``DeepMaxMLP``, eval only).
      centralized: centralize scalar features before the max (the first
        conv, on raw positions).
      vector: propagate the vector stream (False on the last layer).
      dtype: compute dtype (None for f32, or ``torch.bfloat16``), handed
        to the three MLPs.
    """

    def __init__(self, in_channels: int, out_channels: int, depth: int = 1,
                 centralized: bool = False, vector: bool = True,
                 dtype=None):
        super().__init__()
        self.centralized = centralized
        channels = [out_channels] * depth
        if depth == 1:
            branch = EdgeMaxMLP if centralized else PointMaxMLP
            self.s_mlp_max = branch(in_channels, out_channels, dtype)
        else:
            self.s_mlp_max = DeepMaxMLP(in_channels, channels, centralized,
                                        dtype)
        self.s_mlp = MLP([4 * in_channels, *channels], dtype)
        self.v_mlp = (VectorMLP([2 * (2 * in_channels + out_channels),
                                 *channels], dtype) if vector else None)

    def forward(self, x, v, gd, point_mask=None):
        """``x [B, N, C]``, ``v [B, N, 2, C]``, ``gd`` the operators
        (dense, or in coefficient form for large clouds), ``point_mask``
        optional ``[B, N]`` validity (left out of the BatchNorm
        statistics). Returns ``(x', v')`` (``v'`` is None on the last
        layer)."""
        if self.centralized:  # the edges of valid points
            stats_mask = gd.nbr_mask if point_mask is not None else None
        else:
            stats_mask = point_mask
        x_max = self.s_mlp_max(x, gd, stats_mask)

        # div([v, Jv]) yields div(v) and -curl(v) in ONE apply.
        c = x.shape[-1]
        dd = gd.div(torch.cat([v, J(v)], dim=-1))  # [B, N, 2C]
        div_v = dd[..., :c]
        curl_v = -dd[..., c:]
        x_cat = torch.cat([x, div_v, curl_v, norm(v)], dim=-1)
        x = x_max + self.s_mlp(x_cat, point_mask)

        if self.v_mlp is None:
            return x, None
        # Both Hodge-Laplacian terms and grad(x') ride ONE 3C-wide apply.
        gg = gd.grad(torch.cat([div_v, curl_v, x], dim=-1))
        hodge = -(gg[..., :c] + J(gg[..., c:2 * c]))
        v_cat = torch.cat([v, hodge, gg[..., 2 * c:]], dim=-1)
        return x, self.v_mlp(I_J(v_cat), point_mask)
