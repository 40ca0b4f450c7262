"""The DeltaConv layer, f32 eval (counterpart of
``deltaconv_tpu/nn/deltaconv.py``).

Scalar stream:
  ``x' = maxagg_k(s_mlp_max(x)[nbr]) + s_mlp([x, div v, curl v, |v|])``
  (the first, centralized conv runs ``s_mlp_max`` on ``x_j - x_i``).
Vector stream (skipped on the last layer):
  ``v' = v_mlp(I_J([v, hodge_laplacian(v), grad x']))``

Only depth-1 internal MLPs exist on this slice (the classification
defaults). The neighbour max goes through the operator object
(``gd.nbr_max``), which runs the gather-max kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry.operators import I_J, J, norm
from .mlp import MLP, VectorMLP
from .nonlin import leaky_relu02

__all__ = ["DeltaConv", "EdgeMaxMLP", "PointMaxMLP"]


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
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__([in_channels, out_channels])

    def forward(self, x, gd):
        lin, bn = self[0][0], self[0][1].bn
        y = lin(x)
        inv = bn.inv()
        sign = torch.where(inv >= 0, 1.0, -1.0)
        yp = y * sign
        mxp = gd.nbr_max(yp)
        h_star = sign * (mxp - yp)
        out = leaky_relu02((h_star - bn.running_mean) * inv + bn.bias)
        return torch.where(gd.nbr_mask.any(dim=-1, keepdim=True), out, 0.0)


class PointMaxMLP(MLP):
    """Non-centralized scalar max branch
    ``max_k LeakyReLU(BN(Linear(x)))[nbr_k]``: the per-point MLP, then
    the masked neighbour max."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__([in_channels, out_channels])

    def forward(self, x, gd):
        return gd.nbr_max(super().forward(x))


class DeltaConv(nn.Module):
    """One DeltaConv block with depth-1 internal MLPs.

    Args:
      in_channels: width of the scalar input ``x`` and of the vector
        input ``v`` (``[B, N, 2, in_channels]``).
      out_channels: output width of both streams.
      centralized: centralize scalar features before the max (the first
        conv, on raw positions).
      vector: propagate the vector stream (False on the last layer).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 centralized: bool = False, vector: bool = True):
        super().__init__()
        branch = EdgeMaxMLP if centralized else PointMaxMLP
        self.s_mlp_max = branch(in_channels, out_channels)
        self.s_mlp = MLP([4 * in_channels, out_channels])
        self.v_mlp = (VectorMLP([2 * (2 * in_channels + out_channels),
                                 out_channels]) if vector else None)

    def forward(self, x, v, gd):
        """``x [B, N, C]``, ``v [B, N, 2, C]``, ``gd`` the dense
        operators. Returns ``(x', v')`` (``v'`` is None on the last
        layer)."""
        x_max = self.s_mlp_max(x, gd)

        # div([v, Jv]) yields div(v) and -curl(v) in ONE apply.
        c = x.shape[-1]
        dd = gd.div(torch.cat([v, J(v)], dim=-1))  # [B, N, 2C]
        div_v = dd[..., :c]
        curl_v = -dd[..., c:]
        x_cat = torch.cat([x, div_v, curl_v, norm(v)], dim=-1)
        x = x_max + self.s_mlp(x_cat)

        if self.v_mlp is None:
            return x, None
        # Both Hodge-Laplacian terms and grad(x') ride ONE 3C-wide apply.
        gg = gd.grad(torch.cat([div_v, curl_v, x], dim=-1))
        hodge = -(gg[..., :c] + J(gg[..., c:2 * c]))
        v_cat = torch.cat([v, hodge, gg[..., 2 * c:]], dim=-1)
        return x, self.v_mlp(I_J(v_cat))
