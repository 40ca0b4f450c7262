"""DeltaNet backbone: operator construction + stacked DeltaConvs
(counterpart of ``deltaconv_tpu/models/deltanet_base.py``, dense
operators, given normals).

The kNN graph and the grad/div operators are rebuilt on every forward
from the positions, so operator construction is part of the serving
path: kNN (plain torch), tangent frames, the edge-plane gather and the
WLS solve (two kernels), and the dense assembly (a third kernel). The
convs' neighbour max is the fourth.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..geometry.dense import DenseGradDiv, densify
from ..geometry.frames import build_tangent_basis
from ..geometry.knn import knn
from ..nn.deltaconv import DeltaConv
from ..ops import KERNEL_OPS, Ops
from ..ops.wls_fused import build_grad_div_fused

__all__ = ["DeltaNetBase", "build_operators"]


def build_operators(pos, k: int, normal=None, point_mask=None,
                    kernel_width: float = 1.0, regularizer: float = 0.001,
                    ops: Ops = KERNEL_OPS) -> DenseGradDiv:
    """Builds the dense grad/div operators of a batch of clouds.

    Args:
      pos: ``[B, N, 3]`` positions.
      k: neighbours of the operator graph (self loop in slot 0).
      normal: ``[B, N, 3]`` unit normals. Estimating them from the
        cloud (``estimate_basis``) is not ported yet.
      point_mask: optional ``[B, N]`` bool validity.
      kernel_width, regularizer: WLS parameters.
      ops: the kernels (default) or their plain versions.
    """
    if normal is None:
        raise NotImplementedError(
            "normal estimation (estimate_basis, geometry/linalg.py) is not "
            "ported yet (ROADMAP: port queue); pass normals")
    nbr_idx, nbr_mask = knn(pos, k, point_mask)
    x_basis, y_basis = build_tangent_basis(normal)
    if point_mask is not None:
        nbr_mask = nbr_mask & point_mask[:, :, None]
    gd = build_grad_div_fused(pos, normal, x_basis, y_basis, nbr_idx,
                              nbr_mask, kernel_width, regularizer,
                              ops.gather_rows, ops.wls)
    return densify(gd, ops.densify_coefs, ops.gather_max)


class DeltaNetBase(nn.Module):
    """DGCNN-style backbone of sequential DeltaConv blocks on the
    positions: the first conv is centralized, the last drops the vector
    stream, and every stage's scalar output is returned for the
    heads."""

    def __init__(self, conv_channels: Sequence[int], num_neighbors: int = 20,
                 grad_regularizer: float = 0.001,
                 grad_kernel_width: float = 1.0):
        super().__init__()
        self.num_neighbors = num_neighbors
        self.grad_regularizer = grad_regularizer
        self.grad_kernel_width = grad_kernel_width
        widths = [3, *conv_channels]  # the first conv reads positions
        last = len(conv_channels) - 1
        self.convs = nn.ModuleList(
            DeltaConv(widths[i], widths[i + 1], centralized=(i == 0),
                      vector=(i != last))
            for i in range(len(conv_channels)))

    def forward(self, pos, normal=None, point_mask=None,
                ops: Ops = KERNEL_OPS):
        """``pos [B, N, 3]`` -> list of per-stage ``[B, N, C_i]``."""
        gd = build_operators(pos, self.num_neighbors, normal, point_mask,
                             self.grad_kernel_width, self.grad_regularizer,
                             ops)
        x = pos
        v = gd.grad(x)
        out = []
        for conv in self.convs:
            x, v = conv(x, v, gd)
            out.append(x)
        return out
