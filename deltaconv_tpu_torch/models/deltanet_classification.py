"""DeltaNet classification head (counterpart of
``deltaconv_tpu/models/deltanet_classification.py``, eval only).

Backbone stage outputs are concatenated, embedded, globally max+mean
pooled, and classified through an MLP head. Module names follow the
upstream release (``deltanet_base.convs.{i}``, ``lin_embedding``,
``classification_head.{0,2,4}``), so its ``state_dict``s and those
converted from the JAX package (:mod:`..utils.weights`) load strictly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.init import torch_linear_init_
from ..nn.mlp import MLP
from ..ops import KERNEL_OPS, Ops
from .deltanet_base import DeltaNetBase
from .pool import global_max_pool, global_mean_pool

__all__ = ["DeltaNetClassification"]


class DeltaNetClassification(nn.Module):
    """Point-cloud classification with DeltaConv.

    Defaults match the reference: conv channels (64, 64, 128, 256), MLP
    depth 1, k=20, lambda=1e-3, kernel width 1, embedding 1024. The
    weights are drawn from ``generator`` (torch's Linear defaults); the
    module is built on the CPU, so move it with ``.to(device)``.
    """

    def __init__(self, num_classes: int,
                 conv_channels: Sequence[int] = (64, 64, 128, 256),
                 num_neighbors: int = 20, grad_regularizer: float = 0.001,
                 grad_kernel_width: float = 1.0, embedding_size: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.deltanet_base = DeltaNetBase(conv_channels, num_neighbors,
                                          grad_regularizer,
                                          grad_kernel_width)
        self.lin_embedding = MLP([sum(conv_channels), embedding_size])
        # Positions 1 and 3 hold the reference's dropout, which is the
        # identity when serving.
        self.classification_head = nn.Sequential(
            MLP([2 * embedding_size, 512]), nn.Identity(),
            MLP([512, 256]), nn.Identity(),
            nn.Linear(256, num_classes))
        torch_linear_init_(self, generator)

    def forward(self, pos, normal=None, point_mask=None,
                ops: Ops = KERNEL_OPS):
        """``pos``/``normal`` ``[B, N, 3]``, ``point_mask`` optional
        ``[B, N]`` bool -> logits ``[B, num_classes]``. ``ops`` selects
        the kernels (default) or their plain versions."""
        conv_out = self.deltanet_base(pos, normal, point_mask, ops)
        x = self.lin_embedding(torch.cat(conv_out, dim=-1))
        x = torch.cat([global_max_pool(x, point_mask),
                       global_mean_pool(x, point_mask)], dim=-1)
        return self.classification_head(x)
