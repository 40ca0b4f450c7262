"""DeltaNet classification head (counterpart of
``deltaconv_tpu/models/deltanet_classification.py``).

Backbone stage outputs are concatenated, embedded, globally max+mean
pooled, and classified through an MLP head with dropout. Module names
follow the upstream release (``deltanet_base.convs.{i}``, ``lin_embedding``,
``classification_head.{0,2,4}``), so its ``state_dict``s and those
converted from the JAX package (:mod:`..utils.weights`) load strictly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.dropout import Dropout, rank_block
from ..nn.init import torch_linear_init_
from ..nn.mlp import MLP
from ..ops import KERNEL_OPS, Ops
from .deltanet_base import DeltaNetBase
from .pool import global_max_pool, global_mean_pool

__all__ = ["DeltaNetClassification"]


class DeltaNetClassification(nn.Module):
    """Point-cloud classification with DeltaConv.

    Defaults match the reference: conv channels (64, 64, 128, 256), MLP
    depth 1, k=20, lambda=1e-3, kernel width 1, embedding 1024, head
    dropout 0.5. The weights are drawn from ``generator`` (torch's
    Linear defaults) on the CPU; ``InferenceEngine`` and
    ``create_train_state`` move the model to the card. ``model.train()``
    / ``model.eval()`` switch BatchNorm and dropout between batch and
    running behaviour.

    ``operator_dtype`` (None, "float32", "bfloat16" or "int8"),
    ``compute_dtype`` (None, "float32" or "bfloat16") and ``knn_method``
    ("exact" or "approx") are the JAX model's fields: the JAX package
    serves and trains in production with both dtypes bf16 and approximate
    kNN (``InferenceEngine(..., precision="bfloat16")`` sets the dtypes
    for serving; ``precision="int8"`` serves bf16 compute on int8
    operators, eval only). ``dense_operators=False`` is the JAX package's
    large-cloud mode (``bench.py --mode=large-train``: B=4, N=8192,
    bf16, approximate kNN): the operators stay in coefficient form,
    ``O(N K)``, and the convs apply them through ``coef_apply_grad`` and
    ``coef_apply_div``; it serves and trains in f32 and bf16 (int8 is
    refused: it has no coefficient form). The backbone,
    embedding and head MLPs compute in ``compute_dtype`` (dropout on the
    bf16 activations in training); the last Linear (``head_out``) runs in
    f32 on the f32-cast activations, so logits, and the loss, are f32.
    Parameters stay f32 in every mode. ``in_channels`` (the upstream
    reference's name, 3 by default) is the width of the backbone's input:
    the positions, or the ``features`` a forward is given (e.g. positions
    and normals, 6); ``centralize_first=False`` runs the first conv on the
    features themselves rather than their edge differences.
    """

    def __init__(self, num_classes: int,
                 conv_channels: Sequence[int] = (64, 64, 128, 256),
                 num_neighbors: int = 20, grad_regularizer: float = 0.001,
                 grad_kernel_width: float = 1.0, embedding_size: int = 1024,
                 dropout: float = 0.5, operator_dtype=None,
                 compute_dtype=None, knn_method: str = "exact",
                 dense_operators: bool = True,
                 generator: Optional[torch.Generator] = None,
                 in_channels: int = 3, centralize_first: bool = True):
        super().__init__()
        self.deltanet_base = DeltaNetBase(conv_channels,
                                          num_neighbors=num_neighbors,
                                          grad_regularizer=grad_regularizer,
                                          grad_kernel_width=grad_kernel_width,
                                          knn_method=knn_method,
                                          dense_operators=dense_operators,
                                          in_channels=in_channels,
                                          centralize_first=centralize_first)
        self.lin_embedding = MLP([sum(conv_channels), embedding_size])
        self.dropout = dropout
        # Positions 1 and 3 hold the reference's dropout (no parameters),
        # so the upstream keys of positions 0, 2 and 4 stay.
        self.classification_head = nn.Sequential(
            MLP([2 * embedding_size, 512]), Dropout(dropout),
            MLP([512, 256]), Dropout(dropout),
            nn.Linear(256, num_classes))
        torch_linear_init_(self, generator)
        self.set_precision(compute_dtype, operator_dtype)

    @property
    def compute_dtype(self):
        return self.deltanet_base.compute_dtype

    @property
    def operator_dtype(self):
        return self.deltanet_base.operator_dtype

    @property
    def dense_operators(self) -> bool:
        return self.deltanet_base.dense_operators

    def set_precision(self, compute_dtype, operator_dtype) -> None:
        """Sets both dtypes (None, "float32" or "bfloat16"; "int8" for
        ``operator_dtype`` too, which serves only) in place, as the JAX
        model's ``clone(compute_dtype=..., operator_dtype=...)``;
        parameters stay f32."""
        self.deltanet_base.set_precision(compute_dtype, operator_dtype)
        for mlp in (self.lin_embedding, self.classification_head[0],
                    self.classification_head[2]):
            mlp.dtype = self.compute_dtype

    def forward(self, pos, normal=None, point_mask=None,
                ops: Ops = KERNEL_OPS,
                generator: Optional[torch.Generator] = None,
                operators=None, group=None, batch_group=None,
                features=None):
        """``pos``/``normal`` ``[B, N, 3]``, ``point_mask`` optional
        ``[B, N]`` bool -> logits ``[B, num_classes]``. ``ops`` selects
        the kernels (default) or their plain versions; ``generator``
        (on the batch's device) draws the train-mode dropout masks.
        ``features`` (``[B, N, in_channels]``, keyword) are the first
        conv's input in place of the positions, as JAX's ``features``.

        Two process groups, at most one of them set:

        - ``operators`` and ``group``: the point-sharded forward's
          operator object and the ranks that hold the cloud's other
          points (``parallel.point_sharding``): the pools complete
          across them, and so do the train-mode statistics of every
          BatchNorm before the pools; the head's BatchNorms see the
          pooled row, the same on every rank, and stay local (as JAX's
          ``head0``/``head1``, which get no ``axis_name``), and every
          rank draws the same dropout masks;
        - ``batch_group``: the ranks that hold the batch's other clouds
          (data parallelism): every BatchNorm completes over them, and
          each rank draws the whole batch's dropout masks and keeps its
          rows (``nn.dropout.rank_block``), so the ranks drop as one
          process on the whole batch would.
        """
        rows = group if group is not None else batch_group
        conv_out = self.deltanet_base(pos, normal, point_mask, ops,
                                      operators, rows, features)
        x = self.lin_embedding(torch.cat(conv_out, dim=-1), point_mask,
                               rows)
        x = torch.cat([global_max_pool(x, point_mask, group),
                       global_mean_pool(x, point_mask, group)], dim=-1)
        mlp0, drop0, mlp1, drop1, out = self.classification_head
        x = mlp0(x, None, batch_group)
        x = drop0(x, generator, *rank_block(x, batch_group))
        x = mlp1(x, None, batch_group)
        x = drop1(x, generator, *rank_block(x, batch_group))
        return out(x.float())
