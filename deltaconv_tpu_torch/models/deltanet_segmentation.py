"""DeltaNet segmentation head (counterpart of
``deltaconv_tpu/models/deltanet_segmentation.py``), train and eval.

Backbone stage outputs are concatenated and embedded (``lin_global``); a
global max pool is broadcast back to every point, joined by the embedded
object category (``lin_categorical``, ShapeNet's 16-wide one-hot), then
by the per-stage features again, and decoded to per-point logits.
Module names follow the upstream release (``deltanet_base.convs.{i}``,
``lin_global``, ``lin_categorical``, ``segmentation_head.{0,2,4,6}``), so
its ``state_dict``s and those converted from the JAX package
(:mod:`..utils.weights`, ``head="segmentation"``) load strictly.
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
from .pool import global_max_pool

__all__ = ["NUM_CATEGORIES", "DeltaNetSegmentation"]

NUM_CATEGORIES = 16  # ShapeNet's object categories: the one-hot's width


class DeltaNetSegmentation(nn.Module):
    """Per-point segmentation with DeltaConv.

    Defaults match the reference: conv channels (64, 128, 256), MLP depth
    2, embedding 1024, k=20, lambda=1e-3, head dropout 0.5. The ShapeNet
    recipe (``experiments/train_shapenet.py``) sets
    ``categorical_vector=True`` and k=30. The weights are drawn from
    ``generator`` (torch's Linear defaults) on the CPU;
    ``InferenceEngine`` moves the model to the card.

    ``operator_dtype`` (None, "float32", "bfloat16" or "int8"),
    ``compute_dtype`` (None, "float32" or "bfloat16") and ``knn_method``
    ("exact" or "approx") are the JAX model's fields (int8 operators
    serve only, ``InferenceEngine(..., precision="int8")``), as is
    ``dense_operators`` (False: coefficient-form operators, the
    large-cloud path; no int8 form). The
    backbone, ``lin_global``, ``lin_categorical`` and the head MLPs
    compute in ``compute_dtype``; the head's two Linear
    layers (``segmentation_head.4`` and ``.6``) run in f32, as the JAX
    model's ``Dense`` layers without a dtype do (flax promotes the bf16
    activations to their f32 parameters), so logits are f32. Parameters
    stay f32 in every mode. It trains in f32 and bf16 through
    ``training.make_train_step(model, per_point=True)`` (the categorical
    head's BatchNorm over the batch's clouds, the head's dropout from the
    step's generator). ``in_channels`` and ``centralize_first`` are the
    backbone's (:class:`DeltaNetClassification`'s docstring).
    """

    def __init__(self, num_classes: int,
                 conv_channels: Sequence[int] = (64, 128, 256),
                 mlp_depth: int = 2, embedding_size: int = 1024,
                 categorical_vector: bool = False, num_neighbors: int = 20,
                 grad_regularizer: float = 0.001,
                 grad_kernel_width: float = 1.0, dropout: float = 0.5,
                 operator_dtype=None, compute_dtype=None,
                 knn_method: str = "exact", dense_operators: bool = True,
                 generator: Optional[torch.Generator] = None,
                 in_channels: int = 3, centralize_first: bool = True):
        super().__init__()
        self.deltanet_base = DeltaNetBase(
            conv_channels, mlp_depth=mlp_depth, num_neighbors=num_neighbors,
            grad_regularizer=grad_regularizer,
            grad_kernel_width=grad_kernel_width, knn_method=knn_method,
            dense_operators=dense_operators, in_channels=in_channels,
            centralize_first=centralize_first)
        conv_width = sum(conv_channels)
        self.lin_global = MLP([conv_width, embedding_size])
        self.lin_categorical = (MLP([NUM_CATEGORIES, 64])
                                if categorical_vector else None)
        head_in = (embedding_size + (64 if categorical_vector else 0)
                   + conv_width)
        # Positions 1 and 3 hold the reference's dropout and 5 its
        # LeakyReLU (no parameters), so the upstream keys of positions 0,
        # 2, 4 and 6 stay.
        self.segmentation_head = nn.Sequential(
            MLP([head_in, 256]), Dropout(dropout),
            MLP([256, 256]), Dropout(dropout),
            nn.Linear(256, 128), nn.LeakyReLU(0.2),
            nn.Linear(128, num_classes))
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
        mlps = [self.lin_global, self.segmentation_head[0],
                self.segmentation_head[2]]
        if self.lin_categorical is not None:
            mlps.append(self.lin_categorical)
        for mlp in mlps:
            mlp.dtype = self.compute_dtype

    def forward(self, pos, normal=None, point_mask=None, category=None,
                ops: Ops = KERNEL_OPS,
                generator: Optional[torch.Generator] = None,
                operators=None, group=None, batch_group=None,
                features=None):
        """``pos``/``normal`` ``[B, N, 3]``, ``point_mask`` optional
        ``[B, N]`` bool, ``category`` ``[B, 16]`` one-hot (required when
        ``categorical_vector``) -> per-point logits ``[B, N,
        num_classes]`` f32. ``ops`` selects the kernels (default) or
        their plain versions; ``generator`` (on the batch's device) draws
        the train-mode dropout masks; ``features`` (``[B, N,
        in_channels]``, keyword) are the first conv's input in place of
        the positions, as JAX's ``features``.

        Two process groups, at most one of them set: ``operators`` and
        ``group`` are the point-sharded forward's (the ranks that hold
        the cloud's other points: the global max pool and the train-mode
        statistics of every per-point BatchNorm, the head's included,
        complete across them; ``lin_categorical`` sees the cloud's one
        category row and stays local, as JAX's, and each rank draws the
        whole cloud's dropout masks and keeps its points);
        ``batch_group`` the data-parallel ranks that hold the batch's
        other clouds (every BatchNorm completes over them, and each rank
        keeps its clouds' rows of the whole batch's dropout masks)."""
        rows = group if group is not None else batch_group
        conv_out = self.deltanet_base(pos, normal, point_mask, ops,
                                      operators, rows, features)
        x = self.lin_global(torch.cat(conv_out, dim=-1), point_mask, rows)
        b, n = pos.shape[:2]
        parts = [global_max_pool(x, point_mask, group)[:, None].expand(
            b, n, -1)]
        if self.lin_categorical is not None:
            if category is None:
                raise ValueError(
                    "categorical_vector=True requires a category one-hot")
            cat = self.lin_categorical(category, None, batch_group)
            parts.append(cat[:, None].expand(b, n, -1))
        x = torch.cat(parts + conv_out, dim=-1)
        mlp0, drop0, mlp1, drop1, lin2, act, out = self.segmentation_head
        dim = 1 if group is not None else 0  # the axis split over ranks
        x = mlp0(x, point_mask, rows)
        x = drop0(x, generator, *rank_block(x, rows, dim))
        x = mlp1(x, point_mask, rows)
        x = drop1(x, generator, *rank_block(x, rows, dim))
        return out(act(lin2(x.float())))
