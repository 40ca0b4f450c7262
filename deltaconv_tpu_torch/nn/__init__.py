"""Layers of the serving paths and the train step (f32 and bf16), and
the upstream exports ``ScalarVectorMLP``, ``ScalarVectorIdentity`` and
``gather_neighbors``."""

from .deltaconv import (AggrMLP, DeepMaxMLP, DeltaConv, EdgeMaxMLP,
                        PointMaxMLP, gather_neighbors)
from .dropout import Dropout
from .init import torch_linear_init_
from .mlp import MLP, ScalarVectorIdentity, ScalarVectorMLP, VectorMLP
from .nonlin import BatchNorm, BatchNormSlot, VectorNonLin, leaky_relu02

__all__ = ["AggrMLP", "BatchNorm", "BatchNormSlot", "DeepMaxMLP", "DeltaConv", "Dropout",
           "EdgeMaxMLP", "MLP", "PointMaxMLP", "ScalarVectorIdentity",
           "ScalarVectorMLP", "VectorMLP", "VectorNonLin",
           "gather_neighbors", "leaky_relu02", "torch_linear_init_"]
