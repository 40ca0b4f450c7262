"""Layers of the f32 serving path."""

from .deltaconv import DeltaConv, EdgeMaxMLP, PointMaxMLP
from .init import torch_linear_init_
from .mlp import MLP, VectorMLP
from .nonlin import BatchNorm, BatchNormSlot, VectorNonLin, leaky_relu02

__all__ = ["BatchNorm", "BatchNormSlot", "DeltaConv", "EdgeMaxMLP", "MLP",
           "PointMaxMLP", "VectorMLP", "VectorNonLin", "leaky_relu02",
           "torch_linear_init_"]
