"""Layers of the serving paths and the train step (f32 and bf16)."""

from .deltaconv import DeepMaxMLP, DeltaConv, EdgeMaxMLP, PointMaxMLP
from .dropout import Dropout
from .init import torch_linear_init_
from .mlp import MLP, VectorMLP
from .nonlin import BatchNorm, BatchNormSlot, VectorNonLin, leaky_relu02

__all__ = ["BatchNorm", "BatchNormSlot", "DeepMaxMLP", "DeltaConv", "Dropout",
           "EdgeMaxMLP", "MLP", "PointMaxMLP", "VectorMLP", "VectorNonLin",
           "leaky_relu02", "torch_linear_init_"]
