"""Scalar and vector MLP stacks (counterpart of
``deltaconv_tpu/nn/mlp.py``). Each scalar layer is bias-free Linear ->
BatchNorm -> LeakyReLU(0.2); each vector layer is bias-free Linear
(acting per component, hence equivariant) -> VectorNonLin. A ``mask``
over the rows leaves padded points out of the train-mode BatchNorm
statistics. Parameter names follow the upstream release:
``{j}.0.weight``, ``{j}.1.bn.*`` and ``{j}.1.batchnorm.bn.*``."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from .nonlin import BatchNormSlot, VectorNonLin, leaky_relu02

__all__ = ["MLP", "VectorMLP"]


class MLP(nn.ModuleList):
    """Stack of (Linear no-bias -> BatchNorm -> LeakyReLU) layers.
    ``channels`` lists the input width, then every layer's output
    width."""

    def __init__(self, channels: Sequence[int]):
        super().__init__(
            nn.Sequential(nn.Linear(c_in, c_out, bias=False),
                          BatchNormSlot(c_out))
            for c_in, c_out in zip(channels[:-1], channels[1:]))

    def forward(self, x, mask=None):
        for lin, norm in self:
            x = leaky_relu02(norm(lin(x), mask))
        return x


class VectorMLP(nn.ModuleList):
    """Stack of (Linear no-bias per component -> VectorNonLin) layers on
    ``[..., 2, C]`` vector fields."""

    def __init__(self, channels: Sequence[int]):
        super().__init__(
            nn.Sequential(nn.Linear(c_in, c_out, bias=False),
                          VectorNonLin(c_out))
            for c_in, c_out in zip(channels[:-1], channels[1:]))

    def forward(self, v, mask=None):
        for lin, nonlin in self:
            v = nonlin(lin(v), mask)
        return v
