"""Scalar and vector MLP stacks (counterpart of
``deltaconv_tpu/nn/mlp.py``). Each scalar layer is bias-free Linear ->
BatchNorm -> LeakyReLU(0.2); each vector layer is bias-free Linear
(acting per component, hence equivariant) -> VectorNonLin. A ``mask``
over the rows leaves padded points out of the train-mode BatchNorm
statistics, and a ``group`` completes them over the ranks that hold the
other rows (``nonlin.batch_moments``). Parameter names follow the
upstream release: ``{j}.0.weight``, ``{j}.1.bn.*`` and
``{j}.1.batchnorm.bn.*``.

``dtype`` (None for f32, or ``torch.bfloat16``) is the compute dtype of
the JAX package's mixed precision: the Linear layers multiply the input
and the weight cast to it (f32 accumulation, result in ``dtype``, as
flax's ``Dense(dtype=...)``), BatchNorm runs in f32, and each layer's
output is cast back to ``dtype``. Parameters stay f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .nonlin import BatchNormSlot, VectorNonLin, leaky_relu02

__all__ = ["MLP", "ScalarVectorIdentity", "ScalarVectorMLP", "VectorMLP",
           "linear"]


def linear(lin: nn.Linear, x, dtype: Optional[torch.dtype]):
    """``lin(x)`` in ``dtype``: input and weight cast to it, its result
    in it (f32 when ``dtype`` is None)."""
    if dtype is None:
        return lin(x)
    return nn.functional.linear(x.to(dtype), lin.weight.to(dtype))


def _cast(x, dtype):
    return x if dtype is None else x.to(dtype)


class MLP(nn.ModuleList):
    """Stack of (Linear no-bias -> BatchNorm -> LeakyReLU) layers.
    ``channels`` lists the input width, then every layer's output
    width; ``nonlin=False`` leaves the LeakyReLU out (JAX's
    ``nonlin=None``)."""

    def __init__(self, channels: Sequence[int],
                 dtype: Optional[torch.dtype] = None, nonlin: bool = True):
        super().__init__(
            nn.Sequential(nn.Linear(c_in, c_out, bias=False),
                          BatchNormSlot(c_out))
            for c_in, c_out in zip(channels[:-1], channels[1:]))
        self.dtype = dtype
        self.nonlin = nonlin

    def forward(self, x, mask=None, group=None):
        act = leaky_relu02 if self.nonlin else (lambda h: h)
        for lin, norm in self:
            x = _cast(act(norm(linear(lin, x, self.dtype), mask, group)),
                      self.dtype)
        return x


class VectorMLP(nn.ModuleList):
    """Stack of (Linear no-bias per component -> VectorNonLin) layers on
    ``[..., 2, C]`` vector fields."""

    def __init__(self, channels: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__(
            nn.Sequential(nn.Linear(c_in, c_out, bias=False),
                          VectorNonLin(c_out))
            for c_in, c_out in zip(channels[:-1], channels[1:]))
        self.dtype = dtype

    def forward(self, v, mask=None, group=None):
        for lin, nonlin in self:
            v = _cast(nonlin(linear(lin, v, self.dtype), mask, group),
                      self.dtype)
        return v


class ScalarVectorMLP(nn.Module):
    """Paired scalar and vector MLPs over an ``(x, v)`` tuple (JAX
    ``ScalarVectorMLP``, the upstream export; no shipped model uses it):
    ``scalar_mlp`` (``MLP(channels)``, without its LeakyReLU when
    ``nonlin`` is False) on ``x``, and with ``vector_stream``
    ``vector_mlp`` (``VectorMLP(channels)``) on ``v``, returning ``(x,
    v)``; without it, ``x`` alone. ``channels`` lists the input width,
    then every layer's output width."""

    def __init__(self, channels: Sequence[int], nonlin: bool = True,
                 vector_stream: bool = True):
        super().__init__()
        self.scalar_mlp = MLP(channels, nonlin=nonlin)
        self.vector_mlp = VectorMLP(channels) if vector_stream else None

    def forward(self, xv, mask=None, group=None):
        x, v = xv if isinstance(xv, tuple) else (xv, None)
        x = self.scalar_mlp(x, mask, group)
        if self.vector_mlp is None:
            return x
        if v is None:
            raise ValueError(
                "vector_stream=True requires an (x, v) tuple input")
        return x, self.vector_mlp(v, mask, group)


class ScalarVectorIdentity(nn.Module):
    """The identity on an ``(x, v)`` tuple or a tensor (JAX
    ``ScalarVectorIdentity``, the upstream export)."""

    def forward(self, xv, mask=None, group=None):
        return xv
