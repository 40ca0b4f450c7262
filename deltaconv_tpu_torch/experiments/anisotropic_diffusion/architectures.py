"""Image-domain ResNets of six convolution-operator families
(counterpart of ``experiments/anisotropic_diffusion/architectures.py``).

Each network is a residual stack of one operator family, trained to
mimic Perona-Malik anisotropic diffusion: the paper's Figure 2
demonstration that DeltaConv's gradient/divergence coupling can learn
anisotropic behaviour that isotropic operators cannot. Families: CNN (3x3
convs), DeltaConv (gradient -> vector MLP + norm nonlinearity ->
divergence), DiffusionNet-style (isotropic diffusion + gradient dot
features), EdgeConv, PointNet++ and GCN on the 3x3 pixel neighbourhood.
Images are ``[B, H, W, C]``.

Parameters are named as the flax modules' (``conv{i}``, ``res{i}``,
``vconv{i}``, ``vbias{i}``), and :func:`state_dict_from_flax_study`
carries a JAX network's parameters into the matching ``state_dict``. The
dense layers draw torch's Linear init (the JAX study's
``torch_linear_kernel``), the 3x3 convolutions flax's default
(``lecun_normal``: a normal truncated at two deviations, variance
``1 / fan_in``), the vector biases ``U(-1e-4, 1e-4)``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from .diffusion import laplacian, spatial_gradient

__all__ = ["ALL_NETS", "ConvNet", "DeltaNet", "DiffusionNet", "EdgeNet",
           "GCN", "PointNet", "state_dict_from_flax_study"]


def _lrelu(x):
    return torch.where(x >= 0, x, 0.2 * x)


def _unfold3x3(x):
    """All 9 shifted copies of the image: ``[B, H, W, C] -> [B, H, W, 9,
    C]`` with zero padding, in the JAX study's order."""
    outs = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = torch.roll(x, (dy, dx), dims=(1, 2))  # a new tensor
            if dy:  # zero the wrapped row and column
                shifted[:, -1 if dy == -1 else 0] = 0
            if dx:
                shifted[:, :, -1 if dx == -1 else 0] = 0
            outs.append(shifted)
    return torch.stack(outs, dim=-2)


def _lecun_normal_(weight, fan_in):
    """flax's ``lecun_normal``: truncated at +-2 deviations, rescaled so
    that the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


class _ResStack(nn.Module):
    """Shared residual scaffolding: per-layer operator + 1x1 residual
    projection (where the width changes) + LeakyReLU(0.2). Subclasses
    build each layer's operator weights in :meth:`_layer` and apply them
    in :meth:`_op`."""

    def __init__(self, num_layers: int = 8, out_channels: int = 32,
                 in_channels: int = 1):
        super().__init__()
        self.widths = [out_channels] * num_layers
        self.widths[-1] = in_channels
        c = in_channels
        for i, w in enumerate(self.widths):
            if c != w:
                self.add_module(f"res{i}", nn.Linear(c, w, bias=False))
            self._layer(i, c, w)
            c = w

    def forward(self, x):
        for i, w in enumerate(self.widths):
            r = getattr(self, f"res{i}")(x) if x.shape[-1] != w else x
            x = _lrelu(r + self._op(i, x, w))
        return x


class ConvNet(_ResStack):
    """Plain 3x3 image convolutions."""

    @staticmethod
    def net_name():
        return "CNN"

    def _layer(self, i, c, w):
        conv = nn.Conv2d(c, w, 3, padding=1, bias=False)
        _lecun_normal_(conv.weight, 9 * c)
        self.add_module(f"conv{i}", conv)

    def _op(self, i, x, w):
        out = getattr(self, f"conv{i}")(x.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)


class DeltaNet(_ResStack):
    """Simplified DeltaConv: grad -> per-channel vector MLP + norm
    nonlinearity -> div."""

    @staticmethod
    def net_name():
        return "DeltaConv"

    def _layer(self, i, c, w):
        self.add_module(f"vconv{i}", nn.Linear(c, w, bias=False))
        self.register_parameter(f"vbias{i}", nn.Parameter(
            torch.empty(w).uniform_(-1e-4, 1e-4)))
        self.add_module(f"conv{i}", nn.Linear(c + w, w, bias=False))

    def _op(self, i, x, w):
        gx, gy = spatial_gradient(x)
        v = getattr(self, f"vconv{i}")(torch.stack([gx, gy], dim=-2))
        # A norm whose gradient is 0 where the image gradient is exactly
        # zero (constant regions), as JAX's.
        sq = (v * v).sum(dim=-2, keepdim=True)
        pos = sq > 0
        mag = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
        scaled = torch.relu(mag + getattr(self, f"vbias{i}"))
        v = v * (scaled / torch.clamp(mag, min=1e-5))
        div = (spatial_gradient(v[..., 0, :])[0]
               + spatial_gradient(v[..., 1, :])[1])
        return getattr(self, f"conv{i}")(torch.cat([x, div], dim=-1))


class DiffusionNet(_ResStack):
    """Isotropic diffusion + gradient-dot features."""

    @staticmethod
    def net_name():
        return "DiffusionNet"

    def _layer(self, i, c, w):
        self.add_module(f"vconv{i}", nn.Linear(c, c, bias=False))
        self.add_module(f"conv{i}", nn.Linear(3 * c, w, bias=False))

    def _op(self, i, x, w):
        gx, gy = spatial_gradient(x)
        v = torch.stack([gx, gy], dim=-2)
        scalar_v = torch.tanh((v * getattr(self, f"vconv{i}")(v)).sum(-2))
        return getattr(self, f"conv{i}")(
            torch.cat([x, -laplacian(x), scalar_v], dim=-1))


class EdgeNet(_ResStack):
    """EdgeConv on the pixel grid: MLP([x_i, x_j - x_i]) + max."""

    @staticmethod
    def net_name():
        return "EdgeConv"

    def _layer(self, i, c, w):
        self.add_module(f"conv{i}", nn.Linear(2 * c, w, bias=False))

    def _op(self, i, x, w):
        nbr = _unfold3x3(x)
        center = nbr[..., 4:5, :]
        edge = torch.cat([center.expand_as(nbr), nbr - center], dim=-1)
        return _lrelu(getattr(self, f"conv{i}")(edge)).amax(dim=-2)


class PointNet(_ResStack):
    """PointNet++ on the pixel grid: MLP(x_j) + max."""

    @staticmethod
    def net_name():
        return "PointNet++"

    def _layer(self, i, c, w):
        self.add_module(f"conv{i}", nn.Linear(c, w, bias=False))

    def _op(self, i, x, w):
        return _lrelu(getattr(self, f"conv{i}")(_unfold3x3(x))).amax(dim=-2)


class GCN(_ResStack):
    """GCN on the pixel grid: mean of MLP(x_j)."""

    @staticmethod
    def net_name():
        return "GCN"

    def _layer(self, i, c, w):
        self.add_module(f"conv{i}", nn.Linear(c, w, bias=False))

    def _op(self, i, x, w):
        return getattr(self, f"conv{i}")(_unfold3x3(x)).mean(dim=-2)


ALL_NETS = [DeltaNet, EdgeNet, PointNet, GCN, DiffusionNet, ConvNet]


def state_dict_from_flax_study(params) -> Dict[str, torch.Tensor]:
    """A study network's flax ``params`` (nested dicts of arrays, with or
    without the ``"params"`` level) -> its ``state_dict``: Dense kernels
    ``[in, out]`` transposed to ``[out, in]``, Conv kernels HWIO to OIHW,
    the vector biases as they are."""
    params = params.get("params", params)
    sd = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            kernel = np.asarray(leaf["kernel"])
            kernel = (kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4
                      else kernel.T)
            sd[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(kernel))
        else:
            sd[name] = torch.tensor(np.asarray(leaf))
    return sd
