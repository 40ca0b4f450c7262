"""Normalization and vector non-linearities, eval mode (counterpart of
``deltaconv_tpu/nn/nonlin.py``).

The port serves only, so BatchNorm always normalizes with its running
statistics; batch statistics come with the training slice. Module and
buffer names follow the upstream release (``.bn.weight``,
``.bn.running_mean``, ...), so its ``state_dict``s load as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry.utils import safe_norm

EPS = 1e-8

__all__ = ["BatchNorm", "BatchNormSlot", "VectorNonLin", "leaky_relu02"]


def leaky_relu02(x):
    """LeakyReLU with the reference's negative_slope=0.2."""
    return torch.where(x >= 0, x, 0.2 * x)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis with eps 1e-5, computed as
    flax does: ``(x - mean) * (rsqrt(var + eps) * weight) + bias``."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def inv(self):
        """The per-channel multiplier ``rsqrt(var + eps) * weight``."""
        return torch.rsqrt(self.running_var + self.eps) * self.weight

    def forward(self, x):
        return (x - self.running_mean) * self.inv() + self.bias

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # Upstream checkpoints carry torch's step counter, which eval
        # never reads.
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class BatchNormSlot(nn.Module):
    """The upstream wrapper that holds its norm at ``.bn``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = BatchNorm(num_features)

    def forward(self, x):
        return self.bn(x)


class VectorNonLin(nn.Module):
    """Nonlinearity on vector norms, direction-preserving.

    Input ``[..., 2, C]``: the per-channel norms over the component axis
    are batch-normalized, passed through ReLU, and the vectors rescaled
    by ``relu(bn(norm)) / max(norm, 1e-8)``.
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.batchnorm = BatchNormSlot(num_features)

    def forward(self, v):
        n = safe_norm(v, dim=-2)  # [..., C]
        scale = torch.relu(self.batchnorm(n)) / torch.clamp(n, min=EPS)
        return v * scale[..., None, :]

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # Upstream's VectorNonLin also owns a bias that is dead code
        # whenever it batch-normalizes (every shipped config).
        state_dict.pop(prefix + "bias", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
