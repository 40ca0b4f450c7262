"""Normalization and vector non-linearities (counterpart of
``deltaconv_tpu/nn/nonlin.py``).

BatchNorm follows flax's ``BatchNorm`` as the JAX package configures it,
which differs from torch's ``BatchNorm1d`` in training:

- the batch statistics reduce over every axis but the last, over the
  rows an optional mask keeps, with flax's fast variance
  ``max(0, E[x^2] - E[x]^2)``;
- the running statistics move as ``0.9 * running + 0.1 * batch`` with
  the BIASED batch variance (torch would use the unbiased one).

Statistics and normalization run in f32 on bf16 inputs too (the JAX
package's ``dtype=float32`` BatchNorm under mixed precision), in
training as in eval, and the gradient reaches the bf16 input through
the widening cast; the result is f32 and callers cast it back.

Train or eval is the module's ``training`` flag (``model.train()`` /
``model.eval()``). Module and buffer names follow the upstream release
(``.bn.weight``, ``.bn.running_mean``, ...), so its ``state_dict``s load
as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry.utils import safe_norm

EPS = 1e-8

__all__ = ["BatchNorm", "BatchNormSlot", "VectorNonLin", "batch_moments",
           "leaky_relu02"]


def leaky_relu02(x):
    """LeakyReLU with the reference's negative_slope=0.2."""
    return torch.where(x >= 0, x, 0.2 * x)


def batch_moments(x, mask=None, clamp: bool = True):
    """Per-channel ``(mean, var)`` of ``x [..., C]`` over every other
    axis, restricted to the rows where ``mask`` (``x.shape[:-1]``) is
    true; ``var`` is the fast variance ``E[x^2] - E[x]^2``, clamped at 0
    as flax's BatchNorm does unless ``clamp`` is False (the commuted
    bf16 train branch of ``PointMaxMLP``, whose JAX counterpart hands its
    BatchNorm the unclamped one)."""
    lead = tuple(range(x.dim() - 1))
    if mask is None:
        mean = x.mean(dim=lead)
        mean2 = (x * x).mean(dim=lead)
    else:
        m = mask[..., None]
        xm = torch.where(m, x, 0.0)
        count = m.sum(dim=lead).to(x.dtype)
        mean = xm.sum(dim=lead) / count
        mean2 = (xm * xm).sum(dim=lead) / count
    var = mean2 - mean * mean
    return mean, torch.clamp(var, min=0.0) if clamp else var


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with eps 1e-5 and flax's momentum
    0.9, normalizing as flax does:
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``."""

    momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def inv(self, var=None):
        """The per-channel multiplier ``rsqrt(var + eps) * weight``
        (``var`` defaults to the running variance)."""
        if var is None:
            var = self.running_var
        return torch.rsqrt(var + self.eps) * self.weight

    @torch.no_grad()
    def update_running(self, mean, var):
        """Moves the running statistics towards batch statistics."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x, mask=None):
        """``mask``: optional validity over ``x.shape[:-1]``; masked rows
        are left out of the batch statistics (train mode only). Returns
        f32."""
        x = x.float()
        if not self.training:
            return (x - self.running_mean) * self.inv() + self.bias
        mean, var = batch_moments(x, mask)
        self.update_running(mean, var)
        return (x - mean) * self.inv(var) + self.bias

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # Upstream checkpoints carry torch's step counter, which this
        # BatchNorm never reads.
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class BatchNormSlot(nn.Module):
    """The upstream wrapper that holds its norm at ``.bn``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = BatchNorm(num_features)

    def forward(self, x, mask=None):
        return self.bn(x, mask)


class VectorNonLin(nn.Module):
    """Nonlinearity on vector norms, direction-preserving.

    Input ``[..., 2, C]``: the per-channel norms over the component axis
    are batch-normalized, passed through ReLU, and the vectors rescaled
    by ``relu(bn(norm)) / max(norm, 1e-8)``. The norm and its scale are
    f32 whatever the input's dtype; the scale is cast to that dtype
    before the rescale (a bf16 product for bf16 vectors).
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.batchnorm = BatchNormSlot(num_features)

    def forward(self, v, mask=None):
        """``mask``: optional validity over ``v.shape[:-2]``, left out of
        the norms' batch statistics."""
        n = safe_norm(v.float(), dim=-2)  # [..., C]
        scale = torch.relu(self.batchnorm(n, mask)) / torch.clamp(n, min=EPS)
        return v * scale[..., None, :].to(v.dtype)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # Upstream's VectorNonLin also owns a bias that is dead code
        # whenever it batch-normalizes (every shipped config).
        state_dict.pop(prefix + "bias", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
