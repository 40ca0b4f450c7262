"""Dropout with masks from an explicit generator (counterpart of the
``flax.linen.Dropout`` of the classification head)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Dropout"]


class Dropout(nn.Module):
    """In training, keeps each entry with probability ``1 - rate`` and
    scales the kept ones by ``1 / (1 - rate)``, as flax does; the
    identity in eval or at rate 0. The mask is drawn from ``generator``,
    never from torch's global generator, so a seed fixes a train step."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout draws its mask from an "
                             "explicit torch.Generator: pass generator=")
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, 0.0)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
