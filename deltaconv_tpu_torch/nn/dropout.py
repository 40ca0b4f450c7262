"""Dropout with masks from an explicit generator (counterpart of the
``flax.linen.Dropout`` of the heads)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..parallel.collectives import rank_and_size

__all__ = ["Dropout", "rank_block"]


def rank_block(x, group=None, dim: int = 0):
    """``(full_shape, offset)`` of ``x`` as this rank's block along
    ``dim`` of a tensor split evenly over ``group``'s ranks in rank
    order (the batch under data parallelism, the points of one cloud
    under point sharding)."""
    rank, size = rank_and_size(group)
    full = list(x.shape)
    full[dim] *= size
    return tuple(full), rank * x.shape[dim]


class Dropout(nn.Module):
    """In training, keeps each entry with probability ``1 - rate`` and
    scales the kept ones by ``1 / (1 - rate)``, as flax does; the
    identity in eval or at rate 0. The mask is drawn from ``generator``,
    never from torch's global generator, so a seed fixes a train step.

    A rank that holds one block of a larger tensor passes its
    ``full_shape`` and the block's ``offset`` along the one axis where
    the two shapes differ: it draws the mask of the whole tensor and
    keeps its block, so ranks that share the generator's state drop as
    one process would (:func:`rank_block`)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                full_shape: Optional[Sequence[int]] = None,
                offset: int = 0):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout draws its mask from an "
                             "explicit torch.Generator: pass generator=")
        keep_prob = 1.0 - self.rate
        full = tuple(x.shape) if full_shape is None else tuple(full_shape)
        keep = torch.rand(full, generator=generator,
                          device=x.device) < keep_prob
        parted = [d for d, (a, b) in enumerate(zip(x.shape, full)) if a != b]
        if parted:
            keep = keep.narrow(parted[0], offset, x.shape[parted[0]])
        return torch.where(keep, x / keep_prob, 0.0)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
