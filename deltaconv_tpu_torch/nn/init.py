"""Reference-faithful initialization (counterpart of
``deltaconv_tpu/nn/init.py``): every linear layer of the reference is
``torch.nn.Linear`` with its defaults, whose weight and bias are
``U(-1/sqrt(fan_in), +1/sqrt(fan_in))``. Drawn here from an explicit
``torch.Generator`` so that a seed fixes the weights."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["torch_linear_init_"]


@torch.no_grad()
def torch_linear_init_(module: nn.Module,
                       generator: Optional[torch.Generator] = None) -> None:
    """Re-draws every ``nn.Linear`` in ``module`` (registration order)
    from ``U(+-1/sqrt(fan_in))`` with ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
