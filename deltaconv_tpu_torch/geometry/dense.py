"""Dense form of the grad/div operators (counterpart of
``deltaconv_tpu/geometry/dense.py``, f32 and ``scale=None``).

``W_grad [B, 2, N, N]``: plane d maps scalars to the d-component;
``W_div [B, 2, N, N]``: plane d maps the d-component to scalars. Built
once per forward by the densify kernel, after which every operator
application in the conv stack is a batched f32 matmul (``torch.matmul``,
as the JAX package leaves it to XLA). Masked edges carry zero
coefficients, so the dense form needs no masking.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..ops.densify_op import densify_coefs
from ..ops.gather_max import gather_max
from ..ops.gather_sum import gather_sum
from .grad_div import GradDiv
from .nbr_ops import NeighborAggregations

__all__ = ["DenseGradDiv", "densify"]


@dataclass(frozen=True)
class DenseGradDiv(NeighborAggregations):
    """Dense grad/div operators plus the neighbour lists (for the
    scalar-stream max aggregation and the train-mode edge sums, which
    stay gathers)."""

    nbr_idx: torch.Tensor  # [B, N, K] int32
    nbr_mask: torch.Tensor  # [B, N, K] bool
    w_grad: torch.Tensor  # [B, 2, N, N]
    w_div: torch.Tensor  # [B, 2, N, N]
    gather_max_fn: Callable = gather_max
    gather_sum_fn: Callable = gather_sum

    def grad(self, x):
        """``[B, N, C] -> [B, N, 2, C]`` via one batched matmul."""
        out = torch.matmul(self.w_grad, x[:, None])  # [B, 2, N, C]
        return out.transpose(1, 2)

    def div(self, v):
        """``[B, N, 2, C] -> [B, N, C]`` as two component matmuls."""
        return (torch.matmul(self.w_div[:, 0], v[:, :, 0])
                + torch.matmul(self.w_div[:, 1], v[:, :, 1]))


def densify(gd: GradDiv, densify_fn=densify_coefs,
            gather_max_fn=gather_max,
            gather_sum_fn=gather_sum) -> DenseGradDiv:
    """Materializes a batched :class:`GradDiv` into its dense f32 form.
    ``densify_fn``, ``gather_max_fn`` and ``gather_sum_fn`` select the
    kernels or their plain versions. Unlike the JAX package (Pallas only
    at N >= 512 on the TPU), the kernel runs at every N."""
    w_grad, w_div = densify_fn(gd.nbr_idx, gd.grad_coef, gd.div_coef)
    return DenseGradDiv(nbr_idx=gd.nbr_idx, nbr_mask=gd.nbr_mask,
                        w_grad=w_grad, w_div=w_div,
                        gather_max_fn=gather_max_fn,
                        gather_sum_fn=gather_sum_fn)
