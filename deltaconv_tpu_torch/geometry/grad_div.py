"""Coefficient-form grad/div operators (counterpart of the ``GradDiv``
container of ``deltaconv_tpu/geometry/grad_div.py``). The serving path
builds them with :func:`~deltaconv_tpu_torch.ops.wls_fused.build_grad_div_fused`
and densifies them at once (:mod:`.dense`); applying them in coefficient
form comes with the large-cloud slice (ROADMAP)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["GradDiv"]


@dataclass(frozen=True)
class GradDiv:
    """Gradient + divergence operators of a batch of clouds.

    Attributes:
      nbr_idx: ``[B, N, K]`` int32 neighbour indices (self in slot 0).
      nbr_mask: ``[B, N, K]`` bool edge validity.
      grad_coef: ``[B, N, K, 2]``: ``(grad x)[n, d] = sum_k
        grad_coef[n, k, d] * x[nbr_idx[n, k]]``.
      div_coef: ``[B, N, K, 2]``: ``(div v)[n] = sum_k sum_d
        div_coef[n, k, d] * v[nbr_idx[n, k], d]``.
    """

    nbr_idx: torch.Tensor
    nbr_mask: torch.Tensor
    grad_coef: torch.Tensor
    div_coef: torch.Tensor
