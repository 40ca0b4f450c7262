"""Coefficient-form grad/div operators (counterpart of the ``GradDiv`` of
``deltaconv_tpu/geometry/grad_div.py``, batched). Built by
:func:`~deltaconv_tpu_torch.ops.wls_fused.build_grad_div_fused`; the
backbone densifies them (:mod:`.dense`) unless the model is built with
``dense_operators=False``, the large-cloud path, where the convs apply
them as they are: ``grad`` and ``div`` gather the ``K`` neighbour rows
and weight them by the coefficients (``ops.coef_apply_grad``,
``ops.coef_apply_div``), ``O(N K)`` where the dense form is ``O(N^2)``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .nbr_ops import NeighborAggregations

__all__ = ["GradDiv"]


@dataclass(frozen=True)
class GradDiv(NeighborAggregations):
    """Gradient + divergence operators of a batch of clouds, and the
    ``ops`` (kernels or plain versions) they and the neighbour
    aggregations go through.

    Attributes:
      nbr_idx: ``[B, N, K]`` int32 neighbour indices (self in slot 0).
      nbr_mask: ``[B, N, K]`` bool edge validity.
      grad_coef: ``[B, N, K, 2]`` f32: ``(grad x)[n, d] = sum_k
        grad_coef[n, k, d] * x[nbr_idx[n, k]]``.
      div_coef: ``[B, N, K, 2]`` f32: ``(div v)[n] = sum_k sum_d
        div_coef[n, k, d] * v[nbr_idx[n, k], d]``.
      ops: ``ops.Ops``.
      plan: the gather plan of ``nbr_idx`` (``ops.CoefPlan``), or None;
        ``build_operators`` fills it, and the applies of wide rows take
        it (the same results, fewer row reads).
    """

    nbr_idx: torch.Tensor
    nbr_mask: torch.Tensor
    grad_coef: torch.Tensor
    div_coef: torch.Tensor
    ops: object
    plan: object = None

    int8 = False  # no quantized form (the int8 serving mode is dense)

    def grad(self, x):
        """``[B, N, C] -> [B, N, 2, C]`` in ``x``'s dtype."""
        return self.ops.coef_apply_grad(x, self.grad_coef, self.nbr_idx,
                                        self.plan)

    def div(self, v):
        """``[B, N, 2, C] -> [B, N, C]`` in ``v``'s dtype."""
        return self.ops.coef_apply_div(v, self.div_coef, self.nbr_idx,
                                       self.plan)
