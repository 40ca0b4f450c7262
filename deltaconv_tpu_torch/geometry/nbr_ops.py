"""Neighbour aggregations shared by the operator objects (counterpart of
``deltaconv_tpu/geometry/nbr_ops.py``: ``nbr_max`` on every path,
``nbr_sum`` for the train-mode edge statistics). ``DeltaConv`` never
gathers through raw indices itself: it asks its operator object, which
keeps the kernel choice in one place."""

from __future__ import annotations

from ..ops.gather_max import masked_nbr_max

__all__ = ["NeighborAggregations"]


class NeighborAggregations:
    """Mixin over objects exposing ``nbr_idx``, ``nbr_mask`` and the
    ``gather_max_fn`` and ``gather_sum_fn`` to aggregate with."""

    def nbr_max(self, h):
        """Masked neighbour max ``[B, N, C] -> [B, N, C]``; all-masked
        rows give 0. The kNN self loop sits in slot 0."""
        return masked_nbr_max(h, self.nbr_idx, self.nbr_mask,
                              self.gather_max_fn)

    def nbr_sum(self, h, mask=None):
        """Masked neighbour sum ``[B, N, C] -> [B, N, C]`` over ``mask``
        (default: the graph's ``nbr_mask``)."""
        mask = self.nbr_mask if mask is None else mask
        return self.gather_sum_fn(h, self.nbr_idx, mask)
