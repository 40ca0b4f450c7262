"""Neighbour aggregations shared by the operator objects (counterpart of
``deltaconv_tpu/geometry/nbr_ops.py``; only ``nbr_max`` is on the f32
serving path). ``DeltaConv`` never gathers through raw indices itself:
it asks its operator object, which keeps the kernel choice in one
place."""

from __future__ import annotations

from ..ops.gather_max import masked_nbr_max

__all__ = ["NeighborAggregations"]


class NeighborAggregations:
    """Mixin over objects exposing ``nbr_idx``, ``nbr_mask`` and the
    ``gather_max_fn`` to aggregate with."""

    def nbr_max(self, h):
        """Masked neighbour max ``[B, N, C] -> [B, N, C]``; all-masked
        rows give 0. The kNN self loop sits in slot 0."""
        return masked_nbr_max(h, self.nbr_idx, self.nbr_mask,
                              self.gather_max_fn)
