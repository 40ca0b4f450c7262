"""Neighbour aggregations shared by the operator objects (counterpart of
``deltaconv_tpu/geometry/nbr_ops.py``: ``nbr_max`` on every path,
``nbr_minmax`` and ``nbr_matmul_minmax`` for the neighbour max and min
together, ``nbr_sum`` for the train-mode edge statistics,
``nbr_max_affine`` and
``nbr_matmul_max`` for the bf16 eval branches, ``nbr_matmul_max_train``
for the bf16 train branch of a lane-narrower conv, ``nbr_gather`` for
the edge tensor of a depth-2 centralized conv, ``nbr_mlp_max`` for the
bf16 eval branch of a depth-2 conv, ``nbr_edge_mlp`` for the fused bf16
train branch of a depth-2 centralized conv). ``DeltaConv`` never gathers
through raw indices itself: it asks its operator object, which keeps the
kernel choice (its ``ops``) in one place."""

from __future__ import annotations

import torch

from ..ops.gather_max import masked_nbr_max

__all__ = ["NeighborAggregations"]


class NeighborAggregations:
    """Mixin over objects exposing ``nbr_idx``, ``nbr_mask`` and the
    ``ops`` (kernels or plain versions) to aggregate with. The kNN self
    loop sits in slot 0."""

    def nbr_max(self, h):
        """Masked neighbour max ``[B, N, C] -> [B, N, C]``; all-masked
        rows give 0."""
        return masked_nbr_max(h, self.nbr_idx, self.nbr_mask,
                              self.ops.gather_max)

    def nbr_minmax(self, h):
        """Masked neighbour ``(max, min)`` ``[B, N, C] -> 2 x [B, N, C]``
        in one pass (``ops.gather_minmax``), f32 or bf16 (bf16 out);
        differentiable in ``h``, each cotangent to its first winning
        neighbour. Rows with no valid neighbour give ``(-3e38, +3e38)``
        (callers mask them) and route their cotangents to
        ``nbr_idx[..., 0]``, as JAX's. Every slot is a direct load, the
        self slot too, which equals JAX's ``self_slot0`` shortcut when
        ``nbr_idx[..., 0]`` is the point itself."""
        return self.ops.gather_minmax(h, self.nbr_idx, self.nbr_mask)

    def nbr_matmul_minmax(self, x, w):
        """Masked ``(max, min)`` of ``(x @ w)[nbr]``: ``x`` and ``w`` cast
        to bf16, f32 accumulation, bf16 out
        (``ops.gather_matmul_minmax``); forward only. Rows with no valid
        neighbour give ``(-3e38, +3e38)`` rounded to bf16."""
        return self.ops.gather_matmul_minmax(
            x.to(torch.bfloat16), w.to(torch.bfloat16), self.nbr_idx,
            self.nbr_mask)

    def nbr_sum(self, h, mask=None):
        """Masked neighbour sum ``[B, N, C] -> [B, N, C]`` over ``mask``
        (default: the graph's ``nbr_mask``)."""
        mask = self.nbr_mask if mask is None else mask
        return self.ops.gather_sum(h, self.nbr_idx, mask)

    def nbr_max_affine(self, h, affine, sub_self: bool = False):
        """bf16 eval: masked neighbour max with the BatchNorm +
        LeakyReLU epilogue, ``affine = (sign, inv, mean, bias)``;
        ``sub_self`` subtracts the self row inside the sign fold."""
        return self.ops.gather_max_affine(h, self.nbr_idx, self.nbr_mask,
                                          affine, sub_self)

    def nbr_matmul_max(self, x, w, affine=None):
        """bf16 eval: masked max of ``(x @ w)[nbr]`` (f32 accumulation),
        with the epilogue when ``affine`` is given."""
        return self.ops.gather_matmul_max(x, w, self.nbr_idx, self.nbr_mask,
                                          affine)

    def nbr_matmul_max_train(self, x, w):
        """bf16 training: differentiable masked max of ``(x @ w)[nbr]``,
        each slot's product rounded to bf16 before the max, gradients to
        the single winning neighbour (for ``x`` and ``w``). Rows with no
        valid neighbour give ``-3e38``."""
        return self.ops.gather_matmul_max_train(x, w, self.nbr_idx,
                                                self.nbr_mask)

    def nbr_gather(self, h):
        """Per-neighbour rows ``[B, N, C] -> [B, N, K, C]`` in ``h``'s
        dtype, through the component-major ``gather_rows`` (f32, exact
        for bf16 values) and a permute, as the JAX package's TPU route."""
        rows = self.ops.gather_rows(h.float().contiguous(), self.nbr_idx)
        return rows.permute(0, 3, 2, 1).to(h.dtype)

    def nbr_mlp_max(self, x, ws, affines, centralized, z0, epilogue):
        """bf16 eval: masked max over the neighbours of the eval MLP
        (``ws``, intermediate ``affines``) applied per edge, the self
        slot ``z0`` merged and the epilogue ``(sign, inv, mean, bias)``
        applied (``ops.gather_mlp_max`` with ``skip_slot0``)."""
        return self.ops.gather_mlp_max(x, ws, affines, self.nbr_idx,
                                       self.nbr_mask, centralized, True, z0,
                                       epilogue)

    def nbr_edge_mlp(self, y, a0, b0, w1, z0):
        """bf16 training: the differentiable edge MLP ``bf16(LeakyReLU((y_j
        - y_i) * a0 + b0)) @ w1`` of every slot, ``z0`` in the self slot,
        K-major ``[B, K, N, C1]`` bf16 (``ops.edge_delta_mlp``)."""
        return self.ops.edge_delta_mlp(y, a0, b0, w1, z0, self.nbr_idx)
