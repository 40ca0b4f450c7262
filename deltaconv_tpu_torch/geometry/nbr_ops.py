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
kernel choice (its ``ops``) in one place.

An operator object of one cloud (``nbr_idx [N, K]``, every tensor
without its batch axis, as the JAX package's single-cloud builds give)
takes unbatched features (``[N, C]``): each hook adds a batch axis of
one to its tensors (:meth:`NeighborAggregations.batched`), calls the same
kernel and drops the axis again.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect

import torch

from ..ops.gather_max import masked_nbr_max

__all__ = ["NeighborAggregations", "one_cloud"]


def _first(out):
    """``out`` (a tensor or a tuple of them) of a batch of one, without
    its batch axis."""
    if isinstance(out, tuple):
        return tuple(o[0] for o in out)
    return out[0]


def one_cloud(*names):
    """Decorator of an operator object's method whose arguments ``names``
    carry the batch axis: on the operators of one cloud, the method runs
    on :meth:`NeighborAggregations.batched` with ``[None]`` on those
    arguments (None passes as it is) and its result loses the axis
    again; on a batch it runs as it is."""
    def wrap(method):
        sig = inspect.signature(method)

        @functools.wraps(method)
        def call(self, *args, **kwargs):
            if not self.single:
                return method(self, *args, **kwargs)
            bound = sig.bind(self, *args, **kwargs)
            for name in names:
                if bound.arguments.get(name) is not None:
                    bound.arguments[name] = bound.arguments[name][None]
            bound.arguments["self"] = self.batched()
            return _first(method(*bound.args, **bound.kwargs))
        return call
    return wrap


class NeighborAggregations:
    """Mixin over dataclasses exposing ``nbr_idx``, ``nbr_mask`` and the
    ``ops`` (kernels or plain versions) to aggregate with. The kNN self
    loop sits in slot 0."""

    @property
    def single(self) -> bool:
        """True for the operators of one cloud (``nbr_idx [N, K]``)."""
        return self.nbr_idx.dim() == 2

    def batched(self):
        """This object as a batch of one (``[None]`` on every tensor
        field); a batched object as it is."""
        if not self.single:
            return self
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[None]
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def unbatched(self):
        """The single-cloud object of a batch of one (``[0]`` on every
        tensor field; a gather plan stays as it is, a batch of one, which
        :meth:`batched` hands back to the applies)."""
        if self.single:
            return self
        if self.nbr_idx.shape[0] != 1:
            raise ValueError("unbatched: a batch of one cloud only, got "
                             f"{self.nbr_idx.shape[0]}")
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[0]
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    @one_cloud("h")
    def nbr_max(self, h):
        """Masked neighbour max ``[B, N, C] -> [B, N, C]``; all-masked
        rows give 0."""
        return masked_nbr_max(h, self.nbr_idx, self.nbr_mask,
                              self.ops.gather_max)

    @one_cloud("h")
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

    @one_cloud("x")
    def nbr_matmul_minmax(self, x, w):
        """Masked ``(max, min)`` of ``(x @ w)[nbr]``: ``x`` and ``w`` cast
        to bf16, f32 accumulation, bf16 out
        (``ops.gather_matmul_minmax``); forward only. Rows with no valid
        neighbour give ``(-3e38, +3e38)`` rounded to bf16."""
        return self.ops.gather_matmul_minmax(
            x.to(torch.bfloat16), w.to(torch.bfloat16), self.nbr_idx,
            self.nbr_mask)

    @one_cloud("h", "mask")
    def nbr_sum(self, h, mask=None):
        """Masked neighbour sum ``[B, N, C] -> [B, N, C]`` over ``mask``
        (default: the graph's ``nbr_mask``)."""
        mask = self.nbr_mask if mask is None else mask
        return self.ops.gather_sum(h, self.nbr_idx, mask)

    @one_cloud("h")
    def nbr_max_affine(self, h, affine, sub_self: bool = False):
        """bf16 eval: masked neighbour max with the BatchNorm +
        LeakyReLU epilogue, ``affine = (sign, inv, mean, bias)``;
        ``sub_self`` subtracts the self row inside the sign fold."""
        return self.ops.gather_max_affine(h, self.nbr_idx, self.nbr_mask,
                                          affine, sub_self)

    @one_cloud("x")
    def nbr_matmul_max(self, x, w, affine=None):
        """bf16 eval: masked max of ``(x @ w)[nbr]`` (f32 accumulation),
        with the epilogue when ``affine`` is given."""
        return self.ops.gather_matmul_max(x, w, self.nbr_idx, self.nbr_mask,
                                          affine)

    @one_cloud("x")
    def nbr_matmul_max_train(self, x, w):
        """bf16 training: differentiable masked max of ``(x @ w)[nbr]``,
        each slot's product rounded to bf16 before the max, gradients to
        the single winning neighbour (for ``x`` and ``w``). Rows with no
        valid neighbour give ``-3e38``."""
        return self.ops.gather_matmul_max_train(x, w, self.nbr_idx,
                                                self.nbr_mask)

    @one_cloud("h")
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
        applied (``ops.gather_mlp_max`` with ``skip_slot0``). ``z0`` is
        one row (centralized) or a row a point."""
        if self.single:
            return self.batched().nbr_mlp_max(
                x[None], ws, affines, centralized,
                z0 if centralized else z0[None], epilogue)[0]
        return self.ops.gather_mlp_max(x, ws, affines, self.nbr_idx,
                                       self.nbr_mask, centralized, True, z0,
                                       epilogue)

    @one_cloud("y")
    def nbr_edge_mlp(self, y, a0, b0, w1, z0):
        """bf16 training: the differentiable edge MLP ``bf16(LeakyReLU((y_j
        - y_i) * a0 + b0)) @ w1`` of every slot, ``z0`` in the self slot,
        K-major ``[B, K, N, C1]`` bf16 (``ops.edge_delta_mlp``)."""
        return self.ops.edge_delta_mlp(y, a0, b0, w1, z0, self.nbr_idx)
