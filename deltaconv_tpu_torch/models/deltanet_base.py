"""DeltaNet backbone: operator construction + stacked DeltaConvs
(counterpart of ``deltaconv_tpu/models/deltanet_base.py``).

The kNN graph and the grad/div operators are rebuilt on every forward
from the positions, so operator construction is part of the serving
path: kNN (``geometry.knn``'s exact route in XLA ``top_k``'s order, or
the ``knn_topk`` kernel for ``knn_method="approx"``), tangent frames
(from given normals, or, for clouds without normals, estimated from a
``normal_k``-NN graph by
``estimate_basis``: the same kNN route at K=10, then torch ops in f32),
the edge-plane gather and the WLS solve (two kernels), and, with
``dense_operators=True`` (the default), the dense assembly (a kernel,
f32, bf16 or int8). With ``dense_operators=False``, the JAX package's
large-cloud mode, the convs apply the coefficient-form operators as
they are (two kernels, ``coef_apply_grad`` and ``coef_apply_div``,
``O(N K)`` where the dense ``[B, 2, N, N]`` matrices are ``O(N^2)``).
Then the convs' neighbour maxes; in training the first conv's edge
statistics add the neighbour sum. ``fused_eval_build=True`` (off by default, as in JAX) routes bf16
eval forwards of uniform batches on the card through
:func:`build_dense_operators_fused`: ``knn_topk`` with its mean
distances, the ``fused_gather_wls`` kernel and the bf16 assembly, the
normalization deferred to the operators' ``scale``.

Mixed precision as in the JAX package: ``operator_dtype`` is the dtype of
the dense operators (the coefficient form ignores it: its coefficients
stay f32), ``compute_dtype`` that of the conv stack's activations
(positions are cast to it before the first conv); the operator build
itself always runs in f32. Both serve and train in bf16 (the production
config); in training the operator applies are differentiated in the
features. int8 is a dense operator dtype only, and serves only (the JAX
package's int8 serving mode: quantized operators and neighbour maxes;
its rounding has no gradient), so a train-mode forward on int8
operators raises.

Gradients for positions and normals (``pos.requires_grad_()``, as
``jax.grad`` of a loss in ``pos`` or ``normal``): in f32, and in bf16 in
train mode, dense (f32 or bf16 operators) or in coefficient form, the
build runs under autograd, through the VJPs of its kernels
(``scatter_rows`` for the gather, ``wls_bwd``), and the coefficients
take their cotangents from the applies (``coef_cotangent``, a sampled
product; the dense operators themselves carry no graph; on bf16
operators each apply's cotangent is rounded to bf16 and the applies'
are added in bf16, as the JAX package's). The kNN runs on detached
positions (its indices carry no gradient, as XLA's ``top_k``). When
neither input requires grad (or grad mode is off), the build keeps no
autograd graph. Routes whose forward has no VJP raise instead of
returning a partial gradient: bf16 compute in eval (its neighbour maxes
with the epilogue in the kernel have none, as on the JAX package's TPU
route), int8 operators (their rounding), the fused eval build (forward
only), and prebuilt ``operators`` (which serve and train for the
parameters).

The first conv reads ``features`` (``[B, N, in_channels]``) when given,
else the positions (``in_channels`` 3, the default); it is centralized
(``centralize_first``, the default) or takes the non-centralized max
branch of the other convs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from ..geometry.dense import DenseGradDiv, densify
from ..geometry.frames import build_tangent_basis, estimate_basis
from ..geometry.grad_div import GradDiv
from ..geometry.knn import knn
from ..nn.deltaconv import DeltaConv
from ..nn.mlp import MLP, VectorMLP
from ..ops import KERNEL_OPS, Ops
from ..ops.fused_build import fused_dense_build
from ..ops.wls_fused import build_grad_div_fused

__all__ = ["DeltaNetBase", "build_dense_operators_fused", "build_operators",
           "to_dtype"]

_DTYPES = {None: None, "float32": None, torch.float32: None,
           "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16,
           "int8": torch.int8, torch.int8: torch.int8}


def to_dtype(name):
    """A JAX-style dtype setting (None, "float32", "bfloat16", "int8" or
    the torch dtype) as the port's: None for f32, else the torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}: None, float32, bfloat16 "
                         "(or int8 for the operators)")
    return _DTYPES[name]


def _requires_grad(pos, normal) -> bool:
    """Whether the positions or normals (either may be None) are
    differentiated."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (pos, normal))


def build_operators(pos, k: int, normal=None, point_mask=None,
                    kernel_width: float = 1.0, regularizer: float = 0.001,
                    ops: Ops = KERNEL_OPS, operator_dtype=None,
                    knn_method: str = "exact",
                    dense_operators: bool = True,
                    normal_k: int = 10) -> DenseGradDiv | GradDiv:
    """Builds the grad/div operators of a batch of clouds, dense or in
    coefficient form.

    Args:
      pos: ``[B, N, 3]`` positions, or ``[N, 3]``: one cloud, built as a
        batch of one by the same kernels and returned as the operators of
        one cloud (every tensor without its batch axis; ``normal`` and
        ``point_mask`` then lack theirs too).
      k: neighbours of the operator graph (self loop in slot 0).
      normal: ``[B, N, 3]`` unit normals, or None: the frames are then
        estimated from a ``normal_k``-NN graph of the same ``knn_method``
        (``estimate_basis``, oriented by ``pos``).
      point_mask: optional ``[B, N]`` bool validity.
      kernel_width, regularizer: WLS parameters.
      ops: the kernels (default) or their plain versions.
      operator_dtype: dtype of the dense operators (None: f32, bf16, or
        int8: quantized per cloud, with the scales on the returned
        operators; serving only); ignored in coefficient form.
      knn_method: ``"exact"`` or ``"approx"`` (``geometry.knn``).
      dense_operators: densify (:class:`DenseGradDiv`), or return the
        coefficient form (:class:`GradDiv`, the large-cloud path).
      normal_k: neighbours of the normal graph when ``normal`` is None.

    The build is differentiable in ``pos`` (through estimated frames
    too) and ``normal`` (f32 and bf16 operators; the kNN runs on detached
    positions); int8 operators raise on inputs that require grad.
    """
    if pos.dim() == 2:
        return build_operators(
            pos[None], k, None if normal is None else normal[None],
            None if point_mask is None else point_mask[None], kernel_width,
            regularizer, ops, operator_dtype, knn_method, dense_operators,
            normal_k).unbatched()
    if (dense_operators and to_dtype(operator_dtype) == torch.int8
            and _requires_grad(pos, normal)):
        raise NotImplementedError(
            "int8 operators have no gradient (their rounding, as in the JAX "
            "package); differentiate positions or normals in f32")
    nbr_idx, nbr_mask = knn(pos.detach(), k, point_mask, knn_method,
                            ops.knn_topk)
    if normal is None:
        nbr_n, mask_n = knn(pos.detach(), normal_k, point_mask, knn_method,
                            ops.knn_topk)
        normal, x_basis, y_basis = estimate_basis(pos, nbr_n, mask_n,
                                                  orientation=pos)
    else:
        x_basis, y_basis = build_tangent_basis(normal)
    if point_mask is not None:
        nbr_mask = nbr_mask & point_mask[:, :, None]
    gd = build_grad_div_fused(pos, normal, x_basis, y_basis, nbr_idx,
                              nbr_mask, kernel_width, regularizer, ops)
    if dense_operators:
        return densify(gd, ops, to_dtype(operator_dtype))
    # The gather plan of the coefficient form: built once here, it serves
    # the forward's eight applies.
    return dataclasses.replace(gd, plan=ops.coef_plan(
        pos.detach(), gd.nbr_idx, point_mask))


def build_dense_operators_fused(pos, k: int, normal,
                                kernel_width: float = 1.0,
                                regularizer: float = 0.001,
                                knn_method: str = "approx",
                                ops: Ops = KERNEL_OPS) -> DenseGradDiv:
    """The eval build in two kernels after the kNN (JAX
    ``build_dense_operators_fused``): ``knn_topk`` with its mean
    distances (packed keys for ``"approx"``, else its exact body), the
    tangent frames, ``fused_gather_wls`` and the bf16 assembly, with the
    per-cloud normalization deferred to the operators' ``scale``. Needs
    given normals, no point mask and batched ``[B, N, 3]`` input;
    forward only. Matches ``densify(build_operators(...), bfloat16)`` to
    bf16 rounding."""
    if _requires_grad(pos, normal):
        raise NotImplementedError(
            "the fused eval build is forward only (as the JAX kernel, "
            "fused_build.py); differentiate positions or normals through "
            "build_operators (fused_eval_build=False)")
    idx, mean_dist = ops.knn_topk(pos, k, quantized=(knn_method == "approx"),
                                  return_mean_dist=True)
    mask = torch.ones(idx.shape, dtype=torch.bool, device=pos.device)
    x_basis, y_basis = build_tangent_basis(normal)
    avg = mean_dist.mean(dim=1)
    w_grad, w_div, row_norm = fused_dense_build(
        pos, normal, x_basis, y_basis, idx, mask, avg, kernel_width,
        regularizer, ops)
    inf_norm = row_norm.amax(dim=1)
    scale = torch.where(inf_norm > 1e-5, 1.0 / inf_norm, 1.0)
    return DenseGradDiv(nbr_idx=idx, nbr_mask=mask, w_grad=w_grad,
                        w_div=w_div, ops=ops, scale=scale)


class DeltaNetBase(nn.Module):
    """DGCNN-style backbone of sequential DeltaConv blocks on the
    positions: the first conv is centralized, the last drops the vector
    stream, and every stage's scalar output is returned for the heads.
    ``mlp_depth`` is the depth of every conv's internal MLPs (1 for
    classification, 2 for segmentation); ``in_channels`` is the width of
    the first conv's input (the positions' 3, or the ``features``'
    width); ``centralize_first=False`` takes the first conv's max branch
    on the features themselves (``PointMaxMLP``, or a non-centralized
    ``DeepMaxMLP``) instead of their edge differences;
    ``dense_operators=False`` applies
    the operators in coefficient form (large clouds); ``fused_eval_build=True``
    opts in to the fused eval build (JAX's switch, off by default: the
    JAX package measured it slower on its TPU)."""

    def __init__(self, conv_channels: Sequence[int], mlp_depth: int = 1,
                 num_neighbors: int = 20, grad_regularizer: float = 0.001,
                 grad_kernel_width: float = 1.0, operator_dtype=None,
                 compute_dtype=None, knn_method: str = "exact",
                 dense_operators: bool = True,
                 fused_eval_build: bool = False, in_channels: int = 3,
                 centralize_first: bool = True):
        super().__init__()
        self.fused_eval_build = fused_eval_build
        self.num_neighbors = num_neighbors
        self.grad_regularizer = grad_regularizer
        self.grad_kernel_width = grad_kernel_width
        self.knn_method = knn_method
        self.dense_operators = dense_operators
        widths = [in_channels, *conv_channels]
        last = len(conv_channels) - 1
        self.convs = nn.ModuleList(
            DeltaConv(widths[i], widths[i + 1], depth=mlp_depth,
                      centralized=(centralize_first and i == 0),
                      vector=(i != last))
            for i in range(len(conv_channels)))
        self.set_precision(compute_dtype, operator_dtype)

    def set_precision(self, compute_dtype, operator_dtype) -> None:
        """Sets both dtypes (None, "float32" or "bfloat16"; "int8" for
        ``operator_dtype`` too); the convs take ``compute_dtype``.
        Parameters are unchanged (f32)."""
        if to_dtype(compute_dtype) == torch.int8:
            raise ValueError("int8 is an operator dtype only (the int8 "
                             "serving mode computes in bf16); compute_dtype "
                             "takes None, float32 or bfloat16")
        self.compute_dtype = to_dtype(compute_dtype)
        self.operator_dtype = to_dtype(operator_dtype)
        for m in self.convs.modules():
            if isinstance(m, (MLP, VectorMLP)):
                m.dtype = self.compute_dtype

    def _fused_route(self, pos, normal, point_mask) -> bool:
        """JAX's gate of the fused eval build (``deltanet_base.py:185-192``),
        the card standing where JAX tests for the TPU: eval, dense bf16
        operators, given normals, no point mask, batched input, N a
        multiple of 128."""
        return (self.fused_eval_build and self.dense_operators
                and not self.training and point_mask is None
                and normal is not None and pos.dim() == 3
                and self.operator_dtype == torch.bfloat16 and pos.is_cuda
                and pos.shape[1] % 128 == 0)

    def forward(self, pos, normal=None, point_mask=None,
                ops: Ops = KERNEL_OPS, operators=None, group=None,
                features=None):
        """``pos [B, N, 3]`` -> list of per-stage ``[B, N, C_i]``.
        ``features``: ``[B, N, in_channels]`` input scalars of the first
        conv (None: the positions), differentiable as the positions are.
        ``operators``: a prebuilt operator object (the point-sharded
        forward's ``ShardedGradDiv``, eval or train) in place of the
        build. ``group``: the ranks that hold the other rows of the
        convs' BatchNorm statistics (train mode; None: this rank's)."""
        if (self.training and self.dense_operators
                and self.operator_dtype == torch.int8):
            raise NotImplementedError(
                "int8 operators serve only, as the JAX package's (eval; "
                "the quantization has no gradient): call model.eval()")
        differentiated = _requires_grad(pos, normal)
        if (not self.training and self.compute_dtype is not None
                and (differentiated or _requires_grad(features, None))):
            raise NotImplementedError(
                "bf16 eval has no gradient for positions, normals or "
                "features: its neighbour maxes with the epilogue "
                "(gather_max_affine, gather_matmul_max, gather_mlp_max) have "
                "no VJP, as on the JAX package's TPU route; differentiate in "
                "train mode (model.train()) or in f32 (compute_dtype=None)")
        if operators is not None:
            if differentiated:
                raise NotImplementedError(
                    "prebuilt operators carry no gradient for the positions "
                    "or normals they were built from; let the forward build "
                    "them (operators=None)")
            gd = operators
        elif self._fused_route(pos, normal, point_mask):
            gd = build_dense_operators_fused(
                pos, self.num_neighbors, normal, self.grad_kernel_width,
                self.grad_regularizer, self.knn_method, ops)
        else:
            # Without a differentiated input the build keeps no autograd
            # graph: the loss is differentiated for the parameters only.
            with torch.set_grad_enabled(differentiated):
                gd = build_operators(pos, self.num_neighbors, normal,
                                     point_mask, self.grad_kernel_width,
                                     self.grad_regularizer, ops,
                                     self.operator_dtype, self.knn_method,
                                     self.dense_operators)
        x = pos if features is None else features
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        v = gd.grad(x)
        out = []
        across = {} if group is None else {"group": group}
        for conv in self.convs:
            x, v = conv(x, v, gd, point_mask, **across)
            out.append(x)
        return out
