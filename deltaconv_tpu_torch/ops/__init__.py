"""The hand-written CUDA kernels of the serving paths (classification and
segmentation; f32, bf16 and int8; dense or coefficient-form operators;
one large cloud point-sharded) and the train steps (classification and
segmentation; f32 and bf16), the fused eval build, and the backward of
the operator build (gradients for positions and normals), each beside
its plain PyTorch version.

Every kernel wrapper takes its plain version for a CPU tensor and
launches the kernel for a CUDA tensor (or raises). :data:`KERNEL_OPS`
and :data:`PLAIN_OPS` bundle the twenty-three functions the models and the
operator objects' aggregation hooks call so that a caller can run a
forward, or a whole train step, through the kernels or through the plain
versions on the same device, which is how the kernel path is checked on
the card; a plain entry is differentiated through plain versions only.
The gather is differentiable in its table, the coefficient-form applies
in their features and coefficients, the neighbour max (f32 or bf16),
min/max and sum in their features, the bf16
gather-then-matmul max of training in its input and weight, the edge MLP
of the segmentation train step in its input, affine, weight and self
slot, the build's gather, WLS solve and dense assembly in the positions
and frames (their backward kernels, ``scatter_rows``, ``wls_bwd`` and
``densify_bwd``, are reached through these Functions, as the max's
``gather_max_bwd`` and the min/max's ``gather_minmax_bwd`` are), with the
same gradient routing on both. The coefficients' cotangent of every
apply, dense or coefficient form, is ``coef_cotangent``, a sampled
product that forms only the edges' entries.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ._lib import launch_counts, library, reset_launch_counts
from .coef_apply import (CoefPlan, coef_apply_div, coef_apply_div_plain,
                         coef_apply_grad, coef_apply_grad_plain, coef_plan,
                         coef_plan_plain)
from .coef_cotangent import coef_cotangent, coef_cotangent_plain
from .densify_op import (densify_bwd, densify_bwd_plain, densify_coefs,
                         densify_coefs_int8, densify_coefs_int8_plain,
                         densify_coefs_plain)
from .gather_max import (bn_lrelu_epilogue, gather_matmul_max,
                         gather_matmul_max_int8, gather_matmul_max_int8_plain,
                         gather_matmul_max_plain, gather_matmul_max_train,
                         gather_matmul_max_train_plain,
                         gather_matmul_max_win, gather_matmul_max_win_plain,
                         gather_matmul_minmax, gather_matmul_minmax_plain,
                         gather_max,
                         gather_max_affine, gather_max_affine_plain,
                         gather_max_bwd, gather_max_bwd_plain,
                         gather_max_int8, gather_max_int8_plain,
                         gather_max_plain, gather_max_win,
                         gather_max_win_plain, gather_minmax,
                         gather_minmax_bwd, gather_minmax_bwd_plain,
                         gather_minmax_plain, gather_minmax_win,
                         gather_minmax_win_plain, int8_quantize,
                         masked_nbr_max)
from .edge_mlp import (edge_delta_mlp, edge_delta_mlp_plain, edge_mlp_bwd,
                       edge_mlp_bwd_edges, edge_mlp_bwd_edges_plain,
                       edge_mlp_bwd_plain, edge_mlp_bwd_sum,
                       edge_mlp_bwd_sum_plain, edge_mlp_fwd,
                       edge_mlp_fwd_plain)
from .fused_build import (fused_dense_build, fused_gather_wls,
                          fused_gather_wls_plain)
from .gather_mlp_max import (gather_max_merge, gather_max_merge_plain,
                             gather_mlp_max, gather_mlp_max_plain, mlp_chain,
                             mlp_rows, mlp_rows_plain)
from .gather_rows import (gather_rows, gather_rows_plain, inverse_adjacency,
                          inverse_adjacency_plain, scatter_rows,
                          scatter_rows_plain)
from .gather_sum import (adjacency, adjacency_plain, gather_sum,
                         gather_sum_bwd, gather_sum_bwd_plain, gather_sum_fwd,
                         gather_sum_fwd_plain, gather_sum_plain)
from .knn_bucketed import knn_topk_bucketed, knn_topk_bucketed_plain
from .knn_topk import (knn_topk, knn_topk_plain, knn_topk_table,
                       knn_topk_table_plain)
from .wls_fused import (build_grad_div_fused, wls, wls_bwd, wls_bwd_plain,
                        wls_plain)

__all__ = ["CoefPlan", "KERNEL_OPS", "PLAIN_OPS", "Ops", "adjacency",
           "adjacency_plain", "bn_lrelu_epilogue", "build_grad_div_fused",
           "coef_apply_div", "coef_apply_div_plain", "coef_apply_grad",
           "coef_apply_grad_plain", "coef_cotangent", "coef_cotangent_plain",
           "coef_plan", "coef_plan_plain",
           "densify_bwd", "densify_bwd_plain", "densify_coefs",
           "densify_coefs_int8", "densify_coefs_int8_plain",
           "densify_coefs_plain", "edge_delta_mlp", "edge_delta_mlp_plain",
           "edge_mlp_bwd", "edge_mlp_bwd_edges", "edge_mlp_bwd_edges_plain",
           "edge_mlp_bwd_plain", "edge_mlp_bwd_sum", "edge_mlp_bwd_sum_plain",
           "edge_mlp_fwd",
           "edge_mlp_fwd_plain", "fused_dense_build", "fused_gather_wls",
           "fused_gather_wls_plain", "gather_matmul_max",
           "gather_matmul_max_int8", "gather_matmul_max_int8_plain",
           "gather_matmul_max_plain", "gather_matmul_max_train",
           "gather_matmul_max_train_plain", "gather_matmul_max_win",
           "gather_matmul_max_win_plain", "gather_matmul_minmax",
           "gather_matmul_minmax_plain", "gather_max", "gather_max_affine",
           "gather_max_affine_plain", "gather_max_bwd",
           "gather_max_bwd_plain", "gather_max_int8", "gather_max_int8_plain",
           "gather_max_plain", "gather_max_win",
           "gather_max_win_plain", "gather_minmax", "gather_minmax_bwd",
           "gather_minmax_bwd_plain", "gather_minmax_plain",
           "gather_minmax_win", "gather_minmax_win_plain",
           "gather_max_merge", "gather_max_merge_plain",
           "gather_mlp_max", "gather_mlp_max_plain",
           "gather_rows", "gather_rows_plain",
           "gather_sum", "gather_sum_bwd", "gather_sum_bwd_plain",
           "gather_sum_fwd", "gather_sum_fwd_plain", "gather_sum_plain",
           "int8_quantize", "inverse_adjacency", "inverse_adjacency_plain",
           "knn_topk", "knn_topk_bucketed",
           "knn_topk_bucketed_plain", "knn_topk_plain", "knn_topk_table",
           "knn_topk_table_plain", "launch_counts",
           "library",
           "masked_nbr_max", "mlp_chain", "mlp_rows", "mlp_rows_plain",
           "reset_launch_counts",
           "scatter_rows", "scatter_rows_plain", "wls", "wls_bwd",
           "wls_bwd_plain", "wls_plain"]


class Ops(NamedTuple):
    """The twenty-three kernel-backed functions the models and the
    aggregation hooks call."""

    gather_rows: Callable
    wls: Callable
    densify_coefs: Callable
    gather_max: Callable
    gather_sum: Callable
    knn_topk: Callable
    gather_max_affine: Callable
    gather_matmul_max: Callable
    gather_matmul_max_train: Callable
    gather_mlp_max: Callable
    densify_coefs_int8: Callable
    gather_max_int8: Callable
    gather_matmul_max_int8: Callable
    coef_apply_grad: Callable
    coef_apply_div: Callable
    knn_topk_table: Callable
    knn_topk_bucketed: Callable
    edge_delta_mlp: Callable
    fused_gather_wls: Callable
    gather_minmax: Callable
    gather_matmul_minmax: Callable
    coef_plan: Callable
    coef_cotangent: Callable


KERNEL_OPS = Ops(gather_rows, wls, densify_coefs, gather_max, gather_sum,
                 knn_topk, gather_max_affine, gather_matmul_max,
                 gather_matmul_max_train, gather_mlp_max, densify_coefs_int8,
                 gather_max_int8, gather_matmul_max_int8, coef_apply_grad,
                 coef_apply_div, knn_topk_table, knn_topk_bucketed,
                 edge_delta_mlp, fused_gather_wls, gather_minmax,
                 gather_matmul_minmax, coef_plan, coef_cotangent)
PLAIN_OPS = Ops(gather_rows_plain, wls_plain, densify_coefs_plain,
                gather_max_plain, gather_sum_plain, knn_topk_plain,
                gather_max_affine_plain, gather_matmul_max_plain,
                gather_matmul_max_train_plain, gather_mlp_max_plain,
                densify_coefs_int8_plain, gather_max_int8_plain,
                gather_matmul_max_int8_plain, coef_apply_grad_plain,
                coef_apply_div_plain, knn_topk_table_plain,
                knn_topk_bucketed_plain, edge_delta_mlp_plain,
                fused_gather_wls_plain, gather_minmax_plain,
                gather_matmul_minmax_plain, coef_plan_plain,
                coef_cotangent_plain)
