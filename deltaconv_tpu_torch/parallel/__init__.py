"""One large cloud spread over the ranks of a ``torch.distributed`` group
(counterpart of ``deltaconv_tpu/parallel``'s point sharding, eval)."""

from .collectives import all_gather, pmax, psum, rank_and_size
from .point_sharding import (ShardedGradDiv, pad_cloud,
                             point_sharded_classification, point_sharded_div,
                             point_sharded_grad, point_sharded_laplacian,
                             point_sharded_operators,
                             point_sharded_segmentation, shard_rows)

__all__ = ["ShardedGradDiv", "all_gather", "pad_cloud", "pmax",
           "point_sharded_classification", "point_sharded_div",
           "point_sharded_grad", "point_sharded_laplacian",
           "point_sharded_operators", "point_sharded_segmentation", "psum",
           "rank_and_size", "shard_rows"]
