"""Parallelism over the ranks of a ``torch.distributed`` group
(counterpart of ``deltaconv_tpu/parallel``):

* data parallelism (``mesh``): the batch split over the ranks,
  parameters, optimizer state and BatchNorm statistics replicated, the
  statistics, loss and gradients completed by the train step;
* point sharding (``point_sharding``): ONE large cloud's points spread
  over the ranks, the operator build, the forward and a train step;
* ``launch.run_ranks``: a group of spawned ranks on one host.
"""

from .collectives import (all_gather, pmax, pmean, pmean_gradients, psum,
                          rank_and_size)
from .mesh import make_mesh, shard_batch, shard_train_step
from .point_sharding import (ShardedGradDiv, pad_cloud,
                             point_sharded_classification, point_sharded_div,
                             point_sharded_grad, point_sharded_laplacian,
                             point_sharded_operators,
                             point_sharded_segmentation,
                             point_sharded_train_step, shard_rows)

__all__ = ["ShardedGradDiv", "all_gather", "make_mesh", "pad_cloud", "pmax",
           "pmean", "pmean_gradients", "point_sharded_classification",
           "point_sharded_div", "point_sharded_grad",
           "point_sharded_laplacian", "point_sharded_operators",
           "point_sharded_segmentation", "point_sharded_train_step", "psum",
           "rank_and_size", "shard_batch", "shard_rows", "shard_train_step"]
