"""DeltaNet models: classification (serving and the train step) and
segmentation (serving)."""

from .deltanet_base import (DeltaNetBase, build_dense_operators_fused,
                            build_operators)
from .deltanet_classification import DeltaNetClassification
from .deltanet_segmentation import DeltaNetSegmentation
from .pool import global_max_pool, global_mean_pool

__all__ = ["DeltaNetBase", "DeltaNetClassification", "DeltaNetSegmentation",
           "build_dense_operators_fused", "build_operators",
           "global_max_pool", "global_mean_pool"]
