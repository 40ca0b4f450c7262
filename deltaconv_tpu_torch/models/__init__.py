"""DeltaNet models of the serving path and the train step."""

from .deltanet_base import DeltaNetBase, build_operators
from .deltanet_classification import DeltaNetClassification
from .pool import global_max_pool, global_mean_pool

__all__ = ["DeltaNetBase", "DeltaNetClassification", "build_operators",
           "global_max_pool", "global_mean_pool"]
