"""Utilities: weight conversion, visualization export and profiling."""

from .ply_export import save_feature, save_ply, write_ply
from .profiling import Throughput, trace
from .weights import state_dict_from_flax

__all__ = ["Throughput", "save_feature", "save_ply", "state_dict_from_flax",
           "trace", "write_ply"]
