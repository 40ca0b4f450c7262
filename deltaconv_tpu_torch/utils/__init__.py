"""Utilities: weight conversion and visualization export."""

from .ply_export import save_feature, save_ply, write_ply
from .weights import state_dict_from_flax

__all__ = ["save_feature", "save_ply", "state_dict_from_flax", "write_ply"]
