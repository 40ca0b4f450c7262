"""Weight conversion."""

from .weights import state_dict_from_flax

__all__ = ["state_dict_from_flax"]
