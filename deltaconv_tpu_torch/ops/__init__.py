"""The hand-written CUDA kernels of the f32 serving path, each beside its
plain PyTorch version.

Every kernel wrapper takes its plain version for a CPU tensor and
launches the kernel for a CUDA tensor (or raises). :data:`KERNEL_OPS`
and :data:`PLAIN_OPS` bundle the four functions so that a caller can run
the whole model through the kernels or through the plain versions on the
same device, which is how the kernel path is checked on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ._lib import launch_counts, library, reset_launch_counts
from .densify_op import densify_coefs, densify_coefs_plain
from .gather_max import gather_max, gather_max_plain, masked_nbr_max
from .gather_rows import gather_rows, gather_rows_plain
from .wls_fused import build_grad_div_fused, wls, wls_plain

__all__ = ["KERNEL_OPS", "PLAIN_OPS", "Ops", "build_grad_div_fused",
           "densify_coefs", "densify_coefs_plain", "gather_max",
           "gather_max_plain", "gather_rows", "gather_rows_plain",
           "launch_counts", "library", "masked_nbr_max",
           "reset_launch_counts", "wls", "wls_plain"]


class Ops(NamedTuple):
    """The four kernel-backed functions the serving path calls."""

    gather_rows: Callable
    wls: Callable
    densify_coefs: Callable
    gather_max: Callable


KERNEL_OPS = Ops(gather_rows, wls, densify_coefs, gather_max)
PLAIN_OPS = Ops(gather_rows_plain, wls_plain, densify_coefs_plain,
                gather_max_plain)
