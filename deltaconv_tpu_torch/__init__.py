"""deltaconv_tpu_torch: the DeltaConv f32 serving path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``deltaconv_tpu`` (JAX, TPU), which stays the reference. This
package imports neither JAX nor ``deltaconv_tpu``. Its four kernels
(``csrc/*.cu``) are built with ``nvcc`` at first use on a CUDA tensor;
on CPU tensors every kernel wrapper runs its plain PyTorch version.

    from deltaconv_tpu_torch import (DeltaNetClassification,
                                     InferenceEngine, state_dict_from_flax)
"""

from .models import DeltaNetClassification
from .ops import KERNEL_OPS, PLAIN_OPS, launch_counts, reset_launch_counts
from .serving import InferenceEngine
from .utils import state_dict_from_flax

__all__ = ["DeltaNetClassification", "InferenceEngine", "KERNEL_OPS",
           "PLAIN_OPS", "launch_counts", "reset_launch_counts",
           "state_dict_from_flax"]
