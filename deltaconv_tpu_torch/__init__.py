"""deltaconv_tpu_torch: DeltaConv (anisotropic convolution on point
clouds) in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a); a port of ``deltaconv_tpu`` (JAX, TPU), which stays the
reference, and does all that it does:

- the per-forward operator build (kNN, tangent frames from given or
  estimated normals, the WLS grad/div, dense or in coefficient form) and
  the two-stream DeltaConv stack (``nn``; ``aggr`` max, mean or sum);
- the classification and segmentation nets (``models``; positions or
  per-point ``features`` in, ``in_channels`` wide), serving
  (``InferenceEngine``: f32, bf16 with approximate kNN, int8; voting; one
  large cloud point-sharded) and training (``training``: the train and
  eval steps, ``fit``, checkpoints, upstream ``.pt`` import), f32 and
  bf16, gradients for the positions and normals included;
- data parallelism and point sharding across ranks (``parallel``), the
  datasets and transforms (``data``, ``transforms``), the experiments'
  command lines (``experiments``) and profiling (``utils``).

This package imports neither JAX nor ``deltaconv_tpu``. Its kernels
(``csrc/*.cu``) are built with ``nvcc`` at first use on a CUDA tensor;
on CPU tensors every kernel wrapper runs its plain PyTorch version. The
entry points (``InferenceEngine``, ``create_train_state``) run on the
card unless the caller passes ``device="cpu"``.

    from deltaconv_tpu_torch import (DeltaNetClassification,
                                     DeltaNetSegmentation, InferenceEngine,
                                     state_dict_from_flax)
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)
"""

__version__ = "0.1.0"
version_info = (0, 1, 0)

from . import geometry  # noqa: E402,F401
from . import models  # noqa: E402,F401
from . import nn  # noqa: E402,F401
from . import transforms  # noqa: E402,F401
from .models import DeltaNetClassification, DeltaNetSegmentation  # noqa: E402
from .ops import (KERNEL_OPS, PLAIN_OPS, launch_counts,  # noqa: E402
                  reset_launch_counts)
from .serving import InferenceEngine  # noqa: E402
from .utils import state_dict_from_flax  # noqa: E402

__all__ = ["DeltaNetClassification", "DeltaNetSegmentation",
           "InferenceEngine", "KERNEL_OPS", "PLAIN_OPS", "__version__",
           "launch_counts", "reset_launch_counts", "state_dict_from_flax",
           "version_info"]
