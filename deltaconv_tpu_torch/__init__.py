"""deltaconv_tpu_torch: the DeltaConv serving paths (classification and
segmentation, f32, and bf16 with approximate kNN; one large cloud
point-sharded, ``InferenceEngine.predict_sharded``; voting,
``InferenceEngine.predict_voting``) and the train steps (f32 and bf16) in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).
Clouds with or without normals (the frames are then estimated), the
ScanObjectNN recipe's data pipeline (``data``, ``transforms``: its reader,
the loader, geodesic FPS, the augmentations) and its metrics.

A port of ``deltaconv_tpu`` (JAX, TPU), which stays the reference. This
package imports neither JAX nor ``deltaconv_tpu``. Its kernels
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

from .models import DeltaNetClassification, DeltaNetSegmentation
from .ops import KERNEL_OPS, PLAIN_OPS, launch_counts, reset_launch_counts
from .serving import InferenceEngine
from .utils import state_dict_from_flax

__all__ = ["DeltaNetClassification", "DeltaNetSegmentation",
           "InferenceEngine", "KERNEL_OPS", "PLAIN_OPS", "launch_counts",
           "reset_launch_counts", "state_dict_from_flax"]
