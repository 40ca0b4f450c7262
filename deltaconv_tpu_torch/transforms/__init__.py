"""Data transforms of the port (counterpart of
``deltaconv_tpu/transforms``): host-side Cloud transforms (numpy), the
geodesic FPS pre-transform, and batched augmentations on the batch's
device."""

from .augment import (augment_classification, random_normals, random_rotate,
                      random_scale, random_translate_global)
from .geodesic_fps import GeodesicFPS
from .transforms import (Compose, NormalizeArea, NormalizeAxes,
                         NormalizeScale, RandomNormals, RandomRotate,
                         RandomScale, RandomTranslateGlobal, SamplePoints)

__all__ = ["Compose", "GeodesicFPS", "NormalizeArea", "NormalizeAxes",
           "NormalizeScale", "RandomNormals", "RandomRotate", "RandomScale",
           "RandomTranslateGlobal", "SamplePoints", "augment_classification",
           "random_normals", "random_rotate", "random_scale",
           "random_translate_global"]
