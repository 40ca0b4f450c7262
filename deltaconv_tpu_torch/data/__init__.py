"""Datasets and input pipeline of the port (counterpart of
``deltaconv_tpu/data``): the Cloud container, the dataset base class and
fixed-shape batch loader, the synthetic generators and the ScanObjectNN
reader. The other loaders (ModelNet, ShapeNet, ShapeSeg, SHREC) and the
mesh readers are still to port (ROADMAP)."""

from .cloud import Cloud
from .dataset import BatchLoader, CloudDataset
from .scanobjectnn import ScanObjectNN
from .synthetic import (synthetic_classification_batch, synthetic_seg_shapes,
                        synthetic_segmentation_batch, synthetic_shapes)

__all__ = ["BatchLoader", "Cloud", "CloudDataset", "ScanObjectNN",
           "synthetic_classification_batch", "synthetic_seg_shapes",
           "synthetic_segmentation_batch", "synthetic_shapes"]
