"""Datasets and input pipeline of the port (counterpart of
``deltaconv_tpu/data``): the Cloud container, the dataset base class and
fixed-shape batch loader, the synthetic generators, the mesh and array
readers (``io``) and the five loaders (ModelNet, ScanObjectNN, ShapeNet,
ShapeSeg, SHREC)."""

from .cloud import Cloud
from .dataset import BatchLoader, CloudDataset
from .modelnet import ModelNet
from .scanobjectnn import ScanObjectNN
from .shapenet import ShapeNet
from .shapeseg import ShapeSeg
from .shrec import SHREC
from .synthetic import (synthetic_classification_batch, synthetic_seg_shapes,
                        synthetic_segmentation_batch, synthetic_shapes)

__all__ = ["BatchLoader", "Cloud", "CloudDataset", "ModelNet", "SHREC",
           "ScanObjectNN", "ShapeNet", "ShapeSeg",
           "synthetic_classification_batch", "synthetic_seg_shapes",
           "synthetic_segmentation_batch", "synthetic_shapes"]
