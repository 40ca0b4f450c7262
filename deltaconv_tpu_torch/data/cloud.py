"""The host-side point-cloud container used by the data pipeline (a copy
of ``deltaconv_tpu/data/cloud.py``).

Equivalent of PyG's ``Data`` object for this framework's purposes
(reference transforms operate on ``data.pos/norm/face/x/y``): a plain
numpy dataclass — preprocessing is host work; batches of fixed-size
clouds are stacked into device arrays by the loaders.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

__all__ = ["Cloud"]


@dataclasses.dataclass
class Cloud:
    """One point cloud / mesh sample.

    Attributes:
      pos: ``[N, 3]`` float32 positions.
      normal: optional ``[N, 3]`` unit normals.
      face: optional ``[3, F]`` int64 triangle indices.
      x: optional ``[N, C]`` input features.
      y: label — scalar int for classification or ``[N]`` for
        segmentation.
      category: optional object-category index (ShapeNet).
      sample_idx: indices selected by FPS subsampling.
      pos_original / y_original: pre-subsampling copies when a
        transform is asked to keep them.
    """

    pos: np.ndarray
    normal: Optional[np.ndarray] = None
    face: Optional[np.ndarray] = None
    x: Optional[np.ndarray] = None
    y: Optional[Any] = None
    category: Optional[int] = None
    sample_idx: Optional[np.ndarray] = None
    pos_original: Optional[np.ndarray] = None
    y_original: Optional[Any] = None

    def replace(self, **kw) -> "Cloud":
        return dataclasses.replace(self, **kw)

    @property
    def num_points(self) -> int:
        return int(self.pos.shape[0])

    def per_point_labels(self) -> bool:
        return (
            self.y is not None
            and not np.isscalar(self.y)
            and np.ndim(self.y) >= 1
            and np.shape(self.y)[0] == self.num_points
        )
