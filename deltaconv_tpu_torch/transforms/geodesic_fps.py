"""GeodesicFPS transform: subsample a cloud by geodesic FPS (a copy of
``deltaconv_tpu/transforms/geodesic_fps.py``, on the port's own C++
build).

The upstream transform's behaviour, including the tiling behavior when
the cloud has fewer points than requested (indices repeat) and optional
retention of the originals.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..data.cloud import Cloud
from ..geometry.fps import geodesic_fps
from .transforms import Transform

__all__ = ["GeodesicFPS"]


class GeodesicFPS(Transform):
    """Runs geodesic FPS, stores ``sample_idx``, subsamples
    pos/normal/x/y (per-point y only)."""

    def __init__(self, n_samples: Optional[int] = None,
                 store_original: bool = False, seed: Optional[int] = None):
        super().__init__(seed)
        self.n_samples = n_samples
        self.store_original = store_original
        self.seed = seed

    def __call__(self, cloud: Cloud, rng=None) -> Cloud:
        n = cloud.num_points
        n_samples = self.n_samples if self.n_samples is not None else n

        sub_seed = None
        if self.seed is not None or rng is not None:
            sub_seed = int(self.rng(rng).integers(0, 2**31 - 1))

        idx = geodesic_fps(cloud.pos, min(n_samples, n), seed=sub_seed)
        if n < n_samples:
            idx = np.tile(idx[:n], math.ceil(n_samples / n))
        idx = idx[:n_samples]
        assert idx.max() <= n and idx.min() >= 0

        out = cloud.replace(sample_idx=idx)
        if self.store_original:
            out = out.replace(pos_original=cloud.pos, y_original=cloud.y)

        out = out.replace(pos=cloud.pos[idx])
        if cloud.normal is not None:
            out = out.replace(normal=cloud.normal[idx])
        if cloud.x is not None:
            out = out.replace(x=cloud.x[idx])
        if cloud.per_point_labels():
            out = out.replace(y=np.asarray(cloud.y)[idx])
        return out
