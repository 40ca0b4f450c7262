"""Host-side data transforms over
:class:`~deltaconv_tpu_torch.data.cloud.Cloud` (a copy of
``deltaconv_tpu/transforms/transforms.py``).

Functional equivalents of the upstream DeltaConv transform set (see
SURVEY.md §2.5), with two deliberate deltas:

* every random transform draws from an explicit seedable
  ``np.random.Generator`` (the reference uses global torch/python RNG);
* these run in the one-time preprocessing path. Per-step augmentations
  should prefer the on-device batched versions in
  ``deltaconv_tpu_torch.transforms.augment``, which run on the batch's
  device.
"""

from __future__ import annotations

import math
import numbers
from typing import Optional, Sequence

import numpy as np

from ..data.cloud import Cloud

__all__ = [
    "Compose",
    "NormalizeScale",
    "NormalizeArea",
    "NormalizeAxes",
    "RandomScale",
    "RandomRotate",
    "RandomTranslateGlobal",
    "RandomNormals",
    "SamplePoints",
]

_EPS = 1e-12


class Transform:
    """Base: a callable ``Cloud -> Cloud``; random transforms accept an
    optional generator (falling back to an internal default)."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)

    def rng(self, rng: Optional[np.random.Generator]) -> np.random.Generator:
        return rng if rng is not None else self._rng

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class Compose(Transform):
    """Applies transforms in sequence (PyG ``T.Compose`` analog)."""

    def __init__(self, transforms: Sequence):
        super().__init__()
        self.transforms = list(transforms)

    def __call__(self, cloud: Cloud, rng=None) -> Cloud:
        for t in self.transforms:
            cloud = t(cloud, rng) if _takes_rng(t) else t(cloud)
        return cloud

    def __repr__(self):
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"Compose([{inner}])"


def _takes_rng(t) -> bool:
    return isinstance(t, Transform) and not isinstance(t, Compose)


class NormalizeScale(Transform):
    """Center the bbox midpoint; scale the max point norm to ~1
    (x 0.999999). Reference normalize_scale.py:5-24; ``norm_ord`` and a
    fixed ``scaling_factor`` are supported."""

    def __init__(self, norm_ord=2, scaling_factor=None):
        super().__init__()
        self.norm_ord = norm_ord
        self.scaling_factor = scaling_factor

    def __call__(self, cloud: Cloud, rng=None) -> Cloud:
        pos = cloud.pos
        pos = pos - (pos.max(axis=0) + pos.min(axis=0)) / 2.0
        if self.scaling_factor is None:
            denom = np.linalg.norm(pos, ord=self.norm_ord, axis=1).max()
        else:
            denom = self.scaling_factor
        pos = pos * ((1.0 / max(denom, _EPS)) * 0.999999)
        return cloud.replace(pos=pos.astype(np.float32))


class NormalizeArea(Transform):
    """Center; scale so total mesh surface area is 1 (needs ``face``).
    Reference normalize_area.py:5-23."""

    def __call__(self, cloud: Cloud, rng=None) -> Cloud:
        if cloud.face is None:
            raise ValueError("NormalizeArea requires cloud.face")
        pos = cloud.pos - (cloud.pos.max(0) + cloud.pos.min(0)) / 2.0
        f = cloud.face
        e1 = pos[f[1]] - pos[f[0]]
        e2 = pos[f[2]] - pos[f[0]]
        total_area = np.linalg.norm(np.cross(e1, e2), axis=-1).sum() / 2.0
        pos = pos / math.sqrt(max(total_area, _EPS))
        return cloud.replace(pos=pos.astype(np.float32))


class NormalizeAxes(Transform):
    """Permute axes by ascending std; scale by 1/(2 * max z).
    Reference normalize_axes.py:4-29."""

    def __init__(self, max_points: int = -1):
        super().__init__()
        self.max_points = max_points

    def __call__(self, cloud: Cloud, rng=None) -> Cloud:
        std = cloud.pos.std(axis=0)
        order = np.argsort(std, kind="stable")
        pos = cloud.pos[:, order]
        pos = pos * (1.0 / max(2.0 * pos[:, 2].max(), _EPS))
        return cloud.replace(pos=pos.astype(np.float32))


class RandomScale(Transform):
    """Anisotropic per-axis scale in [a, b]; normals transformed by the
    inverse scale and renormalized (the correct normal transform).
    Reference random_scale.py:5-37."""

    def __init__(self, scales, seed: Optional[int] = None):
        super().__init__(seed)
        assert len(scales) == 2
        self.scales = tuple(scales)

    def __call__(self, cloud: Cloud, rng=None) -> Cloud:
        g = self.rng(rng)
        scale = g.uniform(*self.scales, size=3).astype(np.float32)
        out = cloud.replace(pos=(cloud.pos * scale).astype(np.float32))
        if cloud.normal is not None:
            n = cloud.normal / scale
            n = n / np.maximum(
                np.linalg.norm(n, axis=1, keepdims=True), _EPS
            )
            out = out.replace(normal=n.astype(np.float32))
        return out


def _axis_rotation(degree_rad: float, axis: int, dim: int) -> np.ndarray:
    s, c = math.sin(degree_rad), math.cos(degree_rad)
    if dim == 2:
        return np.array([[c, s], [-s, c]], np.float32)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, s], [0, -s, c]], np.float32)
    if axis == 1:
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)


class RandomRotate(Transform):
    """Rotation about one axis by a uniform angle in ``degrees``;
    rotates normals too. Reference random_rotate.py:8-51."""

    def __init__(self, degrees, axis: int = 0, seed: Optional[int] = None):
        super().__init__(seed)
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        assert len(degrees) == 2
        self.degrees = tuple(degrees)
        self.axis = axis

    def __call__(self, cloud: Cloud, rng=None) -> Cloud:
        g = self.rng(rng)
        degree = math.pi * g.uniform(*self.degrees) / 180.0
        R = _axis_rotation(degree, self.axis, cloud.pos.shape[-1])
        out = cloud.replace(pos=(cloud.pos @ R).astype(np.float32))
        if cloud.normal is not None:
            out = out.replace(normal=(cloud.normal @ R).astype(np.float32))
        return out


class RandomTranslateGlobal(Transform):
    """One global offset per shape (vs PyG's per-point jitter).
    Reference random_translate_global.py:7-37."""

    def __init__(self, translate, seed: Optional[int] = None):
        super().__init__(seed)
        self.translate = translate

    def __call__(self, cloud: Cloud, rng=None) -> Cloud:
        g = self.rng(rng)
        dim = cloud.pos.shape[-1]
        t = self.translate
        if isinstance(t, numbers.Number):
            t = [t] * dim
        offset = np.array(
            [g.uniform(-abs(td), abs(td)) for td in t], np.float32
        )
        return cloud.replace(pos=(cloud.pos + offset).astype(np.float32))


class RandomNormals(Transform):
    """Jitter normals by per-point offsets and renormalize (noise-
    robustness augmentation). Reference random_normals.py:8-38."""

    def __init__(self, translate, seed: Optional[int] = None):
        super().__init__(seed)
        self.translate = translate

    def __call__(self, cloud: Cloud, rng=None) -> Cloud:
        if cloud.normal is None:
            raise ValueError("RandomNormals requires cloud.normal")
        g = self.rng(rng)
        n_pts, dim = cloud.pos.shape
        t = self.translate
        if isinstance(t, numbers.Number):
            t = [t] * dim
        jitter = np.stack(
            [g.uniform(-abs(td), abs(td), size=n_pts) for td in t], axis=-1
        ).astype(np.float32)
        n = cloud.normal + jitter
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-5)
        return cloud.replace(normal=n.astype(np.float32))


class SamplePoints(Transform):
    """Area-weighted barycentric sampling of points on mesh faces, with
    optional per-face normals and per-point label propagation
    ``y = y[face[0]]`` (the label support is why the reference forks
    PyG's version, sample_points.py:53-54)."""

    def __init__(self, num: int, remove_faces: bool = True,
                 include_normals: bool = False, include_labels: bool = False,
                 seed: Optional[int] = None):
        super().__init__(seed)
        self.num = num
        self.remove_faces = remove_faces
        self.include_normals = include_normals
        self.include_labels = include_labels

    def __call__(self, cloud: Cloud, rng=None) -> Cloud:
        if cloud.face is None:
            raise ValueError("SamplePoints requires cloud.face")
        g = self.rng(rng)
        pos, face = cloud.pos.astype(np.float64), cloud.face

        pos_max = np.abs(pos).max()
        pos = pos / max(pos_max, _EPS)

        e1 = pos[face[1]] - pos[face[0]]
        e2 = pos[face[2]] - pos[face[0]]
        area = np.abs(np.linalg.norm(np.cross(e1, e2), axis=1)) / 2.0
        prob = area / max(area.sum(), _EPS)

        sample = g.choice(face.shape[1], size=self.num, replace=True, p=prob)
        face_s = face[:, sample]

        frac = g.random((self.num, 2))
        flip = frac.sum(axis=-1) > 1
        frac[flip] = 1 - frac[flip]

        v1 = pos[face_s[1]] - pos[face_s[0]]
        v2 = pos[face_s[2]] - pos[face_s[0]]

        out = cloud
        if self.include_normals:
            n = np.cross(v1, v2)
            n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True),
                               _EPS)
            out = out.replace(normal=n.astype(np.float32))

        sampled = pos[face_s[0]] + frac[:, :1] * v1 + frac[:, 1:] * v2
        out = out.replace(pos=(sampled * pos_max).astype(np.float32))

        if self.include_labels:
            out = out.replace(y=np.asarray(cloud.y)[face_s[0]])
        if self.remove_faces:
            out = out.replace(face=None)
        return out
