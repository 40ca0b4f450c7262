"""Synthetic point-cloud generators for tests and benchmarks.

Deterministic, dataset-free stand-ins: deformed spheres whose
deformation harmonics depend on the class label, so a classifier has
real signal to learn (a copy of ``deltaconv_tpu/data/synthetic.py``).
The real dataset builders live alongside in ``deltaconv_tpu_torch/data``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_shapes", "synthetic_classification_batch",
           "synthetic_seg_shapes", "synthetic_segmentation_batch"]


def synthetic_shapes(rng, batch: int, num_points: int, num_classes: int = 4):
    """Class-conditioned deformed spheres.

    Returns ``(pos [B, N, 3] f32, normal [B, N, 3] f32 (approximate),
    label [B] i32)``.
    """
    labels = rng.integers(0, num_classes, size=batch).astype(np.int32)
    u = rng.normal(size=(batch, num_points, 3)).astype(np.float32)
    u /= np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-8)

    # Class-dependent radial harmonic: r = 1 + a * sin(f * z) with the
    # frequency set by the label.
    freq = (2.0 + labels.astype(np.float32))[:, None]
    r = 1.0 + 0.2 * np.sin(freq * u[..., 2] * np.pi)
    pos = u * r[..., None]

    # Approximate normals: radial direction (exact for the sphere,
    # close enough for tests; models may also estimate their own).
    normal = u
    return pos.astype(np.float32), normal.astype(np.float32), labels


def synthetic_seg_shapes(rng, batch: int, num_points: int,
                         num_parts: int = 4, num_categories: int = 4):
    """Per-point labelled deformed spheres (synthetic part
    segmentation).

    The shape geometry is category-conditioned (same harmonics as
    :func:`synthetic_shapes`); the part label of each point is its
    height band — the ``num_parts``-quantile of the z-coordinate RANK
    within the shape, so parts are exactly balanced and genuinely
    learnable from geometry (a segmentation head must combine local
    coordinates with global shape context to find the quantile
    boundaries).

    Returns ``(pos [B, N, 3], normal [B, N, 3], label [B, N] i32,
    category [B] i32)``.
    """
    pos, normal, cats = synthetic_shapes(rng, batch, num_points,
                                         num_categories)
    ranks = pos[..., 2].argsort(axis=-1).argsort(axis=-1)
    label = (ranks * num_parts // num_points).astype(np.int32)
    return pos, normal, label, cats


def synthetic_segmentation_batch(seed: int, batch: int, num_points: int,
                                 num_parts: int = 4,
                                 num_categories: int = 16):
    """A ready-to-feed batch dict for the segmentation models
    (per-point ``label`` plus a one-hot ``category``)."""
    rng = np.random.default_rng(seed)
    # Geometric variety stays at <=4 deformation harmonics (higher
    # frequencies alias at small N) even when the one-hot is wider.
    pos, normal, label, cats = synthetic_seg_shapes(
        rng, batch, num_points, num_parts, min(num_categories, 4))
    onehot = np.zeros((batch, num_categories), np.float32)
    onehot[np.arange(batch), cats] = 1.0
    return {"pos": pos, "normal": normal, "label": label,
            "category": onehot}


def synthetic_classification_batch(seed: int, batch: int, num_points: int,
                                   num_classes: int = 4, with_normals=True):
    """A ready-to-feed batch dict for the classification models."""
    rng = np.random.default_rng(seed)
    pos, normal, labels = synthetic_shapes(rng, batch, num_points,
                                           num_classes)
    out = {"pos": pos, "label": labels}
    if with_normals:
        out["normal"] = normal
    return out
