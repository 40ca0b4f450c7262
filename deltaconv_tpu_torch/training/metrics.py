"""Evaluation metrics (a copy of ``deltaconv_tpu/training/metrics.py``).

Replacements for the upstream sklearn ``accuracy_score`` /
``balanced_accuracy_score`` calls (train_modelnet.py:76-78) and its
ShapeNet mIoU routine (experiments/utils.py:27-51), implemented in numpy so evaluation loops stay host-side and dependency-
free.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "accuracy",
    "balanced_accuracy",
    "shape_iou",
    "SHAPENET_SEG_NUM",
    "SHAPENET_INDEX_START",
]

# ShapeNet part-segmentation category layout: number of parts and the
# global part-index offset per object category (reference utils.py:29-30).
SHAPENET_SEG_NUM = [4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3]
SHAPENET_INDEX_START = [0, 4, 6, 8, 12, 16, 19, 22, 24, 28, 30, 36, 38, 41,
                        44, 47]


def accuracy(pred, true):
    """Overall accuracy of integer predictions."""
    pred = np.asarray(pred).reshape(-1)
    true = np.asarray(true).reshape(-1)
    return float(np.mean(pred == true))


def balanced_accuracy(pred, true):
    """Mean per-class recall (sklearn's balanced_accuracy_score)."""
    pred = np.asarray(pred).reshape(-1)
    true = np.asarray(true).reshape(-1)
    recalls = []
    for c in np.unique(true):
        m = true == c
        recalls.append(np.mean(pred[m] == c))
    return float(np.mean(recalls))


def shape_iou(pred, seg, label, class_choice=None):
    """Per-shape mean part IoU for ShapeNet part segmentation.

    Args:
      pred: ``[B, N]`` predicted part labels.
      seg: ``[B, N]`` ground-truth part labels.
      label: ``[B]`` object category index per shape.
      class_choice: optional category name; when given, parts are taken
        as the first ``SHAPENET_SEG_NUM[label[0]]`` indices (matching
        the reference's single-class mode, utils.py:39-40).

    Returns:
      list of per-shape IoUs. Parts absent from both prediction and
      ground truth count as IoU 1 (reference utils.py:45-46).
    """
    pred = np.asarray(pred)
    seg = np.asarray(seg)
    label = np.asarray(label).reshape(-1)

    ious = []
    for i in range(seg.shape[0]):
        if not class_choice:
            start = SHAPENET_INDEX_START[label[i]]
            parts = range(start, start + SHAPENET_SEG_NUM[label[i]])
        else:
            parts = range(SHAPENET_SEG_NUM[label[0]])
        part_ious = []
        for part in parts:
            inter = np.sum((pred[i] == part) & (seg[i] == part))
            union = np.sum((pred[i] == part) | (seg[i] == part))
            part_ious.append(1.0 if union == 0 else inter / float(union))
        ious.append(float(np.mean(part_ious)))
    return ious
