"""Batched augmentations on the batch's device (counterpart of
``deltaconv_tpu/transforms/augment.py``).

Each ``random_*`` function draws one independent sample per cloud of a
``[B, N, 3]`` batch from an explicit ``torch.Generator`` (on the batch's
device) in place of JAX's key, then applies it. The draw and the
application are separate functions (``draw_*``, ``apply_*``), so that the
application can be held against the JAX package's on JAX's own draws.
"""

from __future__ import annotations

import math

import torch

__all__ = ["apply_normal_jitter", "apply_rotation", "apply_scale",
           "apply_translation", "augment_classification",
           "draw_normal_jitter", "draw_rotation", "draw_scale",
           "draw_translation", "random_normals", "random_rotate",
           "random_scale", "random_translate_global"]


def _uniform(generator, shape, lo, hi, like):
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=like.device)
    return lo + (hi - lo) * u


def draw_scale(generator, pos, scales=(2.0 / 3.0, 3.0 / 2.0)):
    """Per-cloud axis scales ``[B, 1, 3]`` uniform in ``scales``."""
    return _uniform(generator, (pos.shape[0], 1, 3), scales[0], scales[1],
                    pos)


def apply_scale(pos, normal, s):
    """Scales positions by ``s``; normals take the inverse scale and are
    renormalized (None stays None)."""
    pos = pos * s
    if normal is None:
        return pos, None
    n = normal / s
    return pos, n / torch.clamp(
        torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)


def random_scale(generator, pos, normal=None, scales=(2.0 / 3.0, 3.0 / 2.0)):
    """Per-cloud anisotropic scaling (the reference's RandomScale,
    batched)."""
    return apply_scale(pos, normal, draw_scale(generator, pos, scales))


def draw_rotation(generator, pos, degrees=180.0):
    """Per-cloud angles ``[B]`` in radians, uniform in +-``degrees``."""
    d = abs(degrees)
    return _uniform(generator, (pos.shape[0],), -d, d, pos) * (math.pi
                                                               / 180.0)


def _rotation_matrices(angle, axis: int):
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        rows = [[one, zero, zero], [zero, c, s], [zero, -s, c]]
    elif axis == 1:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    else:
        rows = [[c, s, zero], [-s, c, zero], [zero, zero, one]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _times(x, R):
    """``x [B, N, 3] @ R [B, 3, 3]`` as products summed in f32 (a matmul
    on the card could take TF32)."""
    return sum(x[..., d, None] * R[:, None, d, :] for d in range(3))


def apply_rotation(pos, normal, angle, axis: int = 0):
    """Rotates each cloud (and its normals) by its ``angle`` about
    ``axis``."""
    R = _rotation_matrices(angle.to(pos.dtype), axis)
    return _times(pos, R), None if normal is None else _times(normal, R)


def random_rotate(generator, pos, normal=None, degrees=180.0,
                  axis: int = 0):
    """Per-cloud rotation about one axis, uniform in +-``degrees``."""
    return apply_rotation(pos, normal, draw_rotation(generator, pos, degrees),
                          axis)


def draw_translation(generator, pos, translate=0.1):
    """Per-cloud offsets ``[B, 1, 3]`` uniform in +-``translate``."""
    t = abs(translate)
    return _uniform(generator, (pos.shape[0], 1, 3), -t, t, pos)


def apply_translation(pos, t):
    return pos + t


def random_translate_global(generator, pos, translate=0.1):
    """One global offset per cloud (keeps local structure)."""
    return apply_translation(pos, draw_translation(generator, pos,
                                                   translate))


def draw_normal_jitter(generator, normal, translate=0.1):
    """Per-point offsets shaped as ``normal``, uniform in +-``translate``."""
    t = abs(translate)
    return _uniform(generator, normal.shape, -t, t, normal)


def apply_normal_jitter(normal, jitter):
    n = normal + jitter
    return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                           min=1e-5)


def random_normals(generator, normal, translate=0.1):
    """Per-point normal jitter, renormalized."""
    return apply_normal_jitter(normal, draw_normal_jitter(generator, normal,
                                                          translate))


def augment_classification(generator, pos, normal=None,
                           scales=(4.0 / 5.0, 5.0 / 4.0),
                           translate: float = 0.1):
    """The reference ModelNet train-time augmentation
    (train_modelnet.py:38-39): RandomScale(4/5, 5/4) then
    RandomTranslateGlobal(0.1), batched on the batch's device; the
    default augmentation of :meth:`InferenceEngine.predict_voting`."""
    pos, normal = random_scale(generator, pos, normal, scales)
    return random_translate_global(generator, pos, translate), normal
