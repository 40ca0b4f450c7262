"""Inference engine: pad -> batch -> predict (counterpart of
``deltaconv_tpu/serving.py``, f32).

Requests are clouds of any size up to ``num_points``. Each is padded to
``num_points`` (zero positions, unit-z normals, a point mask), clouds
are stacked into batches of ``batch_size`` (a partial batch is filled by
replicating its first cloud and the filler outputs dropped), and each
batch runs one forward pass on the model's device. When every cloud has
exactly ``num_points`` points the mask is dropped (the uniform path).

Typical use::

    model = DeltaNetClassification(num_classes=40).to("cuda")
    model.load_state_dict(state_dict_from_flax(params, batch_stats))
    engine = InferenceEngine(model, num_points=1024)
    logits = engine.predict(clouds, normals)   # [M, 40]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .ops import KERNEL_OPS, Ops

__all__ = ["InferenceEngine", "check_precision"]

# Unit-z padding normal keeps build_tangent_basis well-defined on padded
# rows (they are masked out of every statistic downstream).
_PAD_NORMAL = np.asarray([0.0, 0.0, 1.0], np.float32)


def check_precision(precision: Optional[str]) -> None:
    """Accepts the f32 serving modes; the reduced-precision ones are
    still to be ported."""
    if precision in (None, "float32"):
        return
    if precision in ("bfloat16", "int8"):
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet (ROADMAP: bf16 "
            "and int8 serving, with gather_max_affine, gather_matmul_max "
            "and the int8 kernels)")
    raise ValueError(f"unknown precision {precision!r}; expected None | "
                     "float32")


class InferenceEngine:
    """Batched fixed-shape serving wrapper around a DeltaNet model.

    Args:
      model: a :class:`~.models.DeltaNetClassification` on its device.
      num_points: point count every request is padded to; larger clouds
        are rejected (subsample upstream).
      batch_size: clouds per forward pass.
      precision: ``None`` (as built) or ``"float32"``.
      ops: the kernels (default) or their plain versions.
    """

    def __init__(self, model, *, num_points: int, batch_size: int = 32,
                 precision: Optional[str] = None, ops: Ops = KERNEL_OPS):
        check_precision(precision)
        # Strict f32 matmuls on the card: TF32 would reorder near-tied kNN
        # neighbours and move the logits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model.eval()
        self.num_points = int(num_points)
        self.batch_size = int(batch_size)
        self.ops = ops
        self.device = next(model.parameters()).device

    def _pad_one(self, pos, normal):
        pos = np.asarray(pos, np.float32)
        n = pos.shape[0]
        if n > self.num_points:
            raise ValueError(
                f"cloud has {n} > num_points={self.num_points} points; "
                "subsample upstream")
        pad = self.num_points - n
        if pad:
            pos = np.concatenate([pos, np.zeros((pad, 3), np.float32)])
        if normal is not None:
            normal = np.asarray(normal, np.float32)
            if normal.shape[:1] != (n,):
                raise ValueError(
                    f"normals have {normal.shape[0]} rows for a cloud of "
                    f"{n} points; they must match per cloud")
            if pad:
                normal = np.concatenate(
                    [normal, np.tile(_PAD_NORMAL, (pad, 1))])
        mask = np.arange(self.num_points) < n
        return pos, normal, mask, n

    def _assemble(self, clouds, normals):
        """Pads and stacks all clouds into device batches
        ``(pos, normal, mask, keep)``; ``keep`` counts non-filler rows."""
        has_normal = normals is not None
        padded = [self._pad_one(c, normals[i] if has_normal else None)
                  for i, c in enumerate(clouds)]
        masked = any(p[3] != self.num_points for p in padded)

        def upload(rows):
            return torch.from_numpy(np.stack(rows)).to(self.device)

        batches = []
        for start in range(0, len(padded), self.batch_size):
            chunk = padded[start:start + self.batch_size]
            fill = self.batch_size - len(chunk)
            chunk = chunk + [chunk[0]] * fill  # replicated filler rows
            pos = upload([c[0] for c in chunk])
            normal = upload([c[1] for c in chunk]) if has_normal else None
            mask = upload([c[2] for c in chunk]) if masked else None
            batches.append((pos, normal, mask, self.batch_size - fill))
        return batches

    def predict(self, clouds: Sequence, normals: Optional[Sequence] = None):
        """Runs the model on ``clouds`` (sequence of ``[N_i, 3]`` arrays,
        ragged ``N_i`` allowed) with matching ``normals``. Returns
        ``[M, num_classes]`` float32 logits (an empty list for no
        clouds)."""
        if len(clouds) == 0:
            return []
        outs = []
        with torch.inference_mode():
            for pos, normal, mask, keep in self._assemble(clouds, normals):
                logits = self.model(pos, normal, mask, ops=self.ops)
                outs.append(logits[:keep].float().cpu().numpy())
        return np.concatenate(outs, axis=0)
