"""Inference engine: pad -> batch -> predict (counterpart of
``deltaconv_tpu/serving.py``, precisions None, float32, bfloat16 and
int8).

Requests are clouds of any size up to ``num_points``. Each is padded to
``num_points`` (zero positions, unit-z normals, a point mask), clouds
are stacked into batches of ``batch_size`` (a partial batch is filled by
replicating its first cloud, and its category, and the filler outputs
dropped), and each batch runs one forward pass on the engine's device.
When every cloud has exactly ``num_points`` points the mask is dropped
(the uniform path).

The JAX package's production serving config, on the card::

    model = DeltaNetClassification(num_classes=40, knn_method="approx")
    model.load_state_dict(state_dict_from_flax(params, batch_stats))
    engine = InferenceEngine(model, num_points=1024, precision="bfloat16")
    logits = engine.predict(clouds, normals)   # [M, 40] f32

and ShapeNet part segmentation, per-point logits trimmed per cloud::

    model = DeltaNetSegmentation(num_classes=50, categorical_vector=True,
                                 num_neighbors=30, knn_method="approx")
    model.load_state_dict(state_dict_from_flax(params, batch_stats,
                                               head="segmentation"))
    engine = InferenceEngine(model, num_points=2048, batch_size=16,
                             precision="bfloat16")
    parts = engine.predict(clouds, normals, categories=[3, 0, 15])
    # a list of [N_i, 50] f32

Large clouds (the JAX package's coefficient-operator mode) serve from a
model built with ``dense_operators=False``, at any precision but int8::

    model = DeltaNetClassification(num_classes=40, dense_operators=False,
                                   knn_method="approx")
    engine = InferenceEngine(model, num_points=8192, batch_size=4,
                             precision="bfloat16")

``precision="int8"`` serves either model in the JAX package's int8 mode
(bf16 compute, int8 operators quantized per cloud, the neighbour maxes in
the quantized domain): an accuracy-changing form, held to 0.05 x
max|logit| of the f32 engine.

ONE cloud too large for a batch serves point-sharded
(:meth:`InferenceEngine.predict_sharded`, ``bench.py --mode=point-shard``:
65,536 points on one card), from a model with ``dense_operators=False``::

    model = DeltaNetClassification(num_classes=40, dense_operators=False,
                                   knn_method="approx")
    engine = InferenceEngine(model, num_points=65536, batch_size=1,
                             precision="bfloat16")
    logits = engine.predict_sharded(cloud, normal)   # [40] f32

Clouds without normals (ScanObjectNN's real scans) serve with
``normals=None`` on every entry point: the model estimates each point's
frame from its 10 nearest neighbours (``geometry.estimate_basis``).
:meth:`InferenceEngine.predict_voting` is the reference's voting
protocol: the logits of ``num_votes`` randomly augmented passes, summed::

    model = DeltaNetClassification(num_classes=15,
                                   conv_channels=(64, 64, 64, 128),
                                   grad_regularizer=0.01)
    engine = InferenceEngine(model, num_points=1024)
    logits = engine.predict_voting(clouds, num_votes=10, seed=0)  # [M, 15]

A trained run serves from its checkpoint (a checkpoint root, its latest
step; a ``step_<N>`` directory; or a release ``.pt``), after a warm-up
that builds and loads the kernels and runs one forward of each variant,
so the first request pays no build::

    engine = InferenceEngine.from_checkpoint(
        DeltaNetClassification(num_classes=15,
                               conv_channels=(64, 64, 64, 128)),
        "experiments/runs/scanobjectnn/<time>/checkpoints",
        num_points=1024)
    engine.warmup(has_normal=False)
    logits = engine.predict(clouds)
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from .models.deltanet_segmentation import NUM_CATEGORIES
from .ops import KERNEL_OPS, Ops, library
from .parallel import (all_gather, pad_cloud, point_sharded_classification,
                       point_sharded_segmentation, rank_and_size, shard_rows)
from .training.checkpoint import checkpoint_file, load_state_dict_file
from .transforms.augment import augment_classification
from .utils.device import resolve_device

__all__ = ["InferenceEngine", "apply_precision", "load_variables"]

# Unit-z padding normal keeps build_tangent_basis well-defined on padded
# rows (they are masked out of every statistic downstream).
_PAD_NORMAL = np.asarray([0.0, 0.0, 1.0], np.float32)

# Serving precision -> (compute_dtype, operator_dtype).
_PRECISIONS = {"float32": (None, None), "bfloat16": ("bfloat16", "bfloat16"),
               "int8": ("bfloat16", "int8")}


def load_variables(path: str, device="cpu"):
    """The model ``state_dict`` (parameters and running statistics) of a
    checkpoint root (its latest step), a ``step_<N>`` directory, or a
    release ``.pt``/``.pth`` in any of its four forms
    (:func:`~.training.checkpoint.load_state_dict_file`). No model or
    train state is needed to read it."""
    if not path.endswith((".pt", ".pth")):
        path = checkpoint_file(path)
    return load_state_dict_file(path, device)


def _encode_category(c):
    """An int category id -> the 16-wide one-hot (ShapeNet convention;
    ids outside 0..15 are refused); an array-like passes through."""
    if np.ndim(c) == 0:
        cid = int(c)
        if not 0 <= cid < NUM_CATEGORIES:
            raise ValueError(
                f"category id {cid} outside the {NUM_CATEGORIES}-category "
                "convention; pass a pre-encoded vector instead")
        return np.eye(NUM_CATEGORIES, dtype=np.float32)[cid]
    return np.asarray(c, np.float32)


def apply_precision(model, precision: Optional[str]):
    """A copy of ``model`` in a serving precision (the caller's model is
    never changed, as the JAX engine clones it): ``None`` keeps the
    dtypes as built, ``"float32"`` strips both, ``"bfloat16"`` sets
    ``compute_dtype`` and ``operator_dtype`` to bf16, ``"int8"`` sets
    ``compute_dtype`` to bf16 and ``operator_dtype`` to int8 (a model with
    ``dense_operators=False`` refuses int8)."""
    if precision is not None and precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected None | "
                         "float32 | bfloat16 | int8")
    if precision == "int8" and not model.dense_operators:
        # Only the dense form has a quantized operator dtype: a silent
        # no-op would leave the caller believing int8 serving is active.
        raise ValueError(
            "precision='int8' requires dense_operators=True (the "
            "coefficient-operator path has no quantized form)")
    model = copy.deepcopy(model)
    if precision is not None:
        compute, operator = _PRECISIONS[precision]
        model.set_precision(compute_dtype=compute, operator_dtype=operator)
    return model


class InferenceEngine:
    """Batched fixed-shape serving wrapper around a DeltaNet model.

    Args:
      model: a :class:`~.models.DeltaNetClassification` or
        :class:`~.models.DeltaNetSegmentation`; the engine serves a copy
        of it (:func:`apply_precision`), on ``device``.
      num_points: point count every request is padded to; larger clouds
        are rejected (subsample upstream).
      batch_size: clouds per forward pass.
      precision: ``None`` (as built), ``"float32"``, ``"bfloat16"`` or
        ``"int8"`` (:func:`apply_precision`).
      ops: the kernels (default) or their plain versions.
      device: where to serve, the card by default; without a card this
        raises unless the caller asks for ``"cpu"``.
    """

    def __init__(self, model, *, num_points: int, batch_size: int = 32,
                 precision: Optional[str] = None, ops: Ops = KERNEL_OPS,
                 device="cuda"):
        self.device = resolve_device(device)
        # Strict f32 matmuls on the card: TF32 would reorder near-tied kNN
        # neighbours and move the logits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = apply_precision(model, precision).to(self.device).eval()
        self.num_points = int(num_points)
        self.batch_size = int(batch_size)
        self.ops = ops

    @classmethod
    def from_checkpoint(cls, model, path: str, *, num_points: int,
                        batch_size: int = 32,
                        precision: Optional[str] = None,
                        ops: Ops = KERNEL_OPS, device="cuda"):
        """An engine serving ``model``'s architecture with the weights at
        ``path`` (:func:`load_variables`; ``strict`` keys); the caller's
        model is left as it was."""
        engine = cls(model, num_points=num_points, batch_size=batch_size,
                     precision=precision, ops=ops, device=device)
        engine.model.load_state_dict(load_variables(path, engine.device),
                                     strict=True)
        return engine

    def warmup(self, masked: Optional[bool] = None, has_normal: bool = True,
               has_category: bool = False):
        """Builds and loads the kernels (on the card, with the kernel
        ops) and runs one forward of each variant outside the serving
        path, so the first :meth:`predict` pays neither the build nor a
        first launch. ``masked=None`` runs both the uniform (every cloud
        exactly ``num_points``) and the ragged (point mask, exact kNN)
        forward, which ``predict`` picks between per request;
        ``has_normal=False`` the forward that estimates the frames;
        ``has_category=True`` a segmentation model's categorical
        forward."""
        if self.device.type == "cuda" and self.ops is KERNEL_OPS:
            library()
        b, n = self.batch_size, self.num_points
        pos = torch.zeros((b, n, 3), device=self.device)
        pos[:, :, 2] = torch.linspace(0.0, 1.0, n, device=self.device)
        normal = (torch.from_numpy(_PAD_NORMAL).to(self.device).expand(
            b, n, 3).contiguous() if has_normal else None)
        mask = torch.ones((b, n), dtype=torch.bool, device=self.device)
        kwargs = {}
        if has_category:
            kwargs["category"] = torch.from_numpy(
                _encode_category(0)).to(self.device).expand(b, -1)
        with torch.inference_mode():
            for m in ((False, True) if masked is None else (masked,)):
                self.model(pos, normal, mask if m else None, ops=self.ops,
                           **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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

    def _assemble(self, clouds, normals, categories):
        """Pads and stacks all clouds into device batches
        ``(pos, normal, mask, category, keep)``; ``keep`` counts
        non-filler rows. Also returns every cloud's size."""
        has_normal = normals is not None
        padded = [self._pad_one(c, normals[i] if has_normal else None)
                  for i, c in enumerate(clouds)]
        sizes = [p[3] for p in padded]
        masked = any(s != self.num_points for s in sizes)

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
            cat = None
            if categories is not None:
                cats = list(categories[start:start + self.batch_size])
                cat = upload([_encode_category(c)
                              for c in cats + [cats[0]] * fill])
            batches.append((pos, normal, mask, cat, self.batch_size - fill))
        return batches, sizes

    def predict(self, clouds: Sequence, normals: Optional[Sequence] = None,
                categories: Optional[Sequence] = None):
        """Runs the model on ``clouds`` (sequence of ``[N_i, 3]`` arrays,
        ragged ``N_i`` allowed) with matching ``normals`` (all or none:
        without them the model estimates every cloud's frames).
        ``categories``: one object category a cloud, for a segmentation
        model with ``categorical_vector=True``: int ids are one-hot
        encoded to the ShapeNet-convention 16 (ids outside 0..15 are
        refused), vectors pass through. Returns, for classification,
        ``[M, num_classes]`` float32 logits; for segmentation, a list of
        ``[N_i, num_classes]`` float32 per-point logits, each trimmed to
        its cloud; an empty list for no clouds."""
        if len(clouds) == 0:
            return []
        if categories is not None and len(categories) != len(clouds):
            raise ValueError(f"{len(categories)} categories for "
                             f"{len(clouds)} clouds; give one a cloud")
        batches, sizes = self._assemble(clouds, normals, categories)
        with torch.inference_mode():
            logits = self._run(batches)
        return self._output(logits, sizes)

    def predict_voting(self, clouds: Sequence,
                       normals: Optional[Sequence] = None,
                       categories: Optional[Sequence] = None,
                       num_votes: int = 10, augment=None, seed: int = 0):
        """The reference voting protocol (test_shapenet.py:79-96):
        ``num_votes`` randomly augmented forward passes, their logits
        summed in f32. ``augment``: ``(generator, pos, normal) -> (pos,
        normal)`` on the padded ``[B, N, 3]`` batches (``normal`` None for
        clouds without normals; a returned None keeps the batch's), by
        default :func:`~.transforms.augment.augment_classification`
        (RandomScale 4/5..5/4, then RandomTranslateGlobal 0.1). The clouds
        are padded, stacked and uploaded once; every (vote, batch) draws
        from one ``torch.Generator`` on the engine's device seeded with
        ``seed``. Returns what :meth:`predict` returns."""
        if num_votes < 1:
            raise ValueError(f"num_votes must be >= 1, got {num_votes}")
        if len(clouds) == 0:
            return []
        if categories is not None and len(categories) != len(clouds):
            raise ValueError(f"{len(categories)} categories for "
                             f"{len(clouds)} clouds; give one a cloud")
        augment = augment_classification if augment is None else augment
        batches, sizes = self._assemble(clouds, normals, categories)
        generator = torch.Generator(device=self.device).manual_seed(seed)

        def augmented(pos, normal):
            p, n = augment(generator, pos, normal)
            return p, normal if n is None else n

        total = None
        with torch.inference_mode():
            for _ in range(num_votes):
                logits = self._run(batches, augmented)
                total = logits if total is None else total + logits
        return self._output(total, sizes)

    def _run(self, batches, augmented=None):
        """The f32 logits of every batch, filler rows dropped, on the
        engine's device; ``augmented(pos, normal)`` first, if given."""
        outs = []
        for pos, normal, mask, cat, keep in batches:
            if augmented is not None:
                pos, normal = augmented(pos, normal)
            kwargs = {} if cat is None else {"category": cat}
            logits = self.model(pos, normal, mask, ops=self.ops, **kwargs)
            outs.append(logits[:keep].float())
        return torch.cat(outs, dim=0)

    @staticmethod
    def _output(logits, sizes):
        """Host logits: ``[M, classes]``, or a list of each cloud's trimmed
        ``[N_i, classes]`` (segmentation)."""
        logits = logits.cpu().numpy()
        if logits.ndim == 3:  # segmentation: trim the padding per cloud
            return [logits[i, :n] for i, n in enumerate(sizes)]
        return logits

    def predict_sharded(self, cloud, normal=None, category=None,
                        group=None):
        """Serves ONE cloud ``[N, 3]`` (with ``normal [N, 3]``) spread over
        the ranks of ``group`` (``parallel.point_sharding``; None: this
        process alone); without ``normal`` the frames are estimated. Every rank passes the whole cloud: it is padded to
        a multiple of the group's size (a point mask hides the padding),
        each rank builds the operators of its row block and runs the conv
        stack on it, and the gathers and pools complete with collectives.
        ``num_points`` and ``batch_size`` do not apply. ``category``: the
        cloud's object category, for a segmentation model with
        ``categorical_vector=True``. Returns ``[num_classes]`` f32 logits
        (classification) or the per-point ``[N, num_classes]``
        (segmentation), the same on every rank. int8 has no point-sharded
        form (its operators are dense)."""
        if self.model.operator_dtype == torch.int8:
            raise ValueError(
                "predict_sharded has no int8 form (the point-sharded path "
                "uses coefficient operators); serve sharded at "
                "precision=None/float32/bfloat16")
        _, size = rank_and_size(group)
        pos = torch.as_tensor(np.asarray(cloud, np.float32))
        n = pos.shape[0]
        nrm = (None if normal is None
               else torch.as_tensor(np.asarray(normal, np.float32)))
        pos, nrm, pm = pad_cloud(pos, size, nrm)

        def local(t):
            return None if t is None else shard_rows(t, group).to(
                self.device)

        pos, nrm, pm = local(pos), local(nrm), local(pm)
        with torch.inference_mode():
            if hasattr(self.model, "segmentation_head"):
                cat = (None if category is None else torch.from_numpy(
                    _encode_category(category)).to(self.device))
                out = all_gather(point_sharded_segmentation(
                    self.model, pos, nrm, pm, cat, group, self.ops), group)
                return out[:n].float().cpu().numpy()
            out = point_sharded_classification(self.model, pos, nrm, pm,
                                               group, self.ops)
        return out.float().cpu().numpy()
