"""Human-body segmentation (ShapeSeg) with the port (counterpart of the
JAX package's ``experiments/train_shapeseg.py``).

Reference recipe (the reference release's experiments/train_shapeseg.py):
8 classes, conv channels [128] x 8, MLP depth 1, embedding 512, Adam +
StepLR(30, 0.1), 1024 points (NormalizeArea -> NormalizeAxes ->
SamplePoints(8x num_points, normals, labels) -> GeodesicFPS), a seeded
90/10 train/validation split with early stopping on the best validation
accuracy (the best state saved as step 0 of the run's checkpoints), NO
label smoothing; RandomScale(0.8, 1.2) + RandomRotate(360, z) +
RandomTranslateGlobal(0.1) at train time (on the batch's device).

    python -m deltaconv_tpu_torch.experiments.train_shapeseg [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..transforms import augment as aug
from .common import base_parser, finish_args, make_logger

__all__ = ["RECIPE", "apply_augment", "augment", "build_datasets",
           "build_model", "build_parser", "draw_augment", "main"]

# Reference recipe constants (train_shapeseg.py:68-83,118: NO label
# smoothing, calc_loss(..., smoothing=False)).
RECIPE = {
    "num_classes": 8,
    "conv_channels": (128,) * 8,
    "mlp_depth": 1,
    "embedding_size": 512,
    "optimizer": "adam",
    "schedule": "step_lr",
    "step_size": 30,
    "gamma": 0.1,
    "smoothing": 0.0,
    "aug_scales": (0.8, 1.2),
    "aug_translate": 0.1,
}


def draw_augment(generator, batch):
    """Per-cloud scales, angles about z, then offsets (the JAX CLI's
    order)."""
    pos = batch["pos"]
    return (aug.draw_scale(generator, pos, RECIPE["aug_scales"]),
            aug.draw_rotation(generator, pos, 360.0),
            aug.draw_translation(generator, pos, RECIPE["aug_translate"]))


def apply_augment(batch, draws):
    scale, angle, shift = draws
    pos, normal = aug.apply_scale(batch["pos"], batch.get("normal"), scale)
    pos, normal = aug.apply_rotation(pos, normal, angle, axis=2)
    out = dict(batch)
    out["pos"] = aug.apply_translation(pos, shift)
    if normal is not None:
        out["normal"] = normal
    return out


def augment(generator, batch):
    """RandomScale(0.8, 1.2), RandomRotate(360, z), then
    RandomTranslateGlobal(0.1)."""
    return apply_augment(batch, draw_augment(generator, batch))


class _Subset:
    """The clouds of ``dataset`` at ``indices``, in that order."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def build_parser():
    """CLI defaults per reference train_shapeseg.py:145-178."""
    parser = base_parser("DeltaNet ShapeSeg human segmentation (PyTorch)")
    parser.set_defaults(num_points=1024, epochs=50, lr=0.005, batch_size=8)
    return parser


def build_datasets(args):
    """``(train, validation, test)``: the train split cut 90/10 by a
    generator seeded with ``args.seed`` (reference :47-50), and the test
    split, each mesh sampled with its labels and geodesic-FPS-reduced to
    ``num_points`` once and cached."""
    from ..data import ShapeSeg
    from ..transforms import (Compose, GeodesicFPS, NormalizeArea,
                              NormalizeAxes, SamplePoints)

    pre = Compose([
        NormalizeArea(),
        NormalizeAxes(),
        SamplePoints(args.num_points * args.sampling_margin,
                     include_normals=True, include_labels=True,
                     seed=args.seed),
        GeodesicFPS(args.num_points, seed=args.seed),
    ])
    full_train = ShapeSeg(args.data_root, split="train", pre_transform=pre)
    test_ds = ShapeSeg(args.data_root, split="test", pre_transform=pre)
    order = np.random.default_rng(args.seed).permutation(len(full_train))
    n_train = int(len(full_train) * 0.9)
    return (_Subset(full_train, order[:n_train]),
            _Subset(full_train, order[n_train:]), test_ds)


def build_model(args):
    """The recipe's segmentation model (no categorical head); its weights
    are drawn from ``args.seed``."""
    from ..models import DeltaNetSegmentation

    return DeltaNetSegmentation(
        num_classes=RECIPE["num_classes"],
        conv_channels=RECIPE["conv_channels"],
        mlp_depth=RECIPE["mlp_depth"],
        embedding_size=RECIPE["embedding_size"],
        num_neighbors=args.k,
        grad_regularizer=args.grad_regularizer,
        grad_kernel_width=args.grad_kernel,
        operator_dtype=args.operator_dtype,
        knn_method=args.knn_method,
        generator=torch.Generator().manual_seed(args.seed),
    )


def main(argv=None):
    """Trains with early stopping on the validation accuracy and prints
    the test accuracy at the best validation epoch (or, with
    ``--checkpoint``, evaluates that checkpoint); returns ``(state,
    scalars)``: the final state, and the best epoch's validation and
    test accuracy (the test accuracy alone when evaluating)."""
    args = build_parser().parse_args(argv)
    args = finish_args(args, "shapeseg", "ShapeSeg")

    from .. import training
    from ..data import BatchLoader
    from ..training import (FitConfig, adam_steplr, create_train_state,
                            evaluate_segmentation, fit, restore_any)

    train_ds, val_ds, test_ds = build_datasets(args)
    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                               seed=args.seed)
    val_loader = BatchLoader(val_ds, args.batch_size, shuffle=False,
                             drop_last=False)
    test_loader = BatchLoader(test_ds, args.batch_size, shuffle=False,
                              drop_last=False)

    model = build_model(args)
    state = create_train_state(
        model, adam_steplr(args.lr, step_size=RECIPE["step_size"],
                           gamma=RECIPE["gamma"],
                           steps_per_epoch=len(train_loader)),
        device=args.device)

    logger, ckpt_dir = make_logger(args)
    if args.evaluating:
        state = restore_any(args.checkpoint, state)
        scalars = evaluate_segmentation(model, state, test_loader,
                                        with_iou=False)
        print("Test accuracy: {test accuracy}".format(**scalars))
        return state, scalars

    # Early stopping on the best validation accuracy (reference :98-101).
    best = {"validation accuracy": 0.0, "test accuracy": 0.0}

    def eval_fn(s):
        val = evaluate_segmentation(model, s, val_loader, with_iou=False)
        test = evaluate_segmentation(model, s, test_loader, with_iou=False)
        scalars = {"validation accuracy": val["test accuracy"],
                   "test accuracy": test["test accuracy"]}
        if scalars["validation accuracy"] > best["validation accuracy"]:
            best.update(scalars)
            if ckpt_dir:
                # The reference's best.pt: step 0 of the run's checkpoints.
                training.save_checkpoint(ckpt_dir, s, step=0)
        return scalars

    config = FitConfig(epochs=args.epochs, seed=args.seed,
                       smoothing=RECIPE["smoothing"],
                       data_parallel=not args.no_data_parallel)
    state = fit(model, state, train_loader, test_loader, config,
                logger=logger, checkpoint_dir=None, augment=augment,
                per_point=True, eval_fn=eval_fn)
    logger.close()
    print("Test accuracy: {}".format(best["test accuracy"]))
    return state, dict(best)


if __name__ == "__main__":
    main()
