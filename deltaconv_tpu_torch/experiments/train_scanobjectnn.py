"""ScanObjectNN real-scan classification with the port (counterpart of
the JAX package's ``experiments/train_scanobjectnn.py``).

Reference recipe (the reference release's
experiments/train_scanobjectnn.py): 15 classes, conv channels
[64, 64, 64, 128], default lambda 0.01, 1024 points, bg/nobg x 5
perturbation-variant files; train-time RandomRotate(360, axis=1) +
per-point jitter (0.01) + RandomScale(4/5, 5/4) +
RandomTranslateGlobal(0.1), on the batch's device. The clouds have no
normals: the model estimates the frames.

    python -m deltaconv_tpu_torch.experiments.train_scanobjectnn \\
        --data_root experiments/data/ScanObjectNN [--device cpu]
"""

from __future__ import annotations

import torch

from ..transforms import augment as aug
from .common import base_parser, finish_args, make_logger

__all__ = ["RECIPE", "apply_augment", "augment", "build_datasets",
           "build_model", "build_parser", "draw_augment", "main"]

# Reference recipe constants (train_scanobjectnn.py:72,80-81,112).
RECIPE = {
    "num_classes": 15,
    "conv_channels": (64, 64, 64, 128),
    "optimizer": "sgd",
    "lr_scale": 100,
    "weight_decay": 1e-4,
    "schedule": "cosine",
    "smoothing": 0.2,
    "aug_jitter": 0.01,
    "aug_scales": (4.0 / 5.0, 5.0 / 4.0),
    "aug_translate": 0.1,
}


def draw_augment(generator, batch):
    """The augmentation's draws, in the JAX CLI's order: per-cloud
    angles, per-point jitter, per-cloud scales, per-cloud offsets."""
    pos = batch["pos"]
    angle = aug.draw_rotation(generator, pos, 360.0)
    t = RECIPE["aug_jitter"]
    jitter = -t + 2.0 * t * torch.rand(pos.shape, generator=generator,
                                       dtype=pos.dtype, device=pos.device)
    return (angle, jitter, aug.draw_scale(generator, pos, RECIPE["aug_scales"]),
            aug.draw_translation(generator, pos, RECIPE["aug_translate"]))


def apply_augment(batch, draws):
    """Rotation about axis 1, the jitter (PyG RandomTranslate(0.01):
    independent per point), the scale, then the global offset."""
    angle, jitter, scale, shift = draws
    pos, normal = aug.apply_rotation(batch["pos"], batch.get("normal"),
                                     angle, axis=1)
    pos, normal = aug.apply_scale(pos + jitter, normal, scale)
    out = dict(batch)
    out["pos"] = aug.apply_translation(pos, shift)
    if normal is not None:
        out["normal"] = normal
    return out


def augment(generator, batch):
    """The recipe's train-time augmentation of a device batch."""
    return apply_augment(batch, draw_augment(generator, batch))


def build_parser():
    """CLI defaults per reference train_scanobjectnn.py:156-196."""
    parser = base_parser("DeltaNet ScanObjectNN classification (PyTorch)")
    parser.set_defaults(num_points=1024, grad_regularizer=0.01)
    parser.add_argument("--background", action="store_true",
                        help="Use the variant with backgrounds")
    parser.add_argument("--augmentation", type=str, default=None,
                        choices=[None, "PB_T25", "PB_T25_R", "PB_T50_R",
                                 "PB_T50_RS"],
                        help="Perturbation variant (default: None)")
    return parser


def build_datasets(args):
    """The train and test splits, each cloud geodesic-FPS-sampled to
    ``num_points`` once and cached under ``processed/``."""
    from ..data import ScanObjectNN
    from ..transforms import GeodesicFPS

    pre = GeodesicFPS(args.num_points, seed=args.seed)
    return tuple(ScanObjectNN(args.data_root, background=args.background,
                              augmentation=args.augmentation, split=split,
                              pre_transform=pre)
                 for split in ("train", "test"))


def build_model(args):
    """The recipe's classifier; its weights are drawn from ``args.seed``."""
    from ..models import DeltaNetClassification

    return DeltaNetClassification(
        num_classes=RECIPE["num_classes"],
        conv_channels=RECIPE["conv_channels"],
        num_neighbors=args.k,
        grad_regularizer=args.grad_regularizer,
        grad_kernel_width=args.grad_kernel,
        operator_dtype=args.operator_dtype,
        knn_method=args.knn_method,
        generator=torch.Generator().manual_seed(args.seed),
    )


def main(argv=None):
    """Trains (or, with ``--checkpoint``, evaluates) and prints the test
    accuracy; returns ``(state, scalars)``."""
    args = build_parser().parse_args(argv)
    args = finish_args(args, "scanobjectnn", "ScanObjectNN")

    from ..data import BatchLoader
    from ..training import (FitConfig, cosine_epoch_schedule,
                            create_train_state, evaluate_classification, fit,
                            restore_any, sgd_momentum)

    train_ds, test_ds = build_datasets(args)
    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                               seed=args.seed)
    test_loader = BatchLoader(test_ds, args.batch_size, shuffle=False,
                              drop_last=False)

    model = build_model(args)
    schedule = cosine_epoch_schedule(
        RECIPE["lr_scale"] * args.lr, args.epochs, len(train_loader),
        eta_min=args.lr)
    state = create_train_state(
        model, sgd_momentum(schedule, args.momentum,
                            weight_decay=RECIPE["weight_decay"]),
        device=args.device)

    logger, ckpt_dir = make_logger(args)
    if args.evaluating:
        state = restore_any(args.checkpoint, state)
    else:
        config = FitConfig(epochs=args.epochs, seed=args.seed,
                           smoothing=RECIPE["smoothing"],
                           data_parallel=not args.no_data_parallel)
        state = fit(model, state, train_loader, test_loader, config,
                    logger=logger, checkpoint_dir=ckpt_dir, augment=augment,
                    resume=bool(args.resume))
    logger.close()
    scalars = evaluate_classification(model, state, test_loader)
    print("Test accuracy: {test accuracy}".format(**scalars))
    return state, scalars


if __name__ == "__main__":
    main()
