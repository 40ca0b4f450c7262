"""SHREC-11 classification with the port (counterpart of the JAX
package's ``experiments/train_shrec.py``).

Reference recipe (the reference release's experiments/train_shrec.py):
30 classes, conv channels [32] x 4, 2048 points sampled from each mesh
(NormalizeScale -> SamplePoints(8x num_points, normals) ->
GeodesicFPS), random rotations about x, y and z through 360 degrees and
a global translate of 0.1 at train time (on the batch's device), label
smoothing 0.2, batch 16, 100 epochs, 10 training meshes a class drawn by
``--split_seed``.

    python -m deltaconv_tpu_torch.experiments.train_shrec \\
        [--split_seed 0] [--device cpu]
"""

from __future__ import annotations

import torch

from ..transforms import augment as aug
from .common import base_parser, finish_args, make_logger

__all__ = ["RECIPE", "apply_augment", "augment", "build_datasets",
           "build_model", "build_parser", "draw_augment", "main"]

# Reference recipe constants (train_shrec.py:62,70-71,102).
RECIPE = {
    "num_classes": 30,
    "conv_channels": (32, 32, 32, 32),
    "optimizer": "sgd",
    "lr_scale": 100,
    "weight_decay": 1e-4,
    "schedule": "cosine",
    "smoothing": 0.2,
    "aug_translate": 0.1,
}


def draw_augment(generator, batch):
    """Per-cloud angles about x, y and z, then per-cloud offsets (the JAX
    CLI's order)."""
    pos = batch["pos"]
    return (aug.draw_rotation(generator, pos, 360.0),
            aug.draw_rotation(generator, pos, 360.0),
            aug.draw_rotation(generator, pos, 360.0),
            aug.draw_translation(generator, pos, RECIPE["aug_translate"]))


def apply_augment(batch, draws):
    """The rotations about axes 0, 1 and 2 in turn, then the offset."""
    *angles, shift = draws
    pos, normal = batch["pos"], batch.get("normal")
    for axis, angle in enumerate(angles):
        pos, normal = aug.apply_rotation(pos, normal, angle, axis=axis)
    out = dict(batch)
    out["pos"] = aug.apply_translation(pos, shift)
    if normal is not None:
        out["normal"] = normal
    return out


def augment(generator, batch):
    """The recipe's train-time augmentation of a device batch."""
    return apply_augment(batch, draw_augment(generator, batch))


def build_parser():
    """CLI defaults per reference train_shrec.py:144-178."""
    parser = base_parser("DeltaNet SHREC classification (PyTorch)")
    parser.set_defaults(batch_size=16, epochs=100, num_points=2048)
    parser.add_argument("--split_seed", type=int, default=None,
                        help="Seed of the random 10-per-class split")
    return parser


def build_datasets(args):
    """The train and test splits (10 and the rest of the meshes of each
    class, drawn by ``--split_seed``), each mesh sampled and
    geodesic-FPS-reduced to ``num_points`` once and cached."""
    from ..data import SHREC
    from ..transforms import (Compose, GeodesicFPS, NormalizeScale,
                              SamplePoints)

    pre = Compose([
        NormalizeScale(),
        SamplePoints(args.num_points * args.sampling_margin,
                     include_normals=True, seed=args.seed),
        GeodesicFPS(args.num_points, seed=args.seed),
    ])
    return tuple(SHREC(args.data_root, split=split, pre_transform=pre,
                       split_seed=args.split_seed)
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
    args = finish_args(args, "shrec", "SHREC")

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
