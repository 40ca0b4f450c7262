"""ModelNet40/10 classification with the port (counterpart of the JAX
package's ``experiments/train_modelnet.py``).

Reference recipe (the reference release's experiments/train_modelnet.py):
pre-transform NormalizeScale -> SamplePoints(8x num_points, normals) ->
GeodesicFPS(num_points); train-time RandomScale(4/5, 5/4) +
RandomTranslateGlobal(0.1) (on the batch's device); SGD momentum 0.9,
wd 1e-4, lr 100x base with per-epoch cosine annealing to eta_min=lr;
label smoothing 0.2; checkpoints every 50 epochs.

    python -m deltaconv_tpu_torch.experiments.train_modelnet \\
        [--num_classes 10] [--device cpu]
"""

from __future__ import annotations

import torch

from ..transforms import augment as aug
from .common import base_parser, finish_args, make_logger

__all__ = ["RECIPE", "apply_augment", "augment", "build_datasets",
           "build_model", "build_parser", "draw_augment", "main"]


def build_datasets(args):
    from ..data import ModelNet
    from ..transforms import (Compose, GeodesicFPS, NormalizeScale,
                              SamplePoints)

    pre = Compose([
        NormalizeScale(),
        SamplePoints(args.num_points * args.sampling_margin,
                     include_normals=True, seed=args.seed),
        GeodesicFPS(args.num_points, seed=args.seed),
    ])
    name = str(args.num_classes)
    train = ModelNet(args.data_root, name=name, split="train",
                     pre_transform=pre)
    test = ModelNet(args.data_root, name=name, split="test",
                    pre_transform=pre)
    return train, test


# Reference recipe constants (train_modelnet.py:30-40,67-68,102; the
# model uses DeltaNetClassification's defaults [64, 64, 128, 256] /
# mlp_depth 1, deltanet_classification.py:14-16).
RECIPE = {
    "conv_channels": (64, 64, 128, 256),
    "mlp_depth": 1,
    "optimizer": "sgd",
    "lr_scale": 100,
    "weight_decay": 1e-4,
    "schedule": "cosine",
    "smoothing": 0.2,
    "aug_scales": (4.0 / 5.0, 5.0 / 4.0),
    "aug_translate": 0.1,
}


def build_model(args):
    """The recipe's classifier; its weights are drawn from ``args.seed``.
    The port's DeltaNetClassification has the recipe's ``mlp_depth`` 1
    only."""
    from ..models import DeltaNetClassification

    return DeltaNetClassification(
        num_classes=args.num_classes,
        conv_channels=RECIPE["conv_channels"],
        num_neighbors=args.k,
        grad_regularizer=args.grad_regularizer,
        grad_kernel_width=args.grad_kernel,
        operator_dtype=args.operator_dtype,
        knn_method=args.knn_method,
        generator=torch.Generator().manual_seed(args.seed),
    )


def draw_augment(generator, batch):
    """Per-cloud scales, then per-cloud offsets (the JAX CLI's order)."""
    pos = batch["pos"]
    return (aug.draw_scale(generator, pos, RECIPE["aug_scales"]),
            aug.draw_translation(generator, pos, RECIPE["aug_translate"]))


def apply_augment(batch, draws):
    scale, shift = draws
    pos, normal = aug.apply_scale(batch["pos"], batch.get("normal"), scale)
    out = dict(batch)
    out["pos"] = aug.apply_translation(pos, shift)
    if normal is not None:
        out["normal"] = normal
    return out


def augment(generator, batch):
    """RandomScale(4/5, 5/4), then RandomTranslateGlobal(0.1)."""
    return apply_augment(batch, draw_augment(generator, batch))


def build_parser():
    """CLI defaults per reference train_modelnet.py:145-184."""
    parser = base_parser("DeltaNet ModelNet classification (PyTorch)")
    parser.add_argument("--num_classes", type=int, default=40,
                        metavar="40,10",
                        help="ModelNet variant (default: 40)")
    return parser


def main(argv=None):
    """Trains (or, with ``--checkpoint``, evaluates) and prints the test
    accuracy and mean class accuracy; returns ``(state, scalars)``."""
    args = build_parser().parse_args(argv)
    args = finish_args(args, f"modelnet{args.num_classes}",
                       f"ModelNet{args.num_classes}")

    from ..data import BatchLoader
    from ..training import (FitConfig, cosine_epoch_schedule,
                            create_train_state, evaluate_classification, fit,
                            restore_any, sgd_momentum)

    train_ds, test_ds = build_datasets(args)
    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                               drop_last=True, seed=args.seed)
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
    print("Test accuracy: {test accuracy}, test mca: "
          "{test mean class accuracy}".format(**scalars))
    return state, scalars


if __name__ == "__main__":
    main()
