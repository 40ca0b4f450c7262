"""ShapeNet part segmentation with the port (counterpart of the JAX
package's ``experiments/train_shapenet.py``).

Reference recipe (the reference release's experiments/train_shapenet.py):
2048 points with normals (NormalizeScale -> GeodesicFPS), k=30, conv
channels [64, 128, 256], MLP depth 2, embedding 1024, the categorical
one-hot head, the trainval split, NO label smoothing, the instance mIoU
every epoch; RandomScale(2/3, 3/2) + RandomTranslateGlobal(0.2) at train
time (on the batch's device).

    python -m deltaconv_tpu_torch.experiments.train_shapenet \\
        [--class_choice Airplane] [--device cpu]
"""

from __future__ import annotations

import torch

from ..transforms import augment as aug
from .common import base_parser, finish_args, make_logger

__all__ = ["RECIPE", "apply_augment", "augment",
           "build_datasets_and_classes", "build_parser", "draw_augment",
           "main", "shapenet_model"]

# Reference recipe constants (train_shapenet.py:63-64,79-89,109).
RECIPE = {
    "conv_channels": (64, 128, 256),
    "mlp_depth": 2,
    "embedding_size": 1024,
    "categorical_vector": True,
    "optimizer": "sgd",
    "lr_scale": 100,
    "weight_decay": 1e-4,
    "schedule": "cosine",
    "smoothing": 0.0,
    "aug_scales": (2.0 / 3.0, 3.0 / 2.0),
    "aug_translate": 0.2,
}


def shapenet_model(args, num_classes):
    """The recipe's segmentation model, shared with ``test_shapenet``; its
    weights are drawn from ``args.seed``."""
    from ..models import DeltaNetSegmentation

    return DeltaNetSegmentation(
        num_classes=num_classes,
        conv_channels=RECIPE["conv_channels"],
        mlp_depth=RECIPE["mlp_depth"],
        embedding_size=RECIPE["embedding_size"],
        categorical_vector=RECIPE["categorical_vector"],
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
    """RandomScale(2/3, 3/2), then RandomTranslateGlobal(0.2)."""
    return apply_augment(batch, draw_augment(generator, batch))


def build_datasets_and_classes(args):
    """``(trainval split, test split, num_classes)``: every category's 50
    part classes, or with ``--class_choice`` that category's own."""
    from ..data import ShapeNet
    from ..transforms import Compose, GeodesicFPS, NormalizeScale

    pre = Compose([
        NormalizeScale(),
        GeodesicFPS(args.num_points, seed=args.seed),
    ])
    train_ds = ShapeNet(args.data_root, categories=args.class_choice,
                        split="trainval", pre_transform=pre)
    test_ds = ShapeNet(args.data_root, categories=args.class_choice,
                       split="test", pre_transform=pre)
    if args.class_choice is None:
        num_classes = train_ds.num_classes
    else:
        num_classes = len(train_ds.seg_classes[args.class_choice])
    return train_ds, test_ds, num_classes


def build_parser():
    """CLI defaults per reference train_shapenet.py:166-200 (batch size
    16 at :169, smaller than the classifiers' 32)."""
    parser = base_parser("DeltaNet ShapeNet part segmentation (PyTorch)")
    parser.set_defaults(batch_size=16, num_points=2048, k=30, epochs=200)
    parser.add_argument("--class_choice", type=str, default=None,
                        help="Train on a single shape category")
    return parser


def main(argv=None):
    """Trains (or, with ``--checkpoint``, evaluates) and prints the test
    accuracy and the instance mIoU; returns ``(state, scalars)``."""
    args = build_parser().parse_args(argv)
    args = finish_args(args, "shapenet", "ShapeNet")

    from ..data import BatchLoader
    from ..training import (FitConfig, cosine_epoch_schedule,
                            create_train_state, evaluate_segmentation, fit,
                            restore_any, sgd_momentum)

    train_ds, test_ds, num_classes = build_datasets_and_classes(args)
    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                               seed=args.seed)
    test_loader = BatchLoader(test_ds, args.batch_size, shuffle=False,
                              drop_last=False)

    model = shapenet_model(args, num_classes)
    schedule = cosine_epoch_schedule(
        RECIPE["lr_scale"] * args.lr, args.epochs, len(train_loader),
        eta_min=args.lr)
    state = create_train_state(
        model, sgd_momentum(schedule, args.momentum,
                            weight_decay=RECIPE["weight_decay"]),
        device=args.device)

    logger, ckpt_dir = make_logger(args)

    def eval_fn(s):
        return evaluate_segmentation(model, s, test_loader,
                                     class_choice=args.class_choice)

    if args.evaluating:
        state = restore_any(args.checkpoint, state)
    else:
        config = FitConfig(epochs=args.epochs, seed=args.seed,
                           smoothing=RECIPE["smoothing"],
                           data_parallel=not args.no_data_parallel)
        state = fit(model, state, train_loader, test_loader, config,
                    logger=logger, checkpoint_dir=ckpt_dir, augment=augment,
                    resume=bool(args.resume), per_point=True,
                    eval_fn=eval_fn)
    logger.close()
    scalars = eval_fn(state)
    print("Test accuracy: {test accuracy}, mIoU: {test mIoU}".format(
        **scalars))
    return state, scalars


if __name__ == "__main__":
    main()
