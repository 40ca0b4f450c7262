"""Voting evaluation of a trained ShapeNet model with the port
(counterpart of the JAX package's ``experiments/test_shapenet.py``):
``--num_votes`` passes over the test set under the training
augmentation, the logits summed, the argmax scored by instance mIoU and
per-category IoU (reference test_shapenet.py).

    python -m deltaconv_tpu_torch.experiments.test_shapenet \\
        --checkpoint RUN_DIR/checkpoints [--num_votes 10] [--device cpu]
"""

from __future__ import annotations

from .common import base_parser, finish_args
from .train_shapenet import augment, build_datasets_and_classes, \
    shapenet_model

__all__ = ["build_parser", "main"]


def build_parser():
    """CLI defaults per reference test_shapenet.py:117-146 (batch size 16
    at :124, 10 votes at :126)."""
    parser = base_parser("DeltaNet ShapeNet voting evaluation (PyTorch)")
    parser.set_defaults(batch_size=16, num_points=2048, k=30)
    parser.add_argument("--class_choice", type=str, default=None)
    parser.add_argument("--num_votes", type=int, default=10,
                        help="Stochastic-augmented eval passes")
    return parser


def main(argv=None):
    """Restores ``--checkpoint``'s weights and prints the voted instance
    mIoU and each category's IoU; returns ``(state, scalars)``, the
    scalars ``"test mIoU"`` and ``"IoU <category>"``."""
    args = build_parser().parse_args(argv)
    args = finish_args(args, "shapenet_test", "ShapeNet")
    if not args.checkpoint:
        raise SystemExit("--checkpoint is required for voting evaluation")

    from ..data import BatchLoader, ShapeNet
    from ..training import (create_train_state, evaluate_voting,
                            restore_any, sgd_momentum)

    _, test_ds, num_classes = build_datasets_and_classes(args)
    test_loader = BatchLoader(test_ds, args.batch_size, shuffle=False,
                              drop_last=False)

    model = shapenet_model(args, num_classes)
    state = create_train_state(model, sgd_momentum(0.1), device=args.device)
    state = restore_any(args.checkpoint, state, params_only=True)

    mean_iou, per_class = evaluate_voting(
        model, state, test_loader, augment, num_votes=args.num_votes,
        seed=args.seed, class_choice=args.class_choice)
    print(f"Instance mIoU over {args.num_votes} votes: {mean_iou:.4f}")
    names = list(ShapeNet.category_ids.keys())
    scalars = {"test mIoU": mean_iou}
    for cat, iou in sorted(per_class.items()):
        print(f"  {names[cat]:<12s} {iou:.4f}")
        scalars[f"IoU {names[cat]}"] = iou
    return state, scalars


if __name__ == "__main__":
    main()
