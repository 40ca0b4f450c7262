"""Seeded synthetic train-to-convergence evidence (the port's counterpart
of ``experiments/synthetic_convergence.py``, with its arguments and
defaults).

Trains the flagship classification architecture (reference channels
[64, 64, 128, 256], SGD momentum + cosine: train_modelnet.py:67-68
semantics) on the deterministic class-conditioned synthetic shapes
(``data/synthetic.py``) until held-out accuracy reaches a target, or,
with ``--task seg``, the reference's ShapeNet segmentation architecture
(conv [64, 128, 256], MLP depth 2, categorical vector stream) on the
shapes' height-band parts. The whole operator-build + conv + head
pipeline must learn, not just run.

Curves go to ``<logdir>/metrics.jsonl`` via ``MetricsLogger``; the final
line of stdout is a JSON summary. Runs on the card (``--device cpu`` for
the CPU) in one process::

    python -m deltaconv_tpu_torch.experiments.synthetic_convergence
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--train_size", type=int, default=64)
    p.add_argument("--eval_size", type=int, default=64)
    p.add_argument("--num_points", type=int, default=128)
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--target", type=float, default=0.99)
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--task", choices=("cls", "seg"), default="cls",
                   help="cls: DeltaNetClassification on class-"
                        "conditioned shapes; seg: DeltaNetSegmentation "
                        "on per-point height-band parts")
    p.add_argument("--eval_precisions", type=str, default="",
                   help="comma list of serving precisions (bfloat16,"
                        "int8) to re-evaluate the TRAINED model in: "
                        "accuracy evidence for the reduced-precision "
                        "modes on learned weights, not random init")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to train on (default: cuda; cpu runs the "
                        "kernels' plain versions)")
    return p.parse_args(argv)


def _datasets(args):
    """``(train, eval)`` lists of clouds of the task, from ``args.seed``
    and ``args.seed + 1000``."""
    from ..data import Cloud
    from ..data.synthetic import synthetic_seg_shapes, synthetic_shapes

    def dataset(seed, count):
        rng = np.random.default_rng(seed)
        if args.task == "cls":
            pos, normal, labels = synthetic_shapes(
                rng, count, args.num_points, args.num_classes)
            return [Cloud(pos=pos[i], normal=normal[i],
                          y=np.int64(labels[i])) for i in range(count)]
        pos, normal, label, cats = synthetic_seg_shapes(
            rng, count, args.num_points, args.num_classes)
        out = []
        for i in range(count):
            onehot = np.zeros((16,), np.float32)
            onehot[cats[i]] = 1.0
            out.append(Cloud(pos=pos[i], normal=normal[i],
                             y=label[i].astype(np.int64), category=onehot))
        return out

    return (dataset(args.seed, args.train_size),
            dataset(args.seed + 1000, args.eval_size))


def _model(args):
    from ..models import DeltaNetClassification, DeltaNetSegmentation

    gen = torch.Generator().manual_seed(args.seed)
    if args.task == "cls":
        return DeltaNetClassification(
            num_classes=args.num_classes, conv_channels=(64, 64, 128, 256),
            num_neighbors=args.k, generator=gen)
    return DeltaNetSegmentation(
        num_classes=args.num_classes, conv_channels=(64, 128, 256),
        mlp_depth=2, categorical_vector=True, num_neighbors=args.k,
        generator=gen)


def run(args):
    """Trains until the held-out accuracy reaches ``args.target`` (or the
    epochs run out), prints the JSON summary and returns ``(best
    accuracy, the epoch that reached the target or None, the precision
    evaluations)``."""
    from ..data import BatchLoader
    from ..serving import apply_precision
    from ..training import (MetricsLogger, cosine_epoch_schedule,
                            create_train_state, evaluate_classification,
                            evaluate_segmentation, make_train_step,
                            sgd_momentum)
    from ..training.loop import _device_batch, epoch_generator

    seg = args.task == "seg"
    train, held_out = _datasets(args)
    train_loader = BatchLoader(train, args.batch_size, shuffle=True,
                               seed=args.seed)
    eval_loader = BatchLoader(held_out, args.batch_size, drop_last=False)
    model = _model(args)
    schedule = cosine_epoch_schedule(args.lr, args.epochs, len(train_loader),
                                     eta_min=args.lr * 0.01)
    state = create_train_state(model, sgd_momentum(schedule),
                               device=args.device)
    device = next(model.parameters()).device
    step = make_train_step(model, smoothing=0.2, per_point=seg)
    evaluate = evaluate_segmentation if seg else evaluate_classification

    logger = MetricsLogger(args.logdir)
    best, hit_epoch, step_idx = 0.0, None, 0
    for epoch in range(1, args.epochs + 1):
        train_loader.set_epoch(epoch)
        generator = epoch_generator(args.seed, epoch, device)
        losses = []
        for batch in train_loader:
            metrics = step(state, _device_batch(batch, device), generator)
            losses.append(float(metrics["loss"]))
            step_idx += 1
        logger.add_scalar("training loss", float(np.mean(losses)), step_idx)
        scalars = evaluate(model, state, eval_loader)
        acc = scalars["test accuracy"]
        logger.add_scalar("test accuracy", acc, epoch)
        for key in ("test mean class accuracy", "test mIoU"):
            if key in scalars:
                logger.add_scalar(key, scalars[key], epoch)
        print(f"epoch {epoch:3d}  loss {np.mean(losses):.4f}  "
              f"eval {'per-point ' if seg else ''}acc {acc:.4f}", flush=True)
        best = max(best, acc)
        if acc >= args.target:
            hit_epoch = epoch
            break
    logger.close()

    extras = {}
    for prec in filter(None, args.eval_precisions.split(",")):
        scalars = evaluate(apply_precision(model, prec), state, eval_loader)
        extras[f"accuracy_{prec}"] = round(scalars["test accuracy"], 4)
    print(json.dumps({
        **({"task": "seg"} if seg else {}),
        "converged": hit_epoch is not None,
        "epochs": hit_epoch if hit_epoch is not None else args.epochs,
        "best_accuracy": round(best, 4),
        "target": args.target,
        **extras,
    }))
    return best, hit_epoch, extras


if __name__ == "__main__":
    run(build_args())
