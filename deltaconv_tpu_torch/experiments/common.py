"""Shared CLI plumbing of the port's experiment scripts (a copy of the
JAX package's ``experiments/common.py``): the reference's argparse
vocabulary (train_modelnet.py:145-226), the JAX CLIs' extras (operator
dtype, kNN method, data parallelism) and ``--device``. Datasets and runs
default to the JAX CLIs' folders, so one dataset on disk serves both
packages."""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from ..training import MetricsLogger, make_run_dir

__all__ = ["EXPERIMENTS_DIR", "base_parser", "finish_args", "make_logger"]

#: the JAX CLIs' folder: ``data/<name>`` holds the datasets, ``runs/`` the
#: runs.
EXPERIMENTS_DIR = Path(__file__).resolve().parents[2] / "experiments"


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    # Optimization.
    p.add_argument("--batch_size", type=int, default=32,
                   help="Size of batch (default: 32)")
    p.add_argument("--epochs", type=int, default=250,
                   help="Number of epochs to train (default: 250)")
    p.add_argument("--lr", type=float, default=0.001,
                   help="Learning rate (default: 0.001)")
    p.add_argument("--momentum", type=float, default=0.9,
                   help="SGD momentum (default: 0.9)")
    # DeltaConv.
    p.add_argument("--k", type=int, default=20,
                   help="Number of nearest neighbors (default: 20)")
    p.add_argument("--grad_regularizer", type=float, default=0.001,
                   metavar="lambda",
                   help="WLS regularizer lambda (default: 0.001)")
    p.add_argument("--grad_kernel", type=float, default=1,
                   help="WLS kernel width relative to avg edge length")
    # Dataset.
    p.add_argument("--sampling_margin", type=int, default=8,
                   help="Oversampling factor before FPS (default: 8)")
    p.add_argument("--num_points", type=int, default=1024, metavar="N",
                   help="Number of points (default: 1024)")
    p.add_argument("--data_root", type=str, default="",
                   help="Dataset root (default: experiments/data/<name>)")
    # Logging / debugging.
    p.add_argument("--logdir", type=str, default="",
                   help="Log root; runs go to LOGDIR/runs/EXPERIMENT/TIME "
                        "(default: experiments)")
    p.add_argument("--seed", type=int, default=1,
                   help="random seed (default: 1)")
    # Evaluation.
    p.add_argument("--checkpoint", type=str, default="",
                   help="Checkpoint root, step directory or release .pt; "
                        "evaluate-only when given")
    p.add_argument("--resume", type=str, default="",
                   help="Previous run dir (or its checkpoints dir): "
                        "restore the latest checkpoint, keep logging "
                        "there, and continue training")
    # The JAX CLIs' extras.
    p.add_argument("--operator_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="Dense-operator matmul dtype (default: bfloat16)")
    p.add_argument("--knn_method", type=str, default="exact",
                   choices=["exact", "approx"],
                   help="kNN search (approx: the knn_topk kernel's packed "
                        "keys on uniform batches)")
    p.add_argument("--no_data_parallel", action="store_true",
                   help="Disable data parallelism (the port has none yet: "
                        "with more than one visible card, pass this)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to train and evaluate on (default: cuda; "
                        "cpu runs the kernels' plain versions)")
    return p


def finish_args(args, experiment_name: str, default_data_subdir: str):
    args.experiment_name = experiment_name
    args.evaluating = args.checkpoint != ""
    if not args.data_root:
        args.data_root = str(EXPERIMENTS_DIR / "data" / default_data_subdir)
    if not args.logdir:
        args.logdir = str(EXPERIMENTS_DIR)
    return args


def make_logger(args):
    """``(logger, checkpoint dir)`` of the run: none when evaluating; the
    run being resumed (``--resume``), where metrics.jsonl appends and
    checkpoints land beside the earlier ones; else a new run directory
    with its ``settings.txt``."""
    if args.evaluating:
        return MetricsLogger(None), None
    if getattr(args, "resume", ""):
        run_dir = args.resume
        cand = os.path.join(run_dir, "checkpoints")
        ckpt_dir = cand if os.path.isdir(cand) else run_dir
        logger = MetricsLogger(run_dir)
        print(f"Resuming run in {run_dir}")
        return logger, ckpt_dir
    run_dir = make_run_dir(args.logdir, args.experiment_name)
    logger = MetricsLogger(run_dir)
    logger.write_settings(args, args.experiment_name)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    print(f"Logging to {run_dir}")
    return logger, ckpt_dir
