"""Data parallelism over a ``torch.distributed`` process group
(counterpart of ``deltaconv_tpu/parallel/mesh.py``).

Point clouds are independent, so the scaling axis is the batch: each
rank holds an equal block of axis 0 of every batch array; parameters,
optimizer state and BatchNorm statistics are replicated. The step
itself completes the statistics, the loss and the gradients over the
group (``training.make_train_step(..., group=)``), where JAX's XLA
inserts the collectives from the sharding annotations.

One process drives one card: ``torchrun --nproc_per_node=<cards> -m
deltaconv_tpu_torch.experiments.train_modelnet`` starts a rank per card,
and :func:`make_mesh` joins them (``nccl`` on the cards, ``gloo`` on
the CPU).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .collectives import rank_and_size

__all__ = ["is_main_rank", "make_mesh", "shard_batch", "shard_train_step"]

_TIMEOUT = timedelta(minutes=10)  # of the group's collectives


def make_mesh(group=None, backend: Optional[str] = None):
    """The data-parallel group: ``group`` when given; else the default
    (world) group, initialised first from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) when it
    is not yet. ``backend`` defaults to ``nccl`` with a card and ``gloo``
    without; a ``nccl`` rank takes the card ``LOCAL_RANK``. Returns None
    outside ``torchrun`` with no group initialised (one process)."""
    if group is not None:
        return group
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return None
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, timeout=_TIMEOUT)
    return dist.group.WORLD


def is_main_rank(group=None) -> bool:
    """Whether this process is rank 0 of ``group`` (of the default group
    when None and one is initialised): the rank that logs and writes
    checkpoints. True without any group."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return True
        group = dist.group.WORLD
    return dist.get_rank(group) == 0


def shard_batch(batch: dict, group=None) -> dict:
    """This rank's block of axis 0 of every array of ``batch`` (a dict of
    tensors or numpy arrays): rank ``r`` of ``D`` keeps rows ``r B / D ..
    (r + 1) B / D``. A batch whose size is not a multiple of ``D``
    raises."""
    rank, size = rank_and_size(group)
    out = {}
    for key, value in batch.items():
        n = value.shape[0]
        if n % size:
            raise ValueError(
                f"shard_batch: {key!r} has {n} rows, not a multiple of the "
                f"group's {size} ranks")
        m = n // size
        out[key] = value[rank * m:(rank + 1) * m]
    return out


def shard_train_step(train_step: Callable) -> Callable:
    """Wraps ``train_step(state, batch, generator)`` made by
    ``training.make_train_step(..., group=group)``: each rank passes the
    GLOBAL batch, the wrapper keeps its rows (:func:`shard_batch`) over
    the step's own group (``train_step.group``, so the batch's split and
    the step's collectives cannot part) and runs the step, whose metrics
    are the whole batch's. JAX's takes the mesh; here the step already
    holds it. The state stays replicated, so the wrapper composes with
    checkpointing untouched."""
    group = train_step.group

    def wrapped(state, batch, generator):
        return train_step(state, shard_batch(batch, group), generator)

    return wrapped
