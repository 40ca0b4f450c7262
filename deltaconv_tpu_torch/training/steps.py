"""Train and eval steps (counterpart of
``deltaconv_tpu/training/steps.py``). One train step runs what the
reference's hot loop runs per batch: the operator build, the forward,
the loss, the backward, the SGD update and the BatchNorm running-stat
update. It runs a model in f32 or at the production mixed precision
(``compute_dtype`` and ``operator_dtype`` bf16): bf16 products and
activations, f32 BatchNorm, logits, loss and parameters.

With a process group of more than one rank (``make_train_step(...,
group=)``, data parallelism: each rank holds its block of the global
batch, ``parallel.shard_batch``) the step is JAX's data-parallel step
(``shard_train_step``, where XLA computes the global batch's
statistics): every BatchNorm's moments are those of the whole batch,
each rank keeps its rows of the whole batch's dropout masks, the loss is
replicated on every rank as ``psum(sum nll m) / psum(sum m)`` (the global
masked mean, also on a ragged segmentation batch), the backward runs
through the collectives and the parameter gradients are averaged over
the ranks (one flattened collective) before the optimizer steps, so the
ranks hold the same bits and track the one-process step on the whole
batch."""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import KERNEL_OPS, Ops
from ..parallel.collectives import pmean_gradients, psum, rank_and_size
from .losses import smooth_cross_entropy, smooth_nll

__all__ = ["make_eval_step", "make_train_step"]


def _strict_f32():
    # TF32 would reorder near-tied kNN neighbours and move the results;
    # it stays off in bf16 too (the build and the loss run in f32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _batch_kwargs(batch) -> dict:
    """The optional model inputs present in the batch (JAX
    ``_batch_kwargs``): ``normal``, ``point_mask`` and ``category``."""
    if batch.get("features") is not None:
        raise NotImplementedError(
            "per-point input features (the backbone's `features` input) are "
            "not ported yet: ROADMAP queue 1 item [14]")
    return {key: batch[key] for key in ("normal", "point_mask", "category")
            if batch.get(key) is not None}


def _replicated_loss(logits, labels, smoothing, label_mask, group):
    """The loss of the whole batch on every rank: ``psum(sum nll m) /
    psum(sum m)`` (``m`` the label mask, or ones)."""
    nll = smooth_nll(logits, labels, smoothing)
    m = (torch.ones_like(nll) if label_mask is None
         else label_mask.to(nll.dtype))
    sums = psum(torch.stack([(nll * m).sum(), m.sum()]), group)
    return sums[0] / torch.clamp(sums[1], min=1.0)


def make_train_step(model, smoothing: float = 0.2, per_point: bool = False,
                    ops: Ops = KERNEL_OPS, group=None) -> Callable:
    """Returns ``train_step(state, batch, generator) -> metrics``.

    ``batch``: a dict of tensors on the model's device, ``pos`` and
    ``normal`` ``[B, N, 3]``, ``label`` (``[B]`` int, or ``[B, N]`` with
    ``per_point``, the segmentation labels) and optionally ``point_mask
    [B, N]`` bool and ``category [B, 16]`` (the segmentation model's
    one-hot). ``generator`` (on the same device) draws the dropout masks.
    With ``per_point`` the loss and the accuracy leave out the points
    ``point_mask`` pads. The step updates ``state`` in place and returns
    ``{"loss", "accuracy"}`` as 0-d tensors. ``ops`` selects the kernels
    (default) or their plain versions.

    ``group``: a ``torch.distributed`` process group over which the
    batch is split (this rank's ``batch``: its block of the global
    batch; every rank passes a generator in the same state); the step is
    then the data-parallel one of the module docstring, and its metrics
    those of the whole batch. None, or a group of one rank: the
    one-process step. The step carries the group as ``.group`` (None for
    one rank), which ``parallel.shard_train_step`` splits the batch over.
    """
    if rank_and_size(group)[1] == 1:
        group = None
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state, batch, generator: torch.Generator):
        _strict_f32()
        model.train()
        logits = model(batch["pos"], ops=ops, generator=generator,
                       batch_group=group, **_batch_kwargs(batch))
        label_mask = batch.get("point_mask") if per_point else None
        if group is None:
            loss = smooth_cross_entropy(logits, batch["label"], smoothing,
                                        label_mask)
        else:
            loss = _replicated_loss(logits, batch["label"], smoothing,
                                    label_mask, group)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        pmean_gradients(params, group)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            correct = (logits.argmax(dim=-1) == batch["label"]).float()
            if group is not None:
                m = (torch.ones_like(correct) if label_mask is None
                     else label_mask.float())
                sums = psum(torch.stack([(correct * m).sum(), m.sum()]),
                            group)
                accuracy = sums[0] / torch.clamp(sums[1], min=1)
            elif label_mask is None:
                accuracy = correct.mean()
            else:
                m = label_mask.float()
                accuracy = (correct * m).sum() / torch.clamp(m.sum(), min=1)
        return {"loss": loss.detach(), "accuracy": accuracy}

    train_step.group = group  # the rows ``parallel.shard_train_step`` keeps
    return train_step


def make_eval_step(model, per_point: bool = False,
                   ops: Ops = KERNEL_OPS) -> Callable:
    """Returns ``eval_step(state, batch) -> logits`` (running statistics,
    no dropout, no autograd), the batch's optional inputs as the train
    step's. ``per_point`` is the JAX signature's and changes nothing: the
    logits are per point when the model's are."""
    del per_point

    def eval_step(state, batch):
        _strict_f32()
        model.eval()
        with torch.no_grad():
            return model(batch["pos"], ops=ops, **_batch_kwargs(batch))

    return eval_step
