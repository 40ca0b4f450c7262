"""High-level training and evaluation loops (counterpart of
``deltaconv_tpu/training/loop.py``), shared by the experiment CLIs:

* the train step (operator build, forward, backward, update) on the
  model's device, optional batched augmentation in front of it,
* epoch-level eval, TensorBoard/JSONL logging, periodic checkpoints with
  the optimizer's and the scheduler's state.

Every epoch's random stream (the augmentation's draws and the dropout
masks) is one ``torch.Generator`` on the model's device seeded from
``(seed, epoch)`` alone, and :meth:`BatchLoader.set_epoch` makes the
shuffle order a function of ``(seed, epoch)`` too, so a run resumed from
a checkpoint follows the uninterrupted run bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import KERNEL_OPS, Ops
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .logging import MetricsLogger
from .metrics import accuracy, balanced_accuracy, shape_iou
from .steps import make_eval_step, make_train_step
from .train_state import TrainState

__all__ = ["FitConfig", "epoch_generator", "fit", "evaluate_classification",
           "evaluate_segmentation", "evaluate_voting"]


@dataclasses.dataclass
class FitConfig:
    epochs: int = 250
    seed: int = 1
    smoothing: float = 0.2
    checkpoint_every: int = 50
    data_parallel: bool = True
    log_every: int = 50


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _device_batch(batch, device) -> dict:
    """A loader's numpy batch as tensors on ``device`` (labels int64)."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.asarray(value))
        if key == "label":
            t = t.long()
        out[key] = t.to(device)
    return out


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The epoch's random stream: a generator on ``device`` whose seed is
    a pure function of ``(seed, epoch)`` (JAX's ``fold_in``)."""
    state = np.random.SeedSequence([int(seed), int(epoch)]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


def _host_mean(window) -> float:
    """The mean of 0-d device tensors, fetched once (f32 as JAX's)."""
    return float(np.mean(torch.stack(window).cpu().numpy()))


def _check_data_parallel(config: FitConfig, device: torch.device):
    if (config.data_parallel and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            f"data_parallel=True with {torch.cuda.device_count()} visible "
            "cards: the port has no data parallelism yet (ROADMAP queue 1 "
            "item [11]); pass data_parallel=False (--no_data_parallel) or "
            "make one card visible")


def fit(model, state: TrainState, train_loader, test_loader,
        config: FitConfig, logger: Optional[MetricsLogger] = None,
        checkpoint_dir: Optional[str] = None,
        augment: Optional[Callable] = None, per_point: bool = False,
        eval_fn: Optional[Callable] = None, resume: bool = False,
        ops: Ops = KERNEL_OPS):
    """Runs the full training loop; returns the final state (the same
    object, trained in place).

    Args:
      model: the model ``state`` trains (``state.model``).
      state: a :class:`TrainState` (see ``create_train_state``), on the
        device the loop runs on.
      train_loader / test_loader: BatchLoader-compatible iterables of
        numpy batches.
      config: loop hyperparameters. ``data_parallel`` changes nothing on
        one visible card and raises with more (the port has no data
        parallelism yet).
      logger: MetricsLogger (or None for silent).
      checkpoint_dir: where periodic and final checkpoints go.
      augment: optional ``(generator, batch) -> batch`` on the batch's
        device, drawing from ``generator``.
      per_point: segmentation-style labels.
      eval_fn: ``(state) -> dict`` of scalars logged per epoch; default
        classification accuracy over ``test_loader``.
      resume: restore the latest checkpoint under ``checkpoint_dir``
        (model, optimizer, scheduler and step) and continue from the next
        epoch, on the trajectory of an uninterrupted run (checkpoints
        land on epoch boundaries; mid-epoch progress since the last one
        is trained again). A no-op when no checkpoint exists yet.
      ops: the kernels (default) or their plain versions.
    """
    logger = logger or MetricsLogger(None)
    device = _device(model)
    _check_data_parallel(config, device)
    start_epoch = 1
    if resume and checkpoint_dir:
        last = latest_step(checkpoint_dir)
        if last is not None:
            restore_checkpoint(checkpoint_dir, state, step=last)
            start_epoch = last + 1
    train_step = make_train_step(model, smoothing=config.smoothing,
                                 per_point=per_point, ops=ops)

    if eval_fn is None:
        if per_point:
            eval_fn = lambda s: evaluate_segmentation(  # noqa: E731
                model, s, test_loader, ops=ops)
        else:
            eval_fn = lambda s: evaluate_classification(  # noqa: E731
                model, s, test_loader, ops=ops)

    step_idx = int(state.step)
    # Metrics stay on the device inside the epoch (a float() per step
    # would block the host every step); they are fetched once per log
    # window and epoch.
    loss_window = []
    for epoch in range(start_epoch, config.epochs + 1):
        generator = epoch_generator(config.seed, epoch, device)
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        accs = []
        for batch in train_loader:
            batch = _device_batch(batch, device)
            if augment is not None:
                batch = augment(generator, batch)
            metrics = train_step(state, batch, generator)
            step_idx += 1
            loss_window.append(metrics["loss"])
            if step_idx % config.log_every == 0:
                logger.add_scalar("training loss", _host_mean(loss_window),
                                  step_idx)
                loss_window = []
            accs.append(metrics["accuracy"])
        logger.add_scalar("training accuracy", _host_mean(accs), epoch)

        scalars = eval_fn(state)
        for tag, value in scalars.items():
            logger.add_scalar(tag, value, epoch)

        if checkpoint_dir and epoch % config.checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state, step=epoch)

    if checkpoint_dir:
        save_checkpoint(checkpoint_dir, state, step=config.epochs)
    return state


def _argmax(logits) -> np.ndarray:
    return logits.argmax(dim=-1).cpu().numpy()


def evaluate_classification(model, state, loader, ops: Ops = KERNEL_OPS
                            ) -> dict:
    """Overall and mean-class accuracy (reference evaluate,
    train_modelnet.py:124-143)."""
    del state  # the model holds the weights
    eval_step = make_eval_step(model, ops=ops)
    device = _device(model)
    preds, trues = [], []
    for batch in loader:
        batch = _device_batch(batch, device)
        preds.append(_argmax(eval_step(None, batch)))
        trues.append(batch["label"].cpu().numpy())
    pred = np.concatenate(preds)
    true = np.concatenate(trues)
    return {
        "test accuracy": accuracy(pred, true),
        "test mean class accuracy": balanced_accuracy(pred, true),
    }


def evaluate_segmentation(model, state, loader,
                          class_choice: Optional[str] = None,
                          with_iou: bool = True,
                          ops: Ops = KERNEL_OPS) -> dict:
    """Per-point accuracy (and the ShapeNet instance mIoU when the
    batches carry category one-hots)."""
    del state
    eval_step = make_eval_step(model, per_point=True, ops=ops)
    device = _device(model)
    preds, trues, cats = [], [], []
    for batch in loader:
        batch = _device_batch(batch, device)
        preds.append(_argmax(eval_step(None, batch)))
        trues.append(batch["label"].cpu().numpy())
        if "category" in batch:
            cats.append(_argmax(batch["category"]))
    pred = np.concatenate(preds)
    true = np.concatenate(trues)
    out = {"test accuracy": accuracy(pred, true)}
    if with_iou and cats:
        ious = shape_iou(pred, true, np.concatenate(cats), class_choice)
        out["test mIoU"] = float(np.mean(ious))
    return out


def evaluate_voting(model, state, loader, augment, num_votes: int = 10,
                    seed: int = 0, class_choice: Optional[str] = None,
                    ops: Ops = KERNEL_OPS):
    """Voting evaluation: ``num_votes`` augmented passes, logits summed,
    argmax (reference test_shapenet.py:79-96). ``augment``: ``(generator,
    batch) -> batch`` (or None); every (vote, batch) draws from one
    generator on the model's device seeded with ``seed``.

    Returns ``(mean_iou, per_class_iou dict)`` for segmentation loaders
    with categories, else ``(overall accuracy, {})``. A loader whose
    order changes between votes raises: votes sum by position.
    """
    del state
    eval_step = make_eval_step(model, per_point=True, ops=ops)
    device = _device(model)
    generator = torch.Generator(device=device).manual_seed(int(seed))

    logits_sum, trues, cats = None, [], []
    for v in range(num_votes):
        batch_logits, vote_labels = [], []
        for batch in loader:
            batch = _device_batch(batch, device)
            vote_labels.append(batch["label"].cpu().numpy())
            if augment is not None:
                batch = augment(generator, batch)
            batch_logits.append(eval_step(None, batch).float().cpu().numpy())
            if v == 0:
                trues.append(vote_labels[-1])
                if "category" in batch:
                    cats.append(_argmax(batch["category"]))
        stacked = np.concatenate(batch_logits)
        if v > 0 and (len(vote_labels) != len(trues) or not all(
                np.array_equal(a, b) for a, b in zip(vote_labels, trues))):
            # Votes sum by position across loader passes: a loader that
            # reshuffles between passes would add cloud A's logits into
            # cloud B's slot.
            raise ValueError(
                "evaluate_voting: the loader yielded a different sample "
                "order on vote %d — disable shuffling (or pin the "
                "loader's epoch) for voting evaluation" % v)
        logits_sum = stacked if v == 0 else logits_sum + stacked

    pred = np.argmax(logits_sum, axis=-1)
    true = np.concatenate(trues)
    if cats:
        cat = np.concatenate(cats)
        ious = np.asarray(shape_iou(pred, true, cat, class_choice))
        per_class = {}
        for c in np.unique(cat):
            per_class[int(c)] = float(np.mean(ious[cat == c]))
        return float(np.mean(ious)), per_class
    return accuracy(pred, true), {}
