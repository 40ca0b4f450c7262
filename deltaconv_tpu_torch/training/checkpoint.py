"""Checkpoints with ``torch.save`` (counterpart of
``deltaconv_tpu/training/checkpoint.py``).

A checkpoint is the whole train state, so a run resumes exactly: the
model's ``state_dict`` (parameters and BatchNorm running statistics, in
the upstream release's keys), the optimizer's and the lr scheduler's
state and the step count. It is written under ``ckpt_dir/step_<N>`` (the
JAX package's names, so :func:`latest_step` reads both) as one file,
``checkpoint.pt``, in the upstream snapshot form (``model_state_dict``,
``optimizer_state_dict``, ...). :func:`restore_any` also takes a release
``.pt``/``.pth`` in any of its four forms.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["CHECKPOINT_FILE", "checkpoint_file", "latest_step",
           "load_state_dict_file", "restore_any", "restore_checkpoint",
           "save_checkpoint"]

CHECKPOINT_FILE = "checkpoint.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{int(step)}")


def save_checkpoint(ckpt_dir: str, state, step: Optional[int] = None) -> str:
    """Saves ``state`` (a :class:`~.train_state.TrainState`) under
    ``ckpt_dir/step_<N>`` (``N`` the state's step by default), replacing
    a checkpoint of the same step; the file appears whole or not at all.
    Returns the step directory."""
    step = int(state.step) if step is None else int(step)
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(state.step),
               "model_state_dict": state.model.state_dict(),
               "optimizer_state_dict": state.optimizer.state_dict(),
               "scheduler_state_dict": state.scheduler.state_dict()}
    final = os.path.join(path, CHECKPOINT_FILE)
    tmp = final + ".part"
    torch.save(payload, tmp)
    os.replace(tmp, final)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest saved step number, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_", 1)[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None


def _model_device(model) -> torch.device:
    for t in model.state_dict().values():
        return t.device
    return torch.device("cpu")


def _load(path: str, device):
    return torch.load(path, map_location=device, weights_only=True)


def load_state_dict_file(path: str, device="cpu") -> dict:
    """The model ``state_dict`` of a ``.pt``/``.pth`` file in any of the
    upstream release forms: a raw ``state_dict``, a training snapshot
    (``model_state_dict``, as :func:`save_checkpoint` writes), a
    ``state_dict`` wrapper, or keys with DataParallel's ``module.``
    prefix."""
    sd = _load(path, device)
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    elif isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def checkpoint_file(path: str) -> str:
    """The checkpoint file of a step directory, or of a checkpoint root
    (its latest step)."""
    if not os.path.basename(os.path.normpath(path)).startswith("step_"):
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = _step_dir(path, step)
    return os.path.join(path, CHECKPOINT_FILE)


def restore_checkpoint(ckpt_dir: str, target_state,
                       step: Optional[int] = None,
                       params_only: bool = False):
    """Restores a checkpoint saved by :func:`save_checkpoint` into
    ``target_state`` in place (the model's tensors are copied into, so
    the optimizer keeps its parameters) and returns it.

    Args:
      ckpt_dir: checkpoint root.
      target_state: the state to restore into; its model must have the
        same keys (``load_state_dict(strict=True)``).
      step: a specific step; defaults to the latest.
      params_only: restore the model only (parameters and running
        statistics) and keep the target's optimizer, scheduler and step:
        an eval-only consumer need not rebuild the training run's
        optimizer and schedule.

    The lr after a full restore is the target's schedule at the restored
    step (the same as the saved one when the schedules are the same).
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return _restore(os.path.join(_step_dir(ckpt_dir, step), CHECKPOINT_FILE),
                    target_state, params_only)


def _restore(path: str, target_state, params_only: bool):
    # Read on the host: the load_state_dict calls place each tensor as a
    # live state holds it (parameters and their moments on the model's
    # device, Adam's step counts on the host, where torch keeps them).
    payload = _load(path, "cpu")
    target_state.model.load_state_dict(payload["model_state_dict"],
                                       strict=True)
    if not params_only:
        target_state.optimizer.load_state_dict(
            payload["optimizer_state_dict"])
        target_state.scheduler.load_state_dict(
            payload["scheduler_state_dict"])
        target_state.step = int(payload["step"])
        _lr_at_restored_step(target_state.scheduler)
    return target_state


def _lr_at_restored_step(scheduler):
    """Sets each group's lr to the target's own schedule at the restored
    step, as optax evaluates its schedule at every update: the optimizer
    state holds the lr of the SAVING run's schedule, which a resumed run
    with a longer schedule (more epochs, so another cosine) must not
    keep. The port's factories all schedule through ``LambdaLR``, whose
    lambdas stay the target's (its state holds none)."""
    if not isinstance(scheduler, torch.optim.lr_scheduler.LambdaLR):
        return
    lrs = [base * fn(scheduler.last_epoch) for base, fn in
           zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs


def restore_any(path: str, target_state, params_only: bool = False):
    """Restores a checkpoint root (its latest step), a step directory, or
    a release ``.pt``/``.pth`` (:func:`load_state_dict_file`; the model
    only) into ``target_state`` and returns it. ``params_only`` as in
    :func:`restore_checkpoint`."""
    if path.endswith((".pt", ".pth")):
        target_state.model.load_state_dict(
            load_state_dict_file(path, _model_device(target_state.model)),
            strict=True)
        return target_state
    return _restore(checkpoint_file(path), target_state, params_only)
