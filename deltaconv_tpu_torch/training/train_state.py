"""Train state and optimizer factories (counterpart of
``deltaconv_tpu/training/train_state.py``).

The reference recipe: SGD with momentum 0.9 and weight decay 1e-4, base
lr ``100 * lr`` annealed by a per-epoch cosine down to ``eta_min``.
optax's ``add_decayed_weights`` before ``sgd(momentum)`` is torch's
coupled decay, so the optimizer is ``torch.optim.SGD`` itself; the
schedule is step-indexed and applied after every step by ``LambdaLR``
on a base lr of 1. The ShapeSeg recipe's Adam with a per-epoch StepLR
(:func:`adam_steplr`) is ``torch.optim.Adam`` the same way: optax's
``adam`` and torch's both correct the moments' bias and add eps outside
the square root.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Union

import torch
from torch import nn

from ..utils.device import resolve_device

__all__ = ["TrainState", "adam_steplr", "cosine_epoch_schedule",
           "create_train_state", "sgd_momentum"]


@dataclass
class TrainState:
    """The model, its optimizer and lr scheduler, and the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def cosine_epoch_schedule(base_lr: float, epochs: int, steps_per_epoch: int,
                          eta_min: float = 0.0) -> Callable[[int], float]:
    """Cosine annealing stepped once per epoch (torch
    ``CosineAnnealingLR(T_max=epochs, eta_min)``), as a function of the
    step."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, epochs)
        cos = 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))
        return eta_min + (base_lr - eta_min) * cos

    return schedule


def sgd_momentum(learning_rate: Union[float, Callable[[int], float]],
                 momentum: float = 0.9, weight_decay: float = 1e-4):
    """torch-style SGD with coupled weight decay over all parameters.
    ``learning_rate`` is a number or a function of the step. Returns a
    factory ``params -> (optimizer, scheduler)`` for
    :func:`create_train_state`."""
    schedule = (learning_rate if callable(learning_rate)
                else lambda step: learning_rate)

    def make(params):
        opt = torch.optim.SGD(params, lr=1.0, momentum=momentum,
                              weight_decay=weight_decay, nesterov=False)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)

    return make


def adam_steplr(base_lr: float, step_size: int, gamma: float,
                steps_per_epoch: int):
    """Adam (betas 0.9, 0.999, eps 1e-8, no weight decay) with a
    per-epoch StepLR decay, ``base_lr * gamma ** (epoch // step_size)``
    (train_shapeseg.py:82-83), stepped once per step. Returns a factory
    as :func:`sgd_momentum` does."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return base_lr * gamma ** (epoch // step_size)

    def make(params):
        opt = torch.optim.Adam(params, lr=1.0)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)

    return make


def create_train_state(model: nn.Module, tx, device="cuda") -> TrainState:
    """Moves ``model`` (already initialized) to ``device``, the card by
    default, and wraps it with the optimizer that ``tx`` (e.g.
    :func:`sgd_momentum`) builds over its parameters. Without a card the
    default raises: pass ``device="cpu"`` to train on the CPU."""
    model.to(resolve_device(device))
    optimizer, scheduler = tx(model.parameters())
    return TrainState(model, optimizer, scheduler)
