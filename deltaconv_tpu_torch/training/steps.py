"""Train and eval steps (counterpart of
``deltaconv_tpu/training/steps.py``). One train step runs what the
reference's hot loop runs per batch: the operator build, the forward,
the loss, the backward, the SGD update and the BatchNorm running-stat
update. It runs a model in f32 or at the production mixed precision
(``compute_dtype`` and ``operator_dtype`` bf16): bf16 products and
activations, f32 BatchNorm, logits, loss and parameters."""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import KERNEL_OPS, Ops
from .losses import smooth_cross_entropy

__all__ = ["make_eval_step", "make_train_step"]


def _strict_f32():
    # TF32 would reorder near-tied kNN neighbours and move the results;
    # it stays off in bf16 too (the build and the loss run in f32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_train_step(model, smoothing: float = 0.2,
                    ops: Ops = KERNEL_OPS) -> Callable:
    """Returns ``train_step(state, batch, generator) -> metrics``.

    ``batch``: a dict of tensors on the model's device, ``pos`` and
    ``normal`` ``[B, N, 3]``, ``label [B]`` int and optionally
    ``point_mask [B, N]`` bool. ``generator`` (on the same device)
    draws the dropout masks. The step updates ``state`` in place and
    returns ``{"loss", "accuracy"}`` as 0-d tensors. ``ops`` selects
    the kernels (default) or their plain versions. Per-point labels
    (segmentation) are not ported yet.
    """

    def train_step(state, batch, generator: torch.Generator):
        _strict_f32()
        model.train()
        logits = model(batch["pos"], batch.get("normal"),
                       batch.get("point_mask"), ops=ops,
                       generator=generator)
        loss = smooth_cross_entropy(logits, batch["label"], smoothing)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            accuracy = (logits.argmax(dim=-1) == batch["label"]).float()
        return {"loss": loss.detach(), "accuracy": accuracy.mean()}

    return train_step


def make_eval_step(model, ops: Ops = KERNEL_OPS) -> Callable:
    """Returns ``eval_step(state, batch) -> logits`` (running statistics,
    no dropout, no autograd)."""

    def eval_step(state, batch):
        _strict_f32()
        model.eval()
        with torch.no_grad():
            return model(batch["pos"], batch.get("normal"),
                         batch.get("point_mask"), ops=ops)

    return eval_step
