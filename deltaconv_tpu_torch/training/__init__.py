"""Training layer of the port: losses, metrics, train state, train and
eval steps (counterpart of ``deltaconv_tpu/training``; the fit loop,
checkpoints and logging are still to port; the augmentations are in
``transforms.augment``)."""

from .losses import cross_entropy, smooth_cross_entropy, smooth_nll
from .metrics import accuracy, balanced_accuracy, shape_iou
from .steps import make_eval_step, make_train_step
from .train_state import (TrainState, cosine_epoch_schedule,
                          create_train_state, sgd_momentum)

__all__ = ["TrainState", "accuracy", "balanced_accuracy",
           "cosine_epoch_schedule", "create_train_state", "cross_entropy",
           "make_eval_step", "make_train_step", "sgd_momentum", "shape_iou",
           "smooth_cross_entropy", "smooth_nll"]
