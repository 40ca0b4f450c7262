"""Training layer of the port: losses, train state, train and eval
steps (counterpart of ``deltaconv_tpu/training``; the fit loop,
checkpoints and augmentation are still to port)."""

from .losses import cross_entropy, smooth_cross_entropy, smooth_nll
from .steps import make_eval_step, make_train_step
from .train_state import (TrainState, cosine_epoch_schedule,
                          create_train_state, sgd_momentum)

__all__ = ["TrainState", "cosine_epoch_schedule", "create_train_state",
           "cross_entropy", "make_eval_step", "make_train_step",
           "sgd_momentum", "smooth_cross_entropy", "smooth_nll"]
