"""Training layer of the port (counterpart of ``deltaconv_tpu/training``):
losses, metrics, train state and optimizers, train and eval steps, the
fit loop and the evaluations, checkpoints and logging (the augmentations
are in ``transforms.augment``)."""

from .checkpoint import (latest_step, load_state_dict_file, restore_any,
                         restore_checkpoint, save_checkpoint)
from .logging import MetricsLogger, make_run_dir
from .loop import (FitConfig, evaluate_classification, evaluate_segmentation,
                   evaluate_voting, fit)
from .losses import cross_entropy, smooth_cross_entropy, smooth_nll
from .metrics import accuracy, balanced_accuracy, shape_iou
from .steps import make_eval_step, make_train_step
from .train_state import (TrainState, adam_steplr, cosine_epoch_schedule,
                          create_train_state, sgd_momentum)

__all__ = ["FitConfig", "MetricsLogger", "TrainState", "accuracy",
           "adam_steplr", "balanced_accuracy", "cosine_epoch_schedule",
           "create_train_state", "cross_entropy", "evaluate_classification",
           "evaluate_segmentation", "evaluate_voting", "fit", "latest_step",
           "load_state_dict_file", "make_eval_step", "make_run_dir",
           "make_train_step", "restore_any", "restore_checkpoint",
           "save_checkpoint", "sgd_momentum", "shape_iou",
           "smooth_cross_entropy", "smooth_nll"]
