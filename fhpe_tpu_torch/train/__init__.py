"""Training on one device: losses, optimizer and LR schedule, and the
train / FPD / eval steps (counterpart of ``fhpe_tpu.train``)."""

from .state import (TrainState, create_train_state, lr_for_epoch,
                    make_optimizer, set_lr)
from .step import (make_batch_preprocessor, make_eval_step,
                   make_fpd_train_step, make_train_step)

__all__ = ["TrainState", "create_train_state", "lr_for_epoch",
           "make_optimizer", "set_lr", "make_batch_preprocessor",
           "make_eval_step", "make_fpd_train_step", "make_train_step"]
