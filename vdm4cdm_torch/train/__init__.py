from .state import (Optimizer, TrainState, init_ema, make_lr_schedule,
                    make_optimizer)
from .step import make_eval_step, make_train_step

__all__ = ["Optimizer", "TrainState", "init_ema", "make_eval_step",
           "make_lr_schedule", "make_optimizer", "make_train_step"]
