from .checkpoint import CheckpointManager, JaxCheckpointError, load_params
from .loop import TrainConfig, Trainer
from .state import (Optimizer, TrainState, init_ema, make_lr_schedule,
                    make_optimizer)
from .step import make_eval_step, make_train_step

__all__ = ["CheckpointManager", "JaxCheckpointError", "Optimizer",
           "TrainConfig", "TrainState", "Trainer", "init_ema", "load_params",
           "make_eval_step", "make_lr_schedule", "make_optimizer",
           "make_train_step"]
