"""vdm4cdm_torch: the PyTorch/CUDA port of vdm4cdm_tpu.

The JAX package stays the reference. This package imports neither jax nor
vdm4cdm_tpu; its hot operations are hand-written kernels for the NVIDIA H100
(``ops/kernels``), each beside a plain PyTorch version that CPU tensors take.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .config import ExperimentConfig, build_datamodule, build_model
from .diffusion import VDM, VDMLosses, ddnm_sample, make_schedule
from .flows import SFM, SFMLosses
from .interop import (opt_state_from_jax, params_from_jax,
                      params_from_torch, strip_and_rename)
from .models import CUNet
from .presets import PRESETS, preset
from .train import (TrainConfig, Trainer, TrainState, init_ema,
                    make_eval_step, make_lr_schedule, make_optimizer,
                    make_train_step)

__all__ = ["CUNet", "ExperimentConfig", "PRESETS", "SFM", "SFMLosses",
           "TrainConfig", "TrainState", "Trainer", "VDM", "VDMLosses",
           "build_datamodule", "build_model", "ddnm_sample",
           "init_ema", "make_eval_step", "make_lr_schedule", "make_optimizer",
           "make_schedule", "make_train_step", "opt_state_from_jax",
           "params_from_jax", "params_from_torch", "preset",
           "strip_and_rename"]
