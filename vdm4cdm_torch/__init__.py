"""vdm4cdm_torch: the PyTorch/CUDA port of vdm4cdm_tpu.

The JAX package stays the reference. This package imports neither jax nor
vdm4cdm_tpu; its hot operations are hand-written kernels for the NVIDIA H100
(``ops/kernels``), each beside a plain PyTorch version that CPU tensors take.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .diffusion import VDM, VDMLosses, make_schedule
from .interop import opt_state_from_jax, params_from_jax
from .models import CUNet
from .train import (TrainState, init_ema, make_eval_step, make_lr_schedule,
                    make_optimizer, make_train_step)

__all__ = ["CUNet", "TrainState", "VDM", "VDMLosses", "init_ema",
           "make_eval_step", "make_lr_schedule", "make_optimizer",
           "make_schedule", "make_train_step", "opt_state_from_jax",
           "params_from_jax"]
