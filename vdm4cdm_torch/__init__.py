"""vdm4cdm_torch: the PyTorch/CUDA port of vdm4cdm_tpu.

The JAX package stays the reference. This package imports neither jax nor
vdm4cdm_tpu; its hot operations are hand-written kernels for the NVIDIA H100
(``ops/kernels``), each beside a plain PyTorch version that CPU tensors take.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .diffusion import VDM, make_schedule
from .interop import params_from_jax
from .models import CUNet

__all__ = ["CUNet", "VDM", "make_schedule", "params_from_jax"]
