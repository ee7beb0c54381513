"""Hand-written CUDA/Triton kernels of the port, each beside its plain
PyTorch version. CPU tensors take the plain version; CUDA tensors take the
kernel. Each wrapper counts its launches in ``<wrapper>.launches``; the
wrappers whose call may launch more than one CUDA kernel (the conv forward:
its f32 path, and the fold of its GroupNorm sums) count those in
``<wrapper>.cuda_launches`` too."""

from .conv3d import (conv3d_k3s1_dw, conv3d_k3s1_dw_plain, conv3d_k3s1_dx,
                     conv3d_k3s1_fwd, conv3d_k3s1_plain, conv3d_k3s1_zhalo_dw,
                     conv3d_k3s1_zhalo_dw_plain, conv3d_k3s1_zhalo_dx,
                     conv3d_k3s1_zhalo_dx_plain, conv3d_k3s1_zhalo_fwd,
                     conv3d_k3s1_zhalo_plain)
from .fused_norm import (gn_apply, gn_apply_plain, gn_bwd_apply,
                         gn_bwd_apply_plain, gn_bwd_sums, gn_bwd_sums_plain,
                         gn_sums, gn_sums_plain)
from .lanemm import (mm1x1_dw, mm1x1_dw_plain, mm1x1_dx, mm1x1_fwd,
                     mm1x1_plain)

KERNELS = (conv3d_k3s1_fwd, conv3d_k3s1_dw, gn_sums, gn_apply, gn_bwd_sums,
           gn_bwd_apply, mm1x1_fwd, mm1x1_dw, conv3d_k3s1_zhalo_fwd,
           conv3d_k3s1_zhalo_dx, conv3d_k3s1_zhalo_dw)
MULTI_LAUNCH = (conv3d_k3s1_fwd, conv3d_k3s1_zhalo_fwd, conv3d_k3s1_zhalo_dx)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in MULTI_LAUNCH:
        k.cuda_launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def cuda_launch_counts() -> dict:
    """The CUDA kernels launched by the wrappers of ``MULTI_LAUNCH``."""
    return {k.__name__: k.cuda_launches for k in MULTI_LAUNCH}


__all__ = [
    "KERNELS", "MULTI_LAUNCH", "conv3d_k3s1_dw", "conv3d_k3s1_dw_plain",
    "conv3d_k3s1_dx", "conv3d_k3s1_fwd", "conv3d_k3s1_plain",
    "conv3d_k3s1_zhalo_dw", "conv3d_k3s1_zhalo_dw_plain",
    "conv3d_k3s1_zhalo_dx", "conv3d_k3s1_zhalo_dx_plain",
    "conv3d_k3s1_zhalo_fwd", "conv3d_k3s1_zhalo_plain", "cuda_launch_counts",
    "gn_apply", "gn_apply_plain", "gn_bwd_apply", "gn_bwd_apply_plain",
    "gn_bwd_sums", "gn_bwd_sums_plain", "gn_sums", "gn_sums_plain",
    "launch_counts", "mm1x1_dw", "mm1x1_dw_plain", "mm1x1_dx", "mm1x1_fwd",
    "mm1x1_plain", "reset_launch_counts",
]
