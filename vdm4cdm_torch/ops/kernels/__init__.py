"""Hand-written CUDA/Triton kernels of the port, each beside its plain
PyTorch version. CPU tensors take the plain version; CUDA tensors take the
kernel. Each wrapper counts its launches in ``<wrapper>.launches``."""

from .conv3d import (conv3d_k3s1_dw, conv3d_k3s1_dw_plain, conv3d_k3s1_dx,
                     conv3d_k3s1_fwd, conv3d_k3s1_plain)
from .fused_norm import (gn_apply, gn_apply_plain, gn_bwd_apply,
                         gn_bwd_apply_plain, gn_bwd_sums, gn_bwd_sums_plain,
                         gn_sums, gn_sums_plain)
from .lanemm import (mm1x1_dw, mm1x1_dw_plain, mm1x1_dx, mm1x1_fwd,
                     mm1x1_plain)

KERNELS = (conv3d_k3s1_fwd, conv3d_k3s1_dw, gn_sums, gn_apply, gn_bwd_sums,
           gn_bwd_apply, mm1x1_fwd, mm1x1_dw)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS", "conv3d_k3s1_dw", "conv3d_k3s1_dw_plain", "conv3d_k3s1_dx",
    "conv3d_k3s1_fwd", "conv3d_k3s1_plain", "gn_apply", "gn_apply_plain",
    "gn_bwd_apply", "gn_bwd_apply_plain", "gn_bwd_sums", "gn_bwd_sums_plain",
    "gn_sums", "gn_sums_plain", "launch_counts", "mm1x1_dw", "mm1x1_dw_plain",
    "mm1x1_dx", "mm1x1_fwd", "mm1x1_plain", "reset_launch_counts",
]
