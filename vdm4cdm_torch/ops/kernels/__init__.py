"""Hand-written CUDA/Triton kernels of the port, each beside its plain
PyTorch version. CPU tensors take the plain version; CUDA tensors take the
kernel. Each wrapper counts its launches in ``<wrapper>.launches``."""

from .conv3d import (conv3d_k3s1_dw, conv3d_k3s1_dw_plain, conv3d_k3s1_dx,
                     conv3d_k3s1_fwd, conv3d_k3s1_plain)
from .fused_norm import (gn_apply, gn_apply_plain, gn_bwd_apply,
                         gn_bwd_apply_plain, gn_bwd_sums, gn_bwd_sums_plain,
                         gn_sums, gn_sums_plain)

KERNELS = (conv3d_k3s1_fwd, conv3d_k3s1_dw, gn_sums, gn_apply, gn_bwd_sums,
           gn_bwd_apply)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS", "conv3d_k3s1_dw", "conv3d_k3s1_dw_plain", "conv3d_k3s1_dx",
    "conv3d_k3s1_fwd", "conv3d_k3s1_plain", "gn_apply", "gn_apply_plain",
    "gn_bwd_apply", "gn_bwd_apply_plain", "gn_bwd_sums", "gn_bwd_sums_plain",
    "gn_sums", "gn_sums_plain", "launch_counts", "reset_launch_counts",
]
