"""SAME 3x3x3 stride-1 convolution, forward and backward: the CUDA kernels and
their plain versions.

Replaces the Pallas TPU kernel ``vdm4cdm_tpu/ops/pallas/conv3d.py::
_fwd_kernel`` as reached through ``_conv_pallas_raw_packed`` (the packed,
bias-folding, stats-emitting entry ``conv3d_pallas_packed_bs``). The kernel is
``csrc/conv3d_fwd.cu``: an implicit GEMM (M = voxels, N = Cout, K = 27 * Cin)
with wrap or zero index math in its gather, bf16 on the tensor cores through
``mma.sync`` and f32 on FMAs, f32 accumulation, bias and an optional residual
added before the cast, and optional per-(batch, channel) sums (sum y, sum y^2)
of the f32 pre-cast output. On the H100 the tensor cores bound it at the
flagship widths (hundreds of operations per byte moved); its shared-memory
tiles keep the 27 tap re-reads of each input voxel in L2 and out of device
memory. The source file says more.

The plain version computes the same function with ``torch.nn.functional.
conv3d`` in f32. CPU tensors go to it; CUDA tensors go to the kernel.

The backward has two parts. The input gradient is the forward kernel again
(:func:`conv3d_k3s1_dx`): the same conv of the output gradient with the
weights flipped in space and transposed in (Cin, Cout), under the same padding
mode, as the TPU package runs ``_conv_pallas_raw_packed`` on ``ct``. The
weight and bias gradients are ``conv3d_k3s1_dw``, the kernel
``csrc/conv3d_dw.cu``, which replaces the Pallas ``_dw_kernel`` (reached
through ``_conv_pallas_dw``): per tap a GEMM with the voxels as the
contraction, split over blocks that add their f32 tiles with atomics (the sum
order is run-dependent), bf16 on the tensor cores and f32 on FMAs. Its plain
version is 27 shifted matrix products in f32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._common import (DTYPE_CODE, check_aligned, check_forward_only,
                      check_operand, on_cuda)


def supports(cin: int, cout: int) -> bool:
    """Channel counts the kernel takes: multiples of 8 (16-byte vectors)."""
    return cin >= 8 and cout >= 8 and cin % 8 == 0 and cout % 8 == 0


def conv3d_k3s1_plain(x, w, bias=None, residual=None, circular=False,
                      with_sums=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_fwd` (same arguments)."""
    xf = x.float().permute(0, 4, 1, 2, 3)
    # the weights take x's dtype first, as the kernel (and JAX's conv_nd)
    # multiply in it
    wf = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)
    if circular:
        y = F.conv3d(F.pad(xf, (1,) * 6, mode="circular"), wf)
    else:
        y = F.conv3d(xf, wf, padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    sums = None
    if with_sums:
        sums = torch.stack([y.sum((1, 2, 3)), (y * y).sum((1, 2, 3))], 1)
    return y.to(x.dtype).contiguous(), sums


def conv3d_k3s1_dw_plain(x, ct, circular=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_dw` (same arguments): per
    tap, the f32 product of the shifted, padded x with ct over all voxels."""
    B, D, H, W, cin = x.shape
    xp = F.pad(x.float().permute(0, 4, 1, 2, 3), (1,) * 6,
               mode="circular" if circular else "constant")
    xp = xp.permute(0, 2, 3, 4, 1)
    ctf = ct.float().reshape(-1, ct.shape[-1])
    taps = [xp[:, kz:kz + D, ky:ky + H, kx:kx + W].reshape(-1, cin).T @ ctf
            for kz in range(3) for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, cin, -1), ctf.sum(0)


def _fn(source, name, n_ptrs, n_ints):
    from ._build import c_function

    p, i = ctypes.c_void_p, ctypes.c_int
    return c_function(source, name, [i] + [p] * n_ptrs + [i] * n_ints + [p])


def conv3d_k3s1_fwd(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    circular: bool = False,
    with_sums: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """y = conv(x, w) + bias + residual with SAME k3 s1 padding (circular or
    zeros on every spatial dim). x (B, D, H, W, Cin) f32 or bf16, w
    (3, 3, 3, Cin, Cout) (cast to x's dtype), bias (Cout,) (added in f32),
    residual (B, D, H, W, Cout) in x's dtype. Returns (y in x's dtype, sums)
    where sums is the (B, 2, Cout) f32 (sum y, sum y^2) of the f32 value
    before the cast, or None without ``with_sums``. Forward only."""
    check_operand("x", x, 5)
    B, D, H, W, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, 3) or w.ndim != 5 or w.shape[3] != cin:
        raise ValueError(f"w shape {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    cout = w.shape[4]
    if not supports(cin, cout):
        raise ValueError(f"channels {cin}->{cout}: need multiples of 8")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({cout},)")
    if residual is not None:
        check_operand("residual", residual, 5, (x.dtype,), x.device)
        if tuple(residual.shape) != (B, D, H, W, cout):
            raise ValueError(f"residual shape {tuple(residual.shape)}")
    check_forward_only("conv3d_k3s1_fwd", x, w, bias, residual)
    if not on_cuda("conv3d_k3s1_fwd", x):
        return conv3d_k3s1_plain(x, w, bias, residual, circular, with_sums)

    dev = x.device
    for name, t in (("w", w), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    wt = w.to(x.dtype).permute(0, 1, 2, 4, 3).reshape(27, cout, cin)
    wt = wt.contiguous()
    bias_f = bias.float().contiguous() if bias is not None else None
    out = torch.empty((B, D, H, W, cout), dtype=x.dtype, device=dev)
    sums = (torch.zeros((B, 2, cout), dtype=torch.float32, device=dev)
            if with_sums else None)
    operands = (x, wt, bias_f, residual, out, sums)
    check_aligned("conv3d_k3s1_fwd", *operands)
    ptrs = [t.data_ptr() if t is not None else None for t in operands]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("conv3d_fwd.cu", "conv3d_k3s1_fwd", 6, 7)(
        DTYPE_CODE[x.dtype], *ptrs, B, D, H, W, cin, cout,
        int(bool(circular)), stream)
    if err:
        raise RuntimeError(f"conv3d_k3s1_fwd: CUDA error {err} at launch")
    conv3d_k3s1_fwd.launches += 1
    return out, sums


def conv3d_k3s1_dx(ct: torch.Tensor, w: torch.Tensor,
                   circular: bool = False) -> torch.Tensor:
    """The input gradient of y = conv(x, w): the forward kernel on the output
    gradient ct (B, D, H, W, Cout) with w (3, 3, 3, Cin, Cout) flipped in
    space and transposed, same padding mode. Returns (B, D, H, W, Cin) in
    ct's dtype. Counts as a launch of ``conv3d_k3s1_fwd``."""
    w_t = w.flip(0, 1, 2).transpose(3, 4)
    return conv3d_k3s1_fwd(ct, w_t, circular=circular)[0]


def conv3d_k3s1_dw(x: torch.Tensor, ct: torch.Tensor,
                   circular: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db) of y = conv(x, w) + b with SAME k3 s1 padding: x
    (B, D, H, W, Cin) and the output gradient ct (B, D, H, W, Cout) in one
    dtype, f32 or bf16. Returns dw (3, 3, 3, Cin, Cout) and db (Cout,), both
    f32. No autograd of its own."""
    check_operand("x", x, 5)
    check_operand("ct", ct, 5, (x.dtype,), x.device)
    if ct.shape[:4] != x.shape[:4]:
        raise ValueError(f"ct shape {tuple(ct.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    B, D, H, W, cin = x.shape
    cout = ct.shape[4]
    if not supports(cin, cout):
        raise ValueError(f"channels {cin}->{cout}: need multiples of 8")
    check_forward_only("conv3d_k3s1_dw", x, ct)
    if not on_cuda("conv3d_k3s1_dw", x):
        return conv3d_k3s1_dw_plain(x, ct, circular)
    dw = torch.zeros((3, 3, 3, cin, cout), dtype=torch.float32,
                     device=x.device)
    db = torch.zeros((cout,), dtype=torch.float32, device=x.device)
    check_aligned("conv3d_k3s1_dw", x, ct, dw, db)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn("conv3d_dw.cu", "conv3d_k3s1_dw", 4, 7)(
        DTYPE_CODE[x.dtype], x.data_ptr(), ct.data_ptr(), dw.data_ptr(),
        db.data_ptr(), B, D, H, W, cin, cout, int(bool(circular)), stream)
    if err:
        raise RuntimeError(f"conv3d_k3s1_dw: CUDA error {err} at launch")
    conv3d_k3s1_dw.launches += 1
    return dw, db


conv3d_k3s1_fwd.launches = 0
conv3d_k3s1_dw.launches = 0
