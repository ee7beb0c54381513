"""The 1x1 projection over voxel rows (the ResBlock's ``skip_proj``), forward
and backward: the CUDA kernels and their plain versions.

Replaces the Pallas TPU kernels of ``vdm4cdm_tpu/ops/pallas/lanemm.py``:
``_fwd_kernel`` (reached through ``_run_fwd``; also the dx pass, on the
transposed weight) and ``_dw_kernel`` (reached through ``_run_dw``). This file
keeps that module's name so that a reader finds the counterpart; **nothing in
it has lanes**. The TPU kernels work on lane-packed rows with a block-diagonal
weight and a tiled bias, in scope only for widths that are multiples of 128.
Here rows are plain channels-last voxels: x is (..., K) read as (R, K), the
weight is the plain (K, N) matrix, and any K, N that are multiples of 8 are in
scope (16-byte vectors), as for the 3x3x3 conv.

The kernels are ``csrc/lanemm.cu``. Every site is bound by bytes on the H100
(at most 128 operations per byte moved, under the card's ~295), so the
forward folds the bias, an optional residual (the first half's output of a
split pair projection) and the one rounding to x's dtype into its epilogue,
and reads each operand once; the weight gradient splits the rows over blocks
that join their f32 tiles with atomics (the sum order is run-dependent), with
the bias gradient riding along. The source file says more.

The plain versions compute the same functions with matrix products in f32.
CPU tensors go to them; CUDA tensors go to the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._common import (DTYPE_CODE, check_aligned, check_forward_only,
                      check_operand, on_cuda)
from .conv3d import supports

__all__ = ["mm1x1_dw", "mm1x1_dw_plain", "mm1x1_dx", "mm1x1_fwd",
           "mm1x1_plain", "supports"]


def mm1x1_plain(x, w, bias=None, residual=None):
    """Plain PyTorch version of :func:`mm1x1_fwd` (same arguments)."""
    # the weight takes x's dtype first, as the kernel multiplies in it
    y = x.float() @ w.to(x.dtype).float()
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype).contiguous()


def mm1x1_dw_plain(x, ct):
    """Plain PyTorch version of :func:`mm1x1_dw` (same arguments)."""
    xf = x.float().reshape(-1, x.shape[-1])
    ctf = ct.float().reshape(-1, ct.shape[-1])
    return xf.T @ ctf, ctf.sum(0)


def _fn(name, argtypes):
    from ._build import c_function

    return c_function("lanemm.cu", name, argtypes)


def mm1x1_fwd(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = x @ w + bias + residual over the last axis. x (..., K) f32 or
    bf16, w (K, N) (cast to x's dtype), bias (N,) (added in f32), residual
    (..., N) in x's dtype. f32 accumulation and one rounding to x's dtype.
    Returns (..., N). Forward only."""
    check_operand("x", x, None)
    K = x.shape[-1]
    if w.ndim != 2 or w.shape[0] != K:
        raise ValueError(f"w shape {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    N = w.shape[1]
    if not supports(K, N):
        raise ValueError(f"channels {K}->{N}: need multiples of 8")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({N},)")
    out_shape = tuple(x.shape[:-1]) + (N,)
    if residual is not None:
        check_operand("residual", residual, None, (x.dtype,), x.device)
        if tuple(residual.shape) != out_shape:
            raise ValueError(f"residual shape {tuple(residual.shape)} != "
                             f"{out_shape}")
    check_forward_only("mm1x1_fwd", x, w, bias, residual)
    if not on_cuda("mm1x1_fwd", x):
        return mm1x1_plain(x, w, bias, residual)

    dev = x.device
    for name, t in (("w", w), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    # (N, K) in x's dtype, so that both tiles are K-minor: the cast and the
    # transpose in one copy
    wt = torch.empty((N, K), dtype=x.dtype, device=dev).copy_(w.t())
    bias_f = bias.float().contiguous() if bias is not None else None
    out = torch.empty(out_shape, dtype=x.dtype, device=dev)
    R = x.numel() // K
    if R == 0:
        return out
    operands = (x, wt, bias_f, residual, out)
    check_aligned("mm1x1_fwd", *operands)
    ptrs = [t.data_ptr() if t is not None else None for t in operands]
    p, i = ctypes.c_void_p, ctypes.c_int
    err = _fn("mm1x1_fwd", [i, p, p, p, p, p, ctypes.c_longlong, i, i, p])(
        DTYPE_CODE[x.dtype], *ptrs, R, K, N,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mm1x1_fwd: CUDA error {err} at launch")
    mm1x1_fwd.launches += 1
    return out


def mm1x1_dx(ct: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient of y = x @ w: the forward kernel on the output
    gradient ct (..., N) with w (K, N) transposed and no bias. Returns
    (..., K) in ct's dtype. Counts as a launch of ``mm1x1_fwd``."""
    return mm1x1_fwd(ct, w.t())


def mm1x1_dw(x: torch.Tensor, ct: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db) of y = x @ w + b: x (..., K) and the output gradient ct
    (..., N) in one dtype, f32 or bf16. Returns dw (K, N) and db (N,), both
    f32. No autograd of its own."""
    check_operand("x", x, None)
    check_operand("ct", ct, None, (x.dtype,), x.device)
    if ct.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"ct shape {tuple(ct.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    K, N = x.shape[-1], ct.shape[-1]
    if not supports(K, N):
        raise ValueError(f"channels {K}->{N}: need multiples of 8")
    check_forward_only("mm1x1_dw", x, ct)
    if not on_cuda("mm1x1_dw", x):
        return mm1x1_dw_plain(x, ct)
    dw = torch.zeros((K, N), dtype=torch.float32, device=x.device)
    db = torch.zeros((N,), dtype=torch.float32, device=x.device)
    R = x.numel() // K
    if R == 0:
        return dw, db
    check_aligned("mm1x1_dw", x, ct, dw, db)
    p, i = ctypes.c_void_p, ctypes.c_int
    err = _fn("mm1x1_dw", [i, p, p, p, p, ctypes.c_longlong, i, i, p])(
        DTYPE_CODE[x.dtype], x.data_ptr(), ct.data_ptr(), dw.data_ptr(),
        db.data_ptr(), R, K, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mm1x1_dw: CUDA error {err} at launch")
    mm1x1_dw.launches += 1
    return dw, db


mm1x1_fwd.launches = 0
mm1x1_dw.launches = 0
