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
and reads each operand once. In bf16 up to 256 channels it runs persistent
CTAs that hold the whole weight in shared memory and stream row tiles
through a ring of stages (:func:`fwd_plan` mirrors its launch plan); the
weight is read as it lies, (K, N) or, with ``w_transposed``, (N, K), f32 or
bf16, so neither the forward nor the dx pass copies it. The weight gradient
splits the rows over blocks that join their f32 tiles with atomics (the sum
order is run-dependent), with the bias gradient riding along. The source
file says more.

The plain versions compute the same functions with matrix products in f32.
CPU tensors go to them; CUDA tensors go to the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ._common import (DTYPE_CODE, check_aligned, check_forward_only,
                      check_operand, on_cuda)
from .conv3d import supports

__all__ = ["FwdPlan", "compiled_plan", "fwd_plan", "mm1x1_dw",
           "mm1x1_dw_plain", "mm1x1_dx", "mm1x1_fwd", "mm1x1_plain",
           "supports"]


def mm1x1_plain(x, w, bias=None, residual=None, w_transposed=False):
    """Plain PyTorch version of :func:`mm1x1_fwd` (same arguments)."""
    if w_transposed:
        w = w.t()
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


# ------------------------------------------------------------ launch plan
# The rules of csrc/lanemm.cu (``make_fwd_plan``), field for field.

SMEM_SM = 233472        # shared memory of an SM (H100)
SMEM_CTA = 232448       # the most a CTA may use
SMEM_RESERVED = 1024    # the card's own share of each CTA
SMS = 132               # the H100 SXM's streaming multiprocessors
THREADS = 256
ROWS_WIDE = 128         # kind 0: rows a block
TC_MAX = 256            # kind 1 takes bf16 with K, N up to this


class FwdPlan(NamedTuple):
    """``mm1x1_fwd``'s launch. Kind 1 (bf16, K and N up to 256): ``grid``
    persistent CTAs (``ctas_per_sm`` an SM) walk the row tiles of ``bm``
    rows, CTA c taking tiles c, c + grid, ...; ``kp`` and ``np`` are K and N
    padded to 32, 64, 128 or 256; ``stages`` tiles in the ring; ``smem`` the
    dynamic shared memory of a CTA. Kind 0 (f32, wider widths): one block
    for each of ``grid`` = row tiles x N tiles, ``kp`` the K chunk, ``np``
    the N tile."""
    kind: int
    bm: int
    kp: int
    np: int
    stages: int
    ctas_per_sm: int
    grid: int
    threads: int
    smem: int


def _pad_width(v: int) -> int:
    p = 32
    while p < v:
        p *= 2
    return p


def fwd_plan(dtype, R: int, K: int, N: int, has_res: bool,
             sms: int = SMS) -> FwdPlan:
    """The forward kernel's plan for x (R, K) -> (R, N), with or without a
    residual, on a card of ``sms`` SMs."""
    if dtype == torch.bfloat16 and K <= TC_MAX and N <= TC_MAX:
        kp, np_ = _pad_width(K), _pad_width(N)
        wn = np_ // 64 if np_ > 64 else 1  # warps across N, 16 rows each
        bm = 16 * (8 // wn)
        stage = bm * kp * 2 + (bm * np_ * 2 if has_res else 0)
        fixed = np_ * kp * 2 + np_ * 4 + bm * np_ * 2
        per_sm, s = 2, 4
        while s > 2 and per_sm * (fixed + s * stage + SMEM_RESERVED) > SMEM_SM:
            s -= 1
        if per_sm * (fixed + s * stage + SMEM_RESERVED) > SMEM_SM:
            per_sm, s = 1, 4
            while s > 2 and fixed + s * stage > SMEM_CTA:
                s -= 1
        grid = min(math.ceil(R / bm), sms * per_sm)
        return FwdPlan(1, bm, kp, np_, s, per_sm, grid, THREADS,
                       fixed + s * stage)
    bk = 32 if dtype == torch.bfloat16 else 16
    bn = 32 if N <= 32 else 64
    tiles = math.ceil(R / ROWS_WIDE) * math.ceil(N / bn)
    return FwdPlan(0, ROWS_WIDE, bk, bn, 2, 0,
                   tiles if tiles <= 0x7FFFFFFF else -1, THREADS, 0)


def compiled_plan(dtype, R: int, K: int, N: int, has_res: bool) -> FwdPlan:
    """The plan as the compiled source reports it for this card; on the
    machine with the card."""
    buf = (ctypes.c_int * len(FwdPlan._fields))()
    i = ctypes.c_int
    fn = _fn("mm1x1_fwd_plan", [i, ctypes.c_longlong, i, i, i, i,
                                ctypes.c_void_p])
    err = fn(DTYPE_CODE[dtype], R, K, N, int(bool(has_res)), 0,
             ctypes.addressof(buf))
    if err:
        raise RuntimeError(f"mm1x1_fwd_plan: CUDA error {err}")
    return FwdPlan(*buf)


def mm1x1_fwd(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    w_transposed: bool = False,
) -> torch.Tensor:
    """y = x @ w + bias + residual over the last axis. x (..., K) f32 or
    bf16, w (K, N), or with ``w_transposed`` (N, K) and y = x @ w.T, f32 or
    bf16 (rounded to x's dtype), bias (N,) (added in f32), residual (..., N)
    in x's dtype. f32 accumulation and one rounding to x's dtype. Returns
    (..., N). The kernel reads w where it lies: it must be contiguous.
    Forward only."""
    check_operand("x", x, None)
    K = x.shape[-1]
    if w.ndim != 2 or w.shape[1 if w_transposed else 0] != K:
        raise ValueError(f"w shape {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}"
                         + (" (transposed)" if w_transposed else ""))
    N = w.shape[0 if w_transposed else 1]
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
        return mm1x1_plain(x, w, bias, residual, w_transposed)

    check_operand("w", w, 2, device=x.device)
    if bias is not None and bias.device != x.device:
        raise ValueError(f"bias is on {bias.device}, x on {x.device}")
    bias_f = bias.float().contiguous() if bias is not None else None
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    R = x.numel() // K
    if R == 0:
        return out
    operands = (x, w, bias_f, residual, out)
    check_aligned("mm1x1_fwd", *operands)
    px, pw, pb, pr, po = (t.data_ptr() if t is not None else None
                          for t in operands)
    p, i = ctypes.c_void_p, ctypes.c_int
    err = _fn("mm1x1_fwd", [i, p, p, i, i, p, p, p, ctypes.c_longlong, i, i,
                            p])(
        DTYPE_CODE[x.dtype], px, pw, int(w.dtype == torch.float32),
        int(bool(w_transposed)), pb, pr, po, R, K, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mm1x1_fwd: CUDA error {err} at launch")
    mm1x1_fwd.launches += 1
    return out


def mm1x1_dx(ct: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient of y = x @ w: the forward kernel on the output
    gradient ct (..., N) with w (K, N) read transposed (no copy) and no
    bias. Returns (..., K) in ct's dtype. Counts as a launch of
    ``mm1x1_fwd``."""
    return mm1x1_fwd(ct, w, w_transposed=True)


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
