"""GroupNorm's two streaming passes: the Triton kernels and their plain
versions.

The TPU package runs GroupNorm + affine + SiLU (+ dropout) as Pallas kernels
in ``vdm4cdm_tpu/ops/pallas/fused_norm.py``: the two-sweep monolith
``_fwd_kernel`` (stats sweep, then apply sweep, on the TPU's sequential grid)
and the split pair ``_sums_kernel`` / ``_apply_kernel`` used with external or
joint statistics. A GPU has no sequential grid, so here every site is

    gn_sums  -> a tiny finalize on (B, 2, C) in torch -> gn_apply

``gn_sums`` replaces ``_sums_kernel`` and sweep 0 of ``_fwd_kernel``: per
(batch, channel) (sum x, sum x^2) in f32 over all voxels of a channels-last
(B, S, C) stream. Each program reduces a run of rows in registers and adds its
partial to the output with one atomic per channel, so the sum order changes
from run to run (f32 rounding of a sum over S terms).

``gn_apply`` replaces ``_apply_kernel`` and sweep 1 of ``_fwd_kernel``:
``y = dropout(act(x * A[b, c] + Bv[b, c]))`` in f32 with y in x's dtype, where
A and Bv fold the mean, the inverse deviation, gamma/beta and FiLM. Dropout
keeps element i iff ``philox.keep(seed, i, p)`` and scales it by 1 / (1 - p).

The backward is the same split. ``gn_bwd_sums`` replaces ``_bwd_sums_kernel``
and sweep 0 of the monolith ``_bwd_kernel``: per (batch, channel)
(sum dy, sum dy * xhat), where xhat = (x - mean) * inv and dy is the incoming
gradient taken back through the dropout mask (regenerated from the seed, never
stored) and SiLU' (recomputed from xhat * a + b). A finalize on (B, 2, C) in
torch gives da, db and the group means m1, m2; ``gn_bwd_apply`` replaces
``_bwd_apply_kernel`` and sweep 1: dx = inv * (dy * a - m1 - xhat * m2) in x's
dtype. Both share one device function, the port of ``_recompute_dy_xhat``.

All four are bound by device memory on the H100 (a few operations per byte,
about 25 more integer operations an element with dropout, one Philox call
per four channels): the sums read x once, the
apply reads x once and writes y once, the backward passes read x and the
incoming gradient once each (and write dx once), each with contiguous row
blocks so that loads are wide and coalesced.

CPU tensors go to the plain versions; CUDA tensors go to the kernels.
``triton`` is imported only when a kernel is first launched.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import philox
from ._common import check_forward_only, check_operand, on_cuda

# elements of x per program block (power of two); the apply pass takes 4096:
# with dropout on, 8192 (64 elements a thread) ran far slower on the H100
_BLOCK_ELEMS_SUMS = 4096
_BLOCK_ELEMS_APPLY = 4096
_BLOCK_ELEMS_BWD_SUMS = 2048
_BLOCK_ELEMS_BWD_APPLY = 4096
# target number of programs per batch element for the sums reduction
_SUMS_PROGRAMS = 1024


def gn_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, S, C) -> (B, 2, C) f32 (sum x, sum x^2) over S."""
    xf = x.float()
    return torch.stack([xf.sum(1), (xf * xf).sum(1)], 1)


def gn_apply_plain(x: torch.Tensor, a: torch.Tensor, bv: torch.Tensor,
                   silu: bool, dropout_p: float = 0.0,
                   seed: int = 0) -> torch.Tensor:
    """(B, S, C) -> dropout(act(x * a + bv)) in x's dtype; a, bv (B, C)
    f32."""
    y = x.float() * a[:, None, :] + bv[:, None, :]
    if silu:
        y = F.silu(y)
    if dropout_p > 0.0:
        keep = philox.keep_mask_plain(seed, x.shape, dropout_p, x.device)
        y = torch.where(keep, y * (1.0 / (1.0 - dropout_p)), 0.0)
    return y.to(x.dtype)


def _dy_xhat_plain(x, ct, mean, inv, a, b, silu, dropout_p, seed):
    xhat = (x.float() - mean[:, None, :]) * inv[:, None, :]
    dy = ct.float()
    if dropout_p > 0.0:
        keep = philox.keep_mask_plain(seed, x.shape, dropout_p, x.device)
        dy = torch.where(keep, dy * (1.0 / (1.0 - dropout_p)), 0.0)
    if silu:
        y = xhat * a[:, None, :] + b[:, None, :]
        s = torch.sigmoid(y)
        dy = dy * (s * (1.0 + y * (1.0 - s)))
    return dy, xhat


def gn_bwd_sums_plain(x, ct, mean, inv, a, b, silu, dropout_p=0.0, seed=0):
    """(B, S, C) x and ct -> (B, 2, C) f32 (sum dy, sum dy * xhat) over S."""
    dy, xhat = _dy_xhat_plain(x, ct, mean, inv, a, b, silu, dropout_p, seed)
    return torch.stack([dy.sum(1), (dy * xhat).sum(1)], 1)


def gn_bwd_apply_plain(x, ct, mean, inv, a, b, m1, m2, silu, dropout_p=0.0,
                       seed=0):
    """dx = inv * (dy * a - m1 - xhat * m2) in x's dtype."""
    dy, xhat = _dy_xhat_plain(x, ct, mean, inv, a, b, silu, dropout_p, seed)
    dx = inv[:, None, :] * (dy * a[:, None, :] - m1[:, None, :]
                            - xhat * m2[:, None, :])
    return dx.to(x.dtype)


@functools.cache
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def sums_kernel(x_ptr, out_ptr, S, C, rows_per_prog,
                    BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        base = x_ptr + b.to(tl.int64) * S * C
        start = pid * rows_per_prog
        acc1 = tl.zeros([BLOCK_S, BLOCK_C], tl.float32)
        acc2 = tl.zeros([BLOCK_S, BLOCK_C], tl.float32)
        for r0 in range(0, rows_per_prog, BLOCK_S):
            rows = start + r0 + tl.arange(0, BLOCK_S)
            mask = (rows < S)[:, None] & cmask[None, :]
            v = tl.load(base + rows[:, None] * C + cols[None, :], mask=mask,
                        other=0.0).to(tl.float32)
            acc1 += v
            acc2 += v * v
        out = out_ptr + b * 2 * C
        tl.atomic_add(out + cols, tl.sum(acc1, axis=0), mask=cmask)
        tl.atomic_add(out + C + cols, tl.sum(acc2, axis=0), mask=cmask)

    keep_fn = philox.device_keep()
    unspecialized = ["seed_lo", "seed_hi", "thresh"]

    @triton.jit(do_not_specialize=unspecialized)
    def apply_kernel(x_ptr, a_ptr, b_ptr, y_ptr, S, C, seed_lo, seed_hi,
                     thresh, scale, SILU: tl.constexpr, DROPOUT: tl.constexpr,
                     GROUPED: tl.constexpr, BLOCK_S: tl.constexpr,
                     BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        rows = pid * BLOCK_S + tl.arange(0, BLOCK_S)
        mask = (rows < S)[:, None] & cmask[None, :]
        av = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
        bv = tl.load(b_ptr + b * C + cols, mask=cmask, other=0.0)
        row_base = b.to(tl.int64) * S * C + rows.to(tl.int64) * C
        offs = row_base[:, None] + cols[None, :]
        v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = v * av[None, :] + bv[None, :]
        if SILU:
            y = y * tl.sigmoid(y)
        if DROPOUT:
            keep = keep_fn(offs, row_base, seed_lo, seed_hi, thresh, BLOCK_S,
                           BLOCK_C, GROUPED)
            y = tl.where(keep, y * scale, 0.0)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def dy_xhat(x_ptr, ct_ptr, offs, row_base, mask, mean, inv, av, bv,
                seed_lo, seed_hi, thresh, scale, SILU: tl.constexpr,
                DROPOUT: tl.constexpr, GROUPED: tl.constexpr,
                BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        xhat = (v - mean[None, :]) * inv[None, :]
        dy = tl.load(ct_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if DROPOUT:
            keep = keep_fn(offs, row_base, seed_lo, seed_hi, thresh,
                           BLOCK_S, BLOCK_C, GROUPED)
            dy = tl.where(keep, dy * scale, 0.0)
        if SILU:
            y = xhat * av[None, :] + bv[None, :]
            sg = tl.sigmoid(y)
            dy = dy * (sg * (1.0 + y * (1.0 - sg)))
        return dy, xhat

    @triton.jit(do_not_specialize=unspecialized)
    def bwd_sums_kernel(x_ptr, ct_ptr, mean_ptr, inv_ptr, a_ptr, b_ptr,
                        out_ptr, S, C, rows_per_prog, seed_lo, seed_hi,
                        thresh, scale, SILU: tl.constexpr,
                        DROPOUT: tl.constexpr, GROUPED: tl.constexpr,
                        BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean = tl.load(mean_ptr + b * C + cols, mask=cmask, other=0.0)
        inv = tl.load(inv_ptr + b * C + cols, mask=cmask, other=0.0)
        av = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
        bv = tl.load(b_ptr + b * C + cols, mask=cmask, other=0.0)
        base = b.to(tl.int64) * S * C
        start = pid * rows_per_prog
        acc1 = tl.zeros([BLOCK_S, BLOCK_C], tl.float32)
        acc2 = tl.zeros([BLOCK_S, BLOCK_C], tl.float32)
        for r0 in range(0, rows_per_prog, BLOCK_S):
            rows = start + r0 + tl.arange(0, BLOCK_S)
            mask = (rows < S)[:, None] & cmask[None, :]
            row_base = base + rows.to(tl.int64) * C
            offs = row_base[:, None] + cols[None, :]
            dy, xhat = dy_xhat(x_ptr, ct_ptr, offs, row_base, mask, mean, inv,
                               av, bv, seed_lo, seed_hi, thresh, scale, SILU,
                               DROPOUT, GROUPED, BLOCK_S, BLOCK_C)
            dy = tl.where(mask, dy, 0.0)
            acc1 += dy
            acc2 += dy * xhat
        out = out_ptr + b * 2 * C
        tl.atomic_add(out + cols, tl.sum(acc1, axis=0), mask=cmask)
        tl.atomic_add(out + C + cols, tl.sum(acc2, axis=0), mask=cmask)

    @triton.jit(do_not_specialize=unspecialized)
    def bwd_apply_kernel(x_ptr, ct_ptr, mean_ptr, inv_ptr, a_ptr, b_ptr,
                         m1_ptr, m2_ptr, dx_ptr, S, C, seed_lo, seed_hi,
                         thresh, scale, SILU: tl.constexpr,
                         DROPOUT: tl.constexpr, GROUPED: tl.constexpr,
                         BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        rows = pid * BLOCK_S + tl.arange(0, BLOCK_S)
        mask = (rows < S)[:, None] & cmask[None, :]
        mean = tl.load(mean_ptr + b * C + cols, mask=cmask, other=0.0)
        inv = tl.load(inv_ptr + b * C + cols, mask=cmask, other=0.0)
        av = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
        bv = tl.load(b_ptr + b * C + cols, mask=cmask, other=0.0)
        m1 = tl.load(m1_ptr + b * C + cols, mask=cmask, other=0.0)
        m2 = tl.load(m2_ptr + b * C + cols, mask=cmask, other=0.0)
        row_base = b.to(tl.int64) * S * C + rows.to(tl.int64) * C
        offs = row_base[:, None] + cols[None, :]
        dy, xhat = dy_xhat(x_ptr, ct_ptr, offs, row_base, mask, mean, inv, av,
                           bv, seed_lo, seed_hi, thresh, scale, SILU, DROPOUT,
                           GROUPED, BLOCK_S, BLOCK_C)
        dx = inv[None, :] * (dy * av[None, :] - m1[None, :]
                             - xhat * m2[None, :])
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)

    return triton, sums_kernel, apply_kernel, bwd_sums_kernel, bwd_apply_kernel


def _blocks(C: int, elems: int):
    block_c = 1 << max(C - 1, 0).bit_length()
    return max(1, elems // block_c), block_c


def gn_sums(x: torch.Tensor) -> torch.Tensor:
    """Per-(batch, channel) (sum x, sum x^2): x (B, S, C) f32 or bf16 ->
    (B, 2, C) f32. Forward only."""
    check_operand("x", x, 3)
    check_forward_only("gn_sums", x)
    if not on_cuda("gn_sums", x):
        return gn_sums_plain(x)
    triton, sums_kernel = _kernels()[:2]
    B, S, C = x.shape
    block_s, block_c = _blocks(C, _BLOCK_ELEMS_SUMS)
    iters = triton.cdiv(triton.cdiv(S, block_s), _SUMS_PROGRAMS)
    rows_per_prog = block_s * iters
    out = torch.zeros((B, 2, C), dtype=torch.float32, device=x.device)
    grid = (triton.cdiv(S, rows_per_prog), B)
    sums_kernel[grid](x, out, S, C, rows_per_prog, BLOCK_S=block_s,
                      BLOCK_C=block_c, num_warps=4)
    gn_sums.launches += 1
    return out


def _dropout_args(name: str, dropout_p: float, seed):
    """(seed_lo, seed_hi, thresh, scale) as the kernels take them."""
    if dropout_p > 0.0:
        if seed is None:
            raise ValueError(f"{name}: dropout_p > 0 needs an integer seed")
        lo, hi = philox.seed_words(int(seed))
        return lo, hi, philox.keep_threshold(dropout_p), 1.0 / (1.0 - dropout_p)
    philox.keep_threshold(dropout_p)  # range check
    return 0, 0, 0, 1.0


def _check_act(act) -> bool:
    if act not in (None, "silu"):
        raise ValueError(f"unknown act {act!r}")
    return act == "silu"


def _check_rows(x: torch.Tensor, **vectors) -> None:
    B, _, C = x.shape
    for name, t in vectors.items():
        check_operand(name, t, 2, (torch.float32,), x.device)
        if tuple(t.shape) != (B, C):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(B, C)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_stream(name: str, t: torch.Tensor, like=None) -> None:
    if like is None:
        check_operand(name, t, 3)
    else:
        check_operand(name, t, 3, (like.dtype,), like.device)
        if t.shape != like.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def gn_apply(x: torch.Tensor, a: torch.Tensor, bv: torch.Tensor,
             act: str | None = "silu", dropout_p: float = 0.0,
             seed: int | None = None) -> torch.Tensor:
    """y = dropout(act(x * a[b, c] + bv[b, c])) in f32, stored in x's dtype.
    x (B, S, C) f32 or bf16; a, bv (B, C) f32; act None or "silu";
    ``dropout_p`` > 0 needs the site's integer ``seed`` (the mask is
    ``philox.keep(seed, flat element index, p)``). Forward only."""
    silu = _check_act(act)
    lo, hi, thresh, scale = _dropout_args("gn_apply", dropout_p, seed)
    _check_stream("x", x)
    _check_rows(x, a=a, bv=bv)
    check_forward_only("gn_apply", x, a, bv)
    if not on_cuda("gn_apply", x):
        return gn_apply_plain(x, a, bv, silu, dropout_p, seed)
    triton, _, apply_kernel = _kernels()[:3]
    B, S, C = x.shape
    block_s, block_c = _blocks(C, _BLOCK_ELEMS_APPLY)
    y = torch.empty_like(x)
    grid = (triton.cdiv(S, block_s), B)
    apply_kernel[grid](x, a, bv, y, S, C, lo, hi, thresh, scale, SILU=silu,
                       DROPOUT=dropout_p > 0.0, GROUPED=C % 4 == 0,
                       BLOCK_S=block_s, BLOCK_C=block_c, num_warps=4)
    gn_apply.launches += 1
    return y


def gn_bwd_sums(x: torch.Tensor, ct: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                act: str | None = "silu", dropout_p: float = 0.0,
                seed: int | None = None) -> torch.Tensor:
    """The backward's reduction pass of y = dropout(act(xhat * a + b)),
    xhat = (x - mean) * inv: (B, 2, C) f32 (sum dy, sum dy * xhat) over S,
    with dy the incoming gradient ``ct`` taken back through the mask and the
    activation. x, ct (B, S, C) in one dtype; mean, inv, a, b (B, C) f32.
    No autograd of its own."""
    silu = _check_act(act)
    lo, hi, thresh, scale = _dropout_args("gn_bwd_sums", dropout_p, seed)
    _check_stream("x", x)
    _check_stream("ct", ct, x)
    _check_rows(x, mean=mean, inv=inv, a=a, b=b)
    check_forward_only("gn_bwd_sums", x, ct, mean, inv, a, b)
    if not on_cuda("gn_bwd_sums", x):
        return gn_bwd_sums_plain(x, ct, mean, inv, a, b, silu, dropout_p,
                                 seed)
    triton, kernel = _kernels()[0], _kernels()[3]
    B, S, C = x.shape
    block_s, block_c = _blocks(C, _BLOCK_ELEMS_BWD_SUMS)
    iters = triton.cdiv(triton.cdiv(S, block_s), _SUMS_PROGRAMS)
    rows_per_prog = block_s * iters
    out = torch.zeros((B, 2, C), dtype=torch.float32, device=x.device)
    grid = (triton.cdiv(S, rows_per_prog), B)
    kernel[grid](x, ct, mean, inv, a, b, out, S, C, rows_per_prog, lo, hi,
                 thresh, scale, SILU=silu, DROPOUT=dropout_p > 0.0,
                 GROUPED=C % 4 == 0, BLOCK_S=block_s, BLOCK_C=block_c,
                 num_warps=4)
    gn_bwd_sums.launches += 1
    return out


def gn_bwd_apply(x: torch.Tensor, ct: torch.Tensor, mean: torch.Tensor,
                 inv: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 m1: torch.Tensor, m2: torch.Tensor,
                 act: str | None = "silu", dropout_p: float = 0.0,
                 seed: int | None = None) -> torch.Tensor:
    """dx = inv * (dy * a - m1 - xhat * m2) in x's dtype, with dy and xhat as
    in :func:`gn_bwd_sums` and m1, m2 (B, C) f32 the group means of a * dy
    and a * dy * xhat broadcast to channels. No autograd of its own."""
    silu = _check_act(act)
    lo, hi, thresh, scale = _dropout_args("gn_bwd_apply", dropout_p, seed)
    _check_stream("x", x)
    _check_stream("ct", ct, x)
    _check_rows(x, mean=mean, inv=inv, a=a, b=b, m1=m1, m2=m2)
    check_forward_only("gn_bwd_apply", x, ct, mean, inv, a, b, m1, m2)
    if not on_cuda("gn_bwd_apply", x):
        return gn_bwd_apply_plain(x, ct, mean, inv, a, b, m1, m2, silu,
                                  dropout_p, seed)
    triton, kernel = _kernels()[0], _kernels()[4]
    B, S, C = x.shape
    block_s, block_c = _blocks(C, _BLOCK_ELEMS_BWD_APPLY)
    dx = torch.empty_like(x)
    grid = (triton.cdiv(S, block_s), B)
    kernel[grid](x, ct, mean, inv, a, b, m1, m2, dx, S, C, lo, hi, thresh,
                 scale, SILU=silu, DROPOUT=dropout_p > 0.0,
                 GROUPED=C % 4 == 0, BLOCK_S=block_s, BLOCK_C=block_c,
                 num_warps=4)
    gn_bwd_apply.launches += 1
    return dx


gn_sums.launches = 0
gn_apply.launches = 0
gn_bwd_sums.launches = 0
gn_bwd_apply.launches = 0
