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
``y = act(x * A[b, c] + Bv[b, c])`` in f32 with y in x's dtype, where A and Bv
fold the mean, the inverse deviation, gamma/beta and FiLM. Dropout is not on
the sampling path and comes with the training kernels.

Both are bound by device memory on the H100 (a few operations per byte): the
sums read x once, the apply reads x once and writes y once, each with
contiguous row blocks so that loads are wide and coalesced.

CPU tensors go to the plain versions; CUDA tensors go to the kernels.
``triton`` is imported only when a kernel is first launched.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ._common import check_forward_only, check_operand, on_cuda

# elements of x per program block (power of two)
_BLOCK_ELEMS_SUMS = 4096
_BLOCK_ELEMS_APPLY = 8192
# target number of programs per batch element for the sums reduction
_SUMS_PROGRAMS = 1024


def gn_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, S, C) -> (B, 2, C) f32 (sum x, sum x^2) over S."""
    xf = x.float()
    return torch.stack([xf.sum(1), (xf * xf).sum(1)], 1)


def gn_apply_plain(x: torch.Tensor, a: torch.Tensor, bv: torch.Tensor,
                   silu: bool) -> torch.Tensor:
    """(B, S, C) -> act(x * a + bv) in x's dtype; a, bv (B, C) f32."""
    y = x.float() * a[:, None, :] + bv[:, None, :]
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


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

    @triton.jit
    def apply_kernel(x_ptr, a_ptr, b_ptr, y_ptr, S, C, SILU: tl.constexpr,
                     BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        rows = pid * BLOCK_S + tl.arange(0, BLOCK_S)
        mask = (rows < S)[:, None] & cmask[None, :]
        av = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
        bv = tl.load(b_ptr + b * C + cols, mask=cmask, other=0.0)
        offs = b.to(tl.int64) * S * C + rows[:, None] * C + cols[None, :]
        v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = v * av[None, :] + bv[None, :]
        if SILU:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, sums_kernel, apply_kernel


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
    triton, sums_kernel, _ = _kernels()
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


def gn_apply(x: torch.Tensor, a: torch.Tensor, bv: torch.Tensor,
             act: str | None = "silu", dropout_p: float = 0.0) -> torch.Tensor:
    """y = act(x * a[b, c] + bv[b, c]) in f32, stored in x's dtype.
    x (B, S, C) f32 or bf16; a, bv (B, C) f32; act None or "silu".
    Forward only; dropout is not implemented yet."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown act {act!r}")
    if dropout_p > 0.0:
        raise NotImplementedError("gn_apply has no dropout yet")
    check_operand("x", x, 3)
    B, S, C = x.shape
    for name, t in (("a", a), ("bv", bv)):
        check_operand(name, t, 2, (torch.float32,), x.device)
        if tuple(t.shape) != (B, C):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(B, C)}")
    check_forward_only("gn_apply", x, a, bv)
    silu = act == "silu"
    if not on_cuda("gn_apply", x):
        return gn_apply_plain(x, a, bv, silu)
    triton, _, apply_kernel = _kernels()
    block_s, block_c = _blocks(C, _BLOCK_ELEMS_APPLY)
    y = torch.empty_like(x)
    grid = (triton.cdiv(S, block_s), B)
    apply_kernel[grid](x, a, bv, y, S, C, SILU=silu, BLOCK_S=block_s,
                       BLOCK_C=block_c, num_warps=4)
    gn_apply.launches += 1
    return y


gn_sums.launches = 0
gn_apply.launches = 0
