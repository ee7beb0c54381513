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
(B, S, C) stream.

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
per four channels): the sums read x once, the apply reads x once and writes y
once, the backward passes read x and the incoming gradient once each (and
write dx once). One exception: on bf16 streams ``gn_bwd_sums`` with dropout
does as much integer work (the Philox rounds) as the card's bytes take
time, and reaches about 60% of the byte bound at (4, 128^3, 32). The two
apply passes take contiguous row blocks of the whole channel width, padded
to a power of two.

The two reductions (``gn_sums``, ``gn_bwd_sums``) run on a launch plan that
is a pure function of the shape and the card (:func:`sums_plan`):

- **channel chunks, not padding**: a program reads a chunk of ``BLOCK_C``
  channels, the largest power of two that divides C, capped at 512 bytes a
  row, so every lane is real and loads stay 16 bytes wide (the 2D widths
  48·2^k would otherwise pad 25% of every tile). A width whose largest
  power-of-two factor is under 4 keeps one padded, masked tile;
- **a grid sized to the card**: as many programs an SM as its registers
  hold at once (``_SUMS_KNOBS`` caps a thread's registers), in whole waves
  (one, or three for the bf16 dropout pass), shared out over (chunk, run of
  rows, batch); each program loops over its run with a [BLOCK_S, BLOCK_C]
  tile in flight and sums it in registers, and a wave's programs finish
  together (a partial wave of such long programs would trail by a whole
  program);
- **no atomics on the sums, no fill**: each program writes its partial to
  an f32 scratch, takes a ticket (one integer atomic per program, at most
  ``_MAX_RUNS`` per (batch, chunk)), and the last to arrive folds the
  partials in run order (at most ``_FOLD_BYTES`` of them, so the fold stays
  a short tail) and writes the (B, 2, C) result, then resets its ticket for
  the next launch. The output is a ``torch.empty``; the scratch and the
  tickets are kept per shape and stream. The sums are therefore the same
  bits from run to run on one card (as the JAX package's are); their order
  differs from the plain version's, which is the tolerance's reason (f32
  rounding of a sum over S terms);
- **a launch without Triton's per-call binding**: after a shape's first
  launch through the JIT, the compiled kernel's launcher is called
  directly (``_run``): at the small 2D sites the host's time is the
  call's time.

Where C is a multiple of 4, the dropout mask of ``gn_bwd_sums`` is built
from one Philox call per four channels; a chunk passes the flat index of its
first channel (``row_base + c0``, a multiple of 4) as the row base of
``philox.device_keep``, so the bits are those of ``keep_mask_plain`` and of
the apply passes.

The route is Triton: both reductions are byte-bound streams without tensor
cores or shared-memory staging, and the dropout mask has one source,
``philox.device_keep``, which the apply passes inline too.

CPU tensors go to the plain versions; CUDA tensors go to the kernels.
``triton`` is imported only when a kernel is first launched.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import philox
from ._common import check_forward_only, check_operand, on_cuda, sm_count

# elements of x per program block of the apply passes (power of two): with
# dropout on, 8192 (64 elements a thread) ran far slower on the H100
_BLOCK_ELEMS_APPLY = 4096
_BLOCK_ELEMS_BWD_APPLY = 4096
# the reductions' launch plan: the widest row chunk a program reads, the
# most runs (partials, ticket atomics) per (batch, chunk), the partials the
# last program of a (batch, chunk) folds (at most this many bytes, read as
# [4096 / BLOCK_C, BLOCK_C] tiles), and per kernel (``gn_sums``;
# ``gn_bwd_sums`` without and with dropout) and element size the warps of a
# program, the elements of a block, the registers a thread may take and the
# waves (chosen on the H100 from trial runs; 2 or 3 pipeline stages gained
# nothing there). The registers fix how many programs an SM holds at once
# (``_RF_REGS`` of them a multiple of 32 threads); the grid is that many
# programs an SM times the waves, so that no partial wave of long programs
# trails.
_ROW_CHUNK_BYTES = 512
_MAX_RUNS = 512
_FOLD_BYTES = 1 << 17
_FOLD_ELEMS = 4096
_RF_REGS = 65536
_SUMS_STAGES = 1
SUMS_KINDS = ("sums", "bwd", "bwd_dropout")
_SUMS_KNOBS = {
    ("sums", 2): (4, 4096, 128, 1), ("sums", 4): (4, 4096, 128, 1),
    ("bwd", 2): (4, 2048, 128, 1), ("bwd", 4): (4, 2048, 128, 1),
    ("bwd_dropout", 2): (4, 2048, 128, 3),
    ("bwd_dropout", 4): (8, 4096, 128, 1),
}


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


class SumsPlan(NamedTuple):
    """How ``gn_sums`` / ``gn_bwd_sums`` cover a (B, S, C) stream: the rows
    are ``row_blocks`` blocks of ``block_s``; program (chunk, run, b) of
    ``grid`` reads blocks [run * row_blocks // runs, (run + 1) * row_blocks
    // runs) of channels [chunk * block_c, (chunk + 1) * block_c) of batch
    b, one block at a time (the last block ends at S). With ``runs`` > 1 the
    partials are folded by the last program of each (b, chunk),
    ``fold_rows`` partials at a time. ``padded``: one chunk of ``block_c``
    lanes, those from C on masked."""
    block_s: int
    block_c: int
    chunks: int
    padded: bool
    row_blocks: int
    runs: int
    fold_rows: int
    grid: tuple
    num_warps: int
    num_stages: int
    maxnreg: int

    @property
    def fold(self) -> bool:
        return self.runs > 1

    def scratch_floats(self) -> int:
        """f32 partials the plan writes: (B, chunks, runs, 2, block_c)."""
        return self.grid[2] * self.chunks * self.runs * 2 * self.block_c if \
            self.fold else 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def sums_plan(B: int, S: int, C: int, elt: int, sms: int,
              kind: str = "sums") -> SumsPlan:
    """The launch plan of a reduction (``kind`` one of ``SUMS_KINDS``:
    ``gn_sums``, ``gn_bwd_sums`` without or with dropout) on a (B, S, C)
    stream of ``elt``-byte elements on a card of ``sms`` SMs."""
    warps, elems, maxnreg, waves = _SUMS_KNOBS[kind, elt]
    wave = sms * max(1, _RF_REGS // (maxnreg * 32 * warps))
    pow2 = C & -C
    padded = pow2 < 4
    if padded:
        block_c, chunks = 1 << max(C - 1, 0).bit_length(), 1
    else:
        block_c = min(pow2, _ROW_CHUNK_BYTES // elt)
        chunks = C // block_c
    block_s = max(1, elems // block_c)
    row_blocks = max(1, _cdiv(S, block_s))
    target = wave * waves // (B * chunks)
    runs = max(1, min(_MAX_RUNS, _FOLD_BYTES // (8 * block_c), row_blocks,
                      target))
    if runs < target and runs * B * chunks >= wave:
        # a cap binds: round down to whole waves of resident programs
        runs = max(1, runs * B * chunks // wave * wave // (B * chunks))
    return SumsPlan(block_s, block_c, chunks, padded, row_blocks, runs,
                    max(1, _FOLD_ELEMS // block_c), (chunks, runs, B), warps,
                    _SUMS_STAGES, maxnreg)


class _Launch:
    """What a reduction's launch needs beyond its per-call tensors and
    scalars: the plan, the stream, its scratch (int32 tickets, 0 between
    launches, and the f32 partials), the kernel's constexpr arguments, and
    the compiled kernel once it has launched through Triton's JIT."""
    __slots__ = ("plan", "stream", "tickets", "part", "consts", "compiled")


# (kind, x's shape, dtype and 16-byte alignment, the kernel's flags, device,
# stream) -> its _Launch
_LAUNCHES: dict = {}


def _launch_for(kind: str, x: torch.Tensor, flags: tuple,
                consts) -> _Launch:
    """The launch of reduction ``kind`` on x under ``flags``; ``consts``
    gives a plan's constexpr arguments in the kernel's signature order."""
    device = torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    key = (kind, x.shape, x.dtype, x.data_ptr() % 16 == 0, flags, device,
           stream)
    ln = _LAUNCHES.get(key)
    if ln is None:
        B, S, C = x.shape
        ln = _Launch()
        ln.plan = sums_plan(B, S, C, x.element_size(), sm_count(x.device),
                            kind)
        ln.stream = stream
        ln.tickets = torch.zeros(B * ln.plan.chunks, dtype=torch.int32,
                                 device=x.device)
        ln.part = torch.empty(max(1, ln.plan.scratch_floats()),
                              dtype=torch.float32, device=x.device)
        ln.consts = consts(ln.plan)
        ln.compiled = None
        _LAUNCHES[key] = ln
    return ln


def _sums_consts(plan: SumsPlan) -> dict:
    return dict(BLOCK_S=plan.block_s, BLOCK_C=plan.block_c,
                PADDED=plan.padded, FOLD=plan.fold, FOLD_R=plan.fold_rows)


@functools.cache
def _direct_launch() -> bool:
    """Whether a compiled kernel may be launched as Triton 3.6's
    ``JITFunction.run`` launches it (the version whose call this mirrors)."""
    import triton

    return triton.__version__.startswith("3.6.")


def _run(ln: _Launch, kernel, args: tuple) -> None:
    """Launch a reduction kernel on ``ln``'s plan. Its first launch goes
    through Triton's JIT, which compiles or finds the kernel for the
    arguments' specialization (fixed by the launch's key: shapes, dtypes,
    alignment, flags); later ones call the compiled kernel's launcher with
    the arguments ``JITFunction.run`` passes it, without its per-call
    binding of the arguments (most of a small site's host time)."""
    if ln.compiled is None:
        if list(kernel.arg_names[len(args):]) != list(ln.consts):
            raise RuntimeError("constexprs out of the signature's order")
        compiled = kernel[ln.plan.grid](*args, **ln.consts,
                                        num_warps=ln.plan.num_warps,
                                        num_stages=ln.plan.num_stages,
                                        maxnreg=ln.plan.maxnreg)
        if _direct_launch():
            ln.compiled = compiled
        return
    c = ln.compiled
    c.run(*ln.plan.grid, ln.stream, c.function, c.packed_metadata, None,
          None, None, *args, *ln.consts.values())


@functools.cache
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def store_sums(s1, s2, out_ptr, part_ptr, ticket_ptr, b, C,
                   BLOCK_C: tl.constexpr, FOLD: tl.constexpr,
                   FOLD_R: tl.constexpr):
        # program (chunk, run, b)'s partial sums s1, s2 (BLOCK_C,) into
        # out[b, :, chunk]: directly with one run; else through the scratch,
        # the last program of the (b, chunk) to take a ticket folding all
        # runs' partials, FOLD_R at a time in run order
        chunk = tl.program_id(0)
        lanes = tl.arange(0, BLOCK_C)
        cols = chunk * BLOCK_C + lanes
        out = out_ptr + b * 2 * C + cols
        if FOLD:
            run = tl.program_id(1)
            runs = tl.num_programs(1)
            slot = b * tl.num_programs(0) + chunk
            part = part_ptr + slot.to(tl.int64) * runs * (2 * BLOCK_C)
            tl.store(part + run * (2 * BLOCK_C) + lanes, s1)
            tl.store(part + run * (2 * BLOCK_C) + BLOCK_C + lanes, s2)
            # every thread's partial is out before the ticket's release
            tl.debug_barrier()
            arrived = tl.atomic_add(ticket_ptr + slot, 1, sem="acq_rel",
                                    scope="gpu")
            if arrived == runs - 1:
                t1 = tl.zeros([FOLD_R, BLOCK_C], tl.float32)
                t2 = tl.zeros([FOLD_R, BLOCK_C], tl.float32)
                for r0 in range(0, runs, FOLD_R):
                    rr = r0 + tl.arange(0, FOLD_R)
                    p = part + rr[:, None] * (2 * BLOCK_C) + lanes[None, :]
                    m = (rr < runs)[:, None]
                    t1 += tl.load(p, mask=m, other=0.0, cache_modifier=".cg")
                    t2 += tl.load(p + BLOCK_C, mask=m, other=0.0,
                                  cache_modifier=".cg")
                tl.store(out, tl.sum(t1, axis=0), mask=cols < C)
                tl.store(out + C, tl.sum(t2, axis=0), mask=cols < C)
                tl.store(ticket_ptr + slot, 0)  # ready for the next launch
        else:
            tl.store(out, s1, mask=cols < C)
            tl.store(out + C, s2, mask=cols < C)

    @triton.jit
    def run_rows(row_blocks, S, BLOCK_S: tl.constexpr):
        # rows [start, stop) of program (., run, .): its share of the
        # row_blocks blocks, the shares of two runs a block apart at most
        run = tl.program_id(1).to(tl.int64)
        runs = tl.num_programs(1)
        start = (run * row_blocks // runs * BLOCK_S).to(tl.int32)
        stop = ((run + 1) * row_blocks // runs * BLOCK_S).to(tl.int32)
        return start, tl.minimum(stop, S)

    @triton.jit
    def sums_kernel(x_ptr, out_ptr, part_ptr, ticket_ptr, S, C,
                    row_blocks, BLOCK_S: tl.constexpr,
                    BLOCK_C: tl.constexpr, PADDED: tl.constexpr,
                    FOLD: tl.constexpr, FOLD_R: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        b = tl.program_id(2)
        base = x_ptr + b.to(tl.int64) * S * C
        start, stop = run_rows(row_blocks, S, BLOCK_S)
        acc1 = tl.zeros([BLOCK_S, BLOCK_C], tl.float32)
        acc2 = tl.zeros([BLOCK_S, BLOCK_C], tl.float32)
        for r0 in range(start, stop, BLOCK_S):
            rows = r0 + tl.arange(0, BLOCK_S)
            if PADDED:
                mask = (rows < stop)[:, None] & (cols < C)[None, :]
            else:
                mask = (rows < stop)[:, None]
            v = tl.load(base + rows[:, None] * C + cols[None, :], mask=mask,
                        other=0.0).to(tl.float32)
            acc1 += v
            acc2 += v * v
        store_sums(tl.sum(acc1, axis=0), tl.sum(acc2, axis=0), out_ptr,
                   part_ptr, ticket_ptr, b, C, BLOCK_C, FOLD, FOLD_R)

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
                        out_ptr, part_ptr, ticket_ptr, S, C, row_blocks,
                        seed_lo, seed_hi, thresh, scale, SILU: tl.constexpr,
                        DROPOUT: tl.constexpr, GROUPED: tl.constexpr,
                        BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
                        PADDED: tl.constexpr, FOLD: tl.constexpr,
                        FOLD_R: tl.constexpr):
        c0 = tl.program_id(0) * BLOCK_C
        cols = c0 + tl.arange(0, BLOCK_C)
        b = tl.program_id(2)
        cmask = cols < C
        mean = tl.load(mean_ptr + b * C + cols, mask=cmask, other=0.0)
        inv = tl.load(inv_ptr + b * C + cols, mask=cmask, other=0.0)
        av = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
        bv = tl.load(b_ptr + b * C + cols, mask=cmask, other=0.0)
        base = b.to(tl.int64) * S * C
        start, stop = run_rows(row_blocks, S, BLOCK_S)
        acc1 = tl.zeros([BLOCK_S, BLOCK_C], tl.float32)
        acc2 = tl.zeros([BLOCK_S, BLOCK_C], tl.float32)
        for r0 in range(start, stop, BLOCK_S):
            rows = r0 + tl.arange(0, BLOCK_S)
            if PADDED:
                mask = (rows < stop)[:, None] & cmask[None, :]
            else:
                mask = (rows < stop)[:, None]
            row_base = base + rows.to(tl.int64) * C
            offs = row_base[:, None] + cols[None, :]
            # the chunk's first element is the Philox row base: c0 is a
            # multiple of 4 wherever the mask is GROUPED
            dy, xhat = dy_xhat(x_ptr, ct_ptr, offs, row_base + c0, mask,
                               mean, inv, av, bv, seed_lo, seed_hi, thresh,
                               scale, SILU, DROPOUT, GROUPED, BLOCK_S,
                               BLOCK_C)
            dy = tl.where(mask, dy, 0.0)
            acc1 += dy
            acc2 += dy * xhat
        store_sums(tl.sum(acc1, axis=0), tl.sum(acc2, axis=0), out_ptr,
                   part_ptr, ticket_ptr, b, C, BLOCK_C, FOLD, FOLD_R)

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
    B, S, C = x.shape
    out = x.new_empty((B, 2, C), dtype=torch.float32)
    if B * C:
        ln = _launch_for("sums", x, (), _sums_consts)
        _run(ln, _kernels()[1],
             (x, out, ln.part, ln.tickets, S, C, ln.plan.row_blocks))
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
        if t.shape != (B, C):
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
    B, S, C = x.shape
    out = x.new_empty((B, 2, C), dtype=torch.float32)
    if B * C:
        dropout = dropout_p > 0.0
        ln = _launch_for(
            "bwd_dropout" if dropout else "bwd", x, (silu, thresh < 2 ** 31),
            lambda plan: dict(SILU=silu, DROPOUT=dropout, GROUPED=C % 4 == 0,
                              **_sums_consts(plan)))
        _run(ln, _kernels()[3],
             (x, ct, mean, inv, a, b, out, ln.part, ln.tickets, S, C,
              ln.plan.row_blocks, lo, hi, thresh, scale))
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
