"""SAME 3x3x3 stride-1 convolution, forward and backward: the CUDA kernels,
their launch plans and their plain versions.

Replaces the Pallas TPU kernel ``vdm4cdm_tpu/ops/pallas/conv3d.py::
_fwd_kernel`` as reached through ``_conv_pallas_raw_packed`` (the packed,
bias-folding, stats-emitting entry ``conv3d_pallas_packed_bs``). The kernel is
``csrc/conv3d_fwd.cu``: f32 accumulation, bias and an optional residual added
before the cast, and optional per-(batch, channel) sums (sum y, sum y^2) of
the f32 pre-cast output. On the H100 it is bound by the tensor cores at every
site from 32 -> 32 channels up (about 290 operations a byte there, the card's
balance point). Its bf16 path cuts the output into bricks of 4 x 8 x 8 voxels
x 32 or 64 output channels; a CTA stages the brick's haloed input (6 x 10 x
10 voxels) in shared memory once per 16-channel chunk, streams the chunk's
weights beside it one kz plane of 9 taps at a time, and forms every tap
from that one staging with ``ldmatrix`` at shifted row addresses on the
tensor cores (``mma.sync`` at 32 output channels a CTA, ``wgmma`` with A
from registers at 64), so each input byte crosses L2 about 2.3 times per
Cout tile instead of 27. The f32 path, the trained model's
(``VDM_GRF_c_c_32``), runs the same bricks on the TF32 tensor cores with a
3xTF32 split (each operand hi + lo, three products, f32 accuracy): Cout
tiles of 64, 48, 32 or 16 that divide Cout, the input chunk split once in
shared memory for all 27 taps, and, where the bricks leave SMs empty, the K
steps split over CTAs with a second kernel adding the partials in a fixed
order. Bound: 3 x 2 x 27 Cin Cout operations a voxel at 495 TFLOP/s. The
source file says more.

The sums are the same bits from run to run: each CTA writes its own
(sum y, sum y^2) per channel to its row of a workspace (B, T, 2, Cout), its
warps' partials added in warp order, and a small fold kernel adds the T rows
in an order fixed by the shapes (:func:`sums_plan`, :func:`fold_runs`):
segments of contiguous rows, each cut into one contiguous run a warp, each
run in index order, the runs in warp order, the segments' partials in
segment order by the last CTA of a (column group, batch) to take a ticket.
No float atomics; the workspace and the tickets are kept per device and
stream by the wrapper (:func:`_sums_work`), so a call allocates nothing for
them.

The plain version computes the same function with ``torch.nn.functional.
conv3d`` in f32. CPU tensors go to it; CUDA tensors go to the kernel.

The backward has two parts. The input gradient is the forward kernel again
(:func:`conv3d_k3s1_dx`): the same conv of the output gradient with the
weights flipped in space and transposed in (Cin, Cout), under the same padding
mode, as the TPU package runs ``_conv_pallas_raw_packed`` on ``ct``. The
weight and bias gradients are ``conv3d_k3s1_dw``, the kernel
``csrc/conv3d_dw.cu``, which replaces the Pallas ``_dw_kernel`` (reached
through ``_conv_pallas_dw``): 27 GEMMs with the voxels as the contraction,
also bound by the tensor cores. Its bf16 path walks a queue of (32 x 32
(ci, co) tile, brick) items cut into one equal run per SM: a CTA stages each
brick's ct and haloed x once and accumulates all 27 taps of its tile from
them with ``wgmma`` (registers, flushed into f32 running sums in shared
memory every 4 bricks), and adds a tile's sums to the output with atomics
where its run leaves that tile (the sum order is run-dependent). Its f32
path walks the same queue (16 ci x 32 or 16 co tiles) with ``mma.sync`` in
3xTF32 on 9 warps, each holding the three kx taps of one (kz, ky). Its
plain version is 27 shifted matrix products in f32.

:func:`fwd_plan` and :func:`dw_plan` are the kernels' launch plans (tile,
grid, threads, shared memory, the dw split), computed here by the same rules
as in the sources, where the CPU tests hold them; ``chip_smoke.py`` holds
them equal to the plans the compiled sources report.

The spatially sharded path adds the z-halo entries, the same two kernels
with another z mode (``csrc/conv3d_fwd.cu`` says more). They replace the
Pallas kernels under ``zmode="halo"`` (``conv3d_pallas_zhalo``, its backward
``_bwd_zh`` and the packed entries): the input is a slab with its two
exchanged halo planes, (B, D + 2, H, W, Cin), and the output has D planes,
valid in z and SAME in-plane. :func:`conv3d_k3s1_zhalo_fwd` is the forward
(bias, residual and sums as above, the sums being the slab's own),
:func:`conv3d_k3s1_zhalo_dx` its input gradient (full in z, (B, D + 2, H, W,
Cin), the forward kernel's third z mode on flipped, transposed weights) and
:func:`conv3d_k3s1_zhalo_dw` its weight and bias gradients. Each counts its
own launches. Their plain versions run the valid-in-z ``F.conv3d`` on the
haloed input and the 27 shifted products with no z pad.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ._common import (DTYPE_CODE, check_aligned, check_forward_only,
                      check_operand, on_cuda, sm_count)


def supports(cin: int, cout: int) -> bool:
    """Channel counts the kernel takes: multiples of 8 (16-byte vectors)."""
    return cin >= 8 and cout >= 8 and cin % 8 == 0 and cout % 8 == 0


def _in_plane_pad(xf, circular):
    """(B, C, D, H, W) f32 padded by one voxel in H and W (wrapped or
    zero), not in D."""
    return F.pad(xf, (1, 1, 1, 1, 0, 0),
                 mode="circular" if circular else "constant")


def _z_pad(x, circular):
    """(B, D, H, W, C) padded by one plane on each side of D (wrapped or
    zero): the SAME conv of x is the valid-in-z conv of this."""
    if circular:
        return torch.cat([x[:, -1:], x, x[:, :1]], 1)
    return F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))


def conv3d_k3s1_zhalo_plain(x, w, bias=None, residual=None, circular=False,
                            with_sums=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_zhalo_fwd`: the valid-in-z
    conv of the haloed x (B, D + 2, H, W, Cin), SAME in-plane, in f32."""
    xf = _in_plane_pad(x.float().permute(0, 4, 1, 2, 3), circular)
    # the weights take x's dtype first, as the kernel (and JAX's conv_nd)
    # multiply in it
    wf = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf).permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    sums = None
    if with_sums:
        sums = torch.stack([y.sum((1, 2, 3)), (y * y).sum((1, 2, 3))], 1)
    return y.to(x.dtype).contiguous(), sums


def conv3d_k3s1_plain(x, w, bias=None, residual=None, circular=False,
                      with_sums=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_fwd` (same arguments)."""
    return conv3d_k3s1_zhalo_plain(_z_pad(x, circular), w, bias, residual,
                                   circular, with_sums)


def conv3d_k3s1_zhalo_dx_plain(ct, w, circular=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_zhalo_dx`: the output
    gradient padded with two zero planes on each side of z, then the
    valid-in-z conv with flipped, transposed weights."""
    ct_pad = F.pad(ct, (0, 0, 0, 0, 0, 0, 2, 2))
    w_t = w.flip(0, 1, 2).transpose(3, 4)
    return conv3d_k3s1_zhalo_plain(ct_pad, w_t, circular=circular)[0]


def conv3d_k3s1_zhalo_dw_plain(x, ct, circular=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_zhalo_dw`: per tap, the
    f32 product of the in-plane padded, shifted x (no z pad: x has the two
    halo planes) with ct over all voxels."""
    B, D, H, W, cout = ct.shape
    cin = x.shape[-1]
    xp = _in_plane_pad(x.float().permute(0, 4, 1, 2, 3), circular)
    xp = xp.permute(0, 2, 3, 4, 1)
    ctf = ct.float().reshape(-1, cout)
    taps = [xp[:, kz:kz + D, ky:ky + H, kx:kx + W].reshape(-1, cin).T @ ctf
            for kz in range(3) for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, cin, cout), ctf.sum(0)


def conv3d_k3s1_dw_plain(x, ct, circular=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_dw` (same arguments): per
    tap, the f32 product of the shifted, padded x with ct over all
    voxels."""
    return conv3d_k3s1_zhalo_dw_plain(_z_pad(x, circular), ct, circular)


# ------------------------------------------------------------ launch plans
# The rules of csrc/conv3d_fwd.cu and csrc/conv3d_dw.cu (``make_plan``),
# field for field; both dtypes take the bricks, bf16 in bf16 on the tensor
# cores, f32 in 3xTF32.

BRICK = (4, 8, 8)           # output voxels (d, h, w) of a CTA
HALO = tuple(n + 2 for n in BRICK)
SMEM_LIMIT = 232448         # bytes of shared memory a CTA may use (H100)
SMS = 132                   # the H100 SXM's streaming multiprocessors
_NH = HALO[0] * HALO[1] * HALO[2]
FWD_KC = 16  # input channels a chunk


def _fwd_smem(bn):
    """Two input chunks, two kz planes of weights, the row-offset table and
    the residual's brick (``Fwd<BN>`` in the source)."""
    return (2 * _NH * FWD_KC * 2 + 2 * 9 * bn * FWD_KC * 2 + _NH * 4
            + BRICK[0] * BRICK[1] * BRICK[2] * bn * 2)


FWD_F32_KC = 8     # f32: input channels a chunk (one k8 step)
# f32: the widest Cout whose K splits the reduce kernel adds (a 4-channel
# group a thread of 256)
FWD_REDUCE_MAX_COUT = 1024


def _fwd_f32_bn(cout):
    """f32 output channels a CTA: a tile that divides Cout, else 16."""
    return next((bn for bn in (64, 48, 32) if cout % bn == 0), 16)


def _fwd_f32_smem(bn):
    """The raw chunk, its hi / lo split, three steps of weights (three taps
    x bn x 8 channels, hi and lo), the row-offset table, the four warps'
    column sums (``F32<BN>`` in the source)."""
    return (_NH * FWD_F32_KC * 4 + _NH * FWD_F32_KC * 8 + 3 * 3 * bn * 64
            + _NH * 4 + 4 * 2 * bn * 4)


DW_TILE, DW_STAGES, DW_THREADS = 32, 2, 256
# the stages, and the running sums of 14 m64 x 32 tiles in f32 (the 27
# taps' 32 x 32 tile and db's)
DW_SMEM = (DW_STAGES * (_NH + BRICK[0] * BRICK[1] * BRICK[2]) * DW_TILE * 2
           + 14 * 64 * DW_TILE * 4)


# f32 dw: 16 ci x 32 or 16 co tiles on 9 warps; two stages of the haloed x
# brick (rows of 16 + 8 floats) and the ct brick (rows of co + 8 floats)
DW_F32_CI, DW_F32_THREADS = 16, 288


def _dw_f32_smem(co_tile):
    return 2 * (_NH * (DW_F32_CI + 8) + BRICK[0] * BRICK[1] * BRICK[2]
                * (co_tile + 8)) * 4


def _cdiv(a, b):
    return -(-a // b)


class FwdPlan(NamedTuple):
    """``conv3d_k3s1_fwd``'s launch: bricks of tile_d x tile_h x tile_w
    voxels, grid x = (brick, Cout tile, K split) (the split fastest, then
    the tile), y = batch; ``ksplit`` CTAs share a brick's K steps (f32
    only)."""
    kind: int
    tile_d: int
    tile_h: int
    tile_w: int
    cout_tile: int
    grid_x: int
    grid_y: int
    grid_z: int
    threads: int
    smem_bytes: int
    ksplit: int


class DwPlan(NamedTuple):
    """``conv3d_k3s1_dw``'s launch: bricks, a queue of ((ci, co) tile,
    brick) items cut into ``splits`` runs of equal length, one a CTA (grid
    x)."""
    kind: int
    tile_d: int
    tile_h: int
    tile_w: int
    ci_tile: int
    co_tile: int
    splits: int
    grid_x: int
    grid_y: int
    threads: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def fwd_plan(dtype, B, D, H, W, cin, cout, sms=SMS) -> FwdPlan:
    """The forward kernel's plan for a (B, D, H, W) output (any z mode) on
    a card of ``sms`` SMs."""
    bricks = math.prod(_cdiv(n, t) for n, t in zip((D, H, W), BRICK))
    if dtype == torch.bfloat16:
        bn = 64 if cout % 64 == 0 else 32
        return FwdPlan(1, *BRICK, bn, bricks * _cdiv(cout, bn), B, 1, 128,
                       _fwd_smem(bn), 1)
    bn = _fwd_f32_bn(cout)
    ctas = bricks * _cdiv(cout, bn)
    ksplit = 1
    if ctas * B < sms and cout <= FWD_REDUCE_MAX_COUT:
        ksplit = min(_cdiv(sms, ctas * B), 9 * (cin // FWD_F32_KC))
    return FwdPlan(1, *BRICK, bn, ctas * ksplit, B, 1, 128,
                   _fwd_f32_smem(bn), ksplit)


# the sums' fold (``conv3d_k3s1_sums_fold_kernel``): threads a CTA (8
# warps), columns of a workspace row a CTA (a float4 a lane), the fewest rows
# a segment takes, the most segments the last CTA adds
FOLD_THREADS, FOLD_COLS, FOLD_MIN_ROWS, FOLD_MAX_SEGS = 256, 128, 64, 64
FWD_REDUCE_VOX = 64  # voxels a CTA of the K splits' reduce kernel


class SumsPlan(NamedTuple):
    """The fold of a forward's GroupNorm sums: ``rows`` tile rows (T) of
    the workspace (B, T, 2, Cout), added by a grid of (``groups`` column
    groups of 128, ``segments``, B) CTAs of ``threads``."""
    rows: int
    groups: int
    segments: int
    threads: int


@functools.lru_cache(maxsize=None)
def sums_plan(dtype, B, D, H, W, cin, cout, sms=SMS) -> SumsPlan:
    """The sums' fold after a forward launch of (B, D, H, W) output planes
    (any z mode) on a card of ``sms`` SMs: the workspace's rows are the
    plan's bricks, or the reduce kernel's runs of 64 voxels where the f32
    plan splits K; two waves of CTAs, each segment at least 64 rows, at most
    64 segments."""
    plan = fwd_plan(dtype, B, D, H, W, cin, cout, sms)
    if plan.ksplit > 1:
        rows = _cdiv(D * H * W, FWD_REDUCE_VOX)
    else:
        rows = math.prod(_cdiv(n, t) for n, t in zip((D, H, W), BRICK))
    groups = _cdiv(2 * cout, FOLD_COLS)
    segs = min(_cdiv(2 * sms, groups * B), _cdiv(rows, FOLD_MIN_ROWS),
               FOLD_MAX_SEGS)
    return SumsPlan(rows, groups, max(1, segs), FOLD_THREADS)


def sums_workspace(plan: SumsPlan, B: int, cout: int) -> Tuple[int, int]:
    """(f32 floats, int32 tickets) of a fold: the rows (B, T, 2, Cout),
    then the segments' partials (B, groups, segments, 128); a ticket per
    (batch, column group)."""
    return (B * plan.rows * 2 * cout
            + B * plan.groups * plan.segments * FOLD_COLS,
            B * plan.groups)


def fold_runs(plan: SumsPlan):
    """The fold's order: (segment, warp, first row, end row) of each run,
    in the order the runs' totals are added (a run's rows in index order).
    The same for every column group and batch."""
    warps = plan.threads // 32
    for seg in range(plan.segments):
        r0 = plan.rows * seg // plan.segments
        n = plan.rows * (seg + 1) // plan.segments - r0
        for w in range(warps):
            yield seg, w, r0 + n * w // warps, r0 + n * (w + 1) // warps


def fwd_scratch_floats(plan: FwdPlan, B, D, H, W, cin, cout) -> int:
    """f32 scratch of a forward launch: the weights split into hi and lo,
    and the K splits' partial outputs where there is more than one."""
    parts = plan.ksplit * B * D * H * W * cout if plan.ksplit > 1 else 0
    return 54 * cin * cout + parts


def dw_plan(dtype, B, D, H, W, cin, cout, sms=SMS) -> DwPlan:
    """The weight-gradient kernel's plan for a (B, D, H, W) output gradient
    on a card of ``sms`` SMs."""
    if dtype == torch.bfloat16:
        bricks = B * math.prod(_cdiv(n, t) for n, t in zip((D, H, W), BRICK))
        items = _cdiv(cin, DW_TILE) * _cdiv(cout, DW_TILE) * bricks
        ctas = min(sms, items)
        return DwPlan(1, *BRICK, DW_TILE, DW_TILE, ctas, ctas, 1, DW_THREADS,
                      DW_SMEM)
    co_tile = 32 if cout % 32 == 0 else 16
    bricks = B * math.prod(_cdiv(n, t) for n, t in zip((D, H, W), BRICK))
    items = _cdiv(cin, DW_F32_CI) * _cdiv(cout, co_tile) * bricks
    ctas = min(sms, items)
    return DwPlan(1, *BRICK, DW_F32_CI, co_tile, ctas, ctas, 1,
                  DW_F32_THREADS, _dw_f32_smem(co_tile))


def compiled_plans(dtype, B, D, H, W, cin, cout):
    """(forward, dw, sums' fold) plans as the compiled sources report them
    at the card's SM count; on the machine with the card."""
    code = DTYPE_CODE[dtype]
    args = (code, B, D, H, W, cin, cout, 0)
    out = []
    for source, name, n, cls in (
            ("conv3d_fwd.cu", "conv3d_k3s1_fwd_plan", 11, FwdPlan),
            ("conv3d_dw.cu", "conv3d_k3s1_dw_plan", 11, DwPlan),
            ("conv3d_fwd.cu", "conv3d_k3s1_sums_plan", 4, SumsPlan)):
        from ._build import c_function

        fn = c_function(source, name,
                        [ctypes.c_int] * len(args) + [ctypes.c_void_p])
        buf = (ctypes.c_int * n)()
        fn(*args, ctypes.addressof(buf))
        out.append(cls(*buf))
    return tuple(out)


def _fn(source, name, n_ptrs, n_ints):
    from ._build import c_function

    p, i = ctypes.c_void_p, ctypes.c_int
    return c_function(source, name, [i] + [p] * n_ptrs + [i] * n_ints + [p])


# (device, stream) -> the sums' fold workspace there: f32 rows and
# partials, int32 tickets (0 between launches: the fold resets them); grown
# where a call needs more, never shrunk
_SUMS_WORK: dict = {}


def _sums_work(dev, floats: int, tickets: int):
    """(f32 workspace, int32 tickets) of the fold on ``dev``'s current
    stream, at least ``floats`` and ``tickets`` long. Kernels on one stream
    run in order, so each call may reuse what the last one used."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    ws, tk = _SUMS_WORK.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=dev)
    if tk is None or tk.numel() < tickets:
        tk = torch.zeros(tickets, dtype=torch.int32, device=dev)
    _SUMS_WORK[key] = ws, tk
    return ws, tk


def _check_weights(x, w, cin):
    if tuple(w.shape[:3]) != (3, 3, 3) or w.ndim != 5 or w.shape[3] != cin:
        raise ValueError(f"w shape {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    cout = w.shape[4]
    if not supports(cin, cout):
        raise ValueError(f"channels {cin}->{cout}: need multiples of 8")
    return cout


def _launch_fwd(name, x, w, bias, residual, circular, with_sums, d_out,
                zmode):
    """Launch ``csrc/conv3d_fwd.cu`` in ``zmode`` on x (B, Din, H, W, Cin)
    for d_out output planes. Returns (out, sums, the CUDA kernels launched:
    f32 adds the weight split and, where K is split, the reduce; the sums
    add their fold)."""
    B, _, H, W, cin = x.shape
    cout = w.shape[4]
    dev = x.device
    for what, t in (("w", w), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{what} is on {t.device}, x on {dev}")
    wt = w.to(x.dtype).permute(0, 1, 2, 4, 3).reshape(27, cout, cin)
    wt = wt.contiguous()
    bias_f = bias.float().contiguous() if bias is not None else None
    out = torch.empty((B, d_out, H, W, cout), dtype=x.dtype, device=dev)
    sums = scratch = fold = tickets = None
    sms, n_kernels = sm_count(dev), 1
    if x.dtype == torch.float32:
        plan = fwd_plan(x.dtype, B, d_out, H, W, cin, cout, sms)
        scratch = torch.empty(
            fwd_scratch_floats(plan, B, d_out, H, W, cin, cout),
            dtype=torch.float32, device=dev)
        n_kernels = 2 + (plan.ksplit > 1)
    if with_sums:
        sums = torch.empty((B, 2, cout), dtype=torch.float32, device=dev)
        fold, tickets = _sums_work(dev, *sums_workspace(
            sums_plan(x.dtype, B, d_out, H, W, cin, cout, sms), B, cout))
        n_kernels += 1
    operands = (x, wt, bias_f, residual, out, sums, scratch, fold, tickets)
    check_aligned(name, *operands)
    ptrs = [t.data_ptr() if t is not None else None for t in operands]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("conv3d_fwd.cu", "conv3d_k3s1_fwd", 9, 9)(
        DTYPE_CODE[x.dtype], *ptrs, B, d_out, H, W, cin, cout,
        int(bool(circular)), zmode, sms, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return out, sums, n_kernels


def _check_residual(x, residual, shape):
    if residual is not None:
        check_operand("residual", residual, 5, (x.dtype,), x.device)
        if tuple(residual.shape) != shape:
            raise ValueError(f"residual shape {tuple(residual.shape)}, "
                             f"expected {shape}")


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
    cout = _check_weights(x, w, cin)
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({cout},)")
    _check_residual(x, residual, (B, D, H, W, cout))
    check_forward_only("conv3d_k3s1_fwd", x, w, bias, residual)
    if not on_cuda("conv3d_k3s1_fwd", x):
        return conv3d_k3s1_plain(x, w, bias, residual, circular, with_sums)
    y, sums, n_kernels = _launch_fwd("conv3d_k3s1_fwd", x, w, bias,
                                     residual, circular, with_sums, D, 0)
    conv3d_k3s1_fwd.launches += 1
    conv3d_k3s1_fwd.cuda_launches += n_kernels
    return y, sums


def conv3d_k3s1_zhalo_fwd(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    circular: bool = False,
    with_sums: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`conv3d_k3s1_fwd` on a haloed slab: x (B, D + 2, H, W, Cin)
    whose first and last planes are the neighbours' halo planes; valid in z,
    SAME in-plane (``circular`` applies to H and W only). Returns y (B, D,
    H, W, Cout) and the slab's own sums. Forward only."""
    check_operand("x", x, 5)
    B, Dh, H, W, cin = x.shape
    if Dh < 3:
        raise ValueError(f"a haloed slab has at least 3 planes, got {Dh}")
    cout = _check_weights(x, w, cin)
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({cout},)")
    _check_residual(x, residual, (B, Dh - 2, H, W, cout))
    check_forward_only("conv3d_k3s1_zhalo_fwd", x, w, bias, residual)
    if not on_cuda("conv3d_k3s1_zhalo_fwd", x):
        return conv3d_k3s1_zhalo_plain(x, w, bias, residual, circular,
                                       with_sums)
    y, sums, n_kernels = _launch_fwd("conv3d_k3s1_zhalo_fwd", x, w, bias,
                                     residual, circular, with_sums, Dh - 2,
                                     1)
    conv3d_k3s1_zhalo_fwd.launches += 1
    conv3d_k3s1_zhalo_fwd.cuda_launches += n_kernels
    return y, sums


def conv3d_k3s1_zhalo_dx(ct: torch.Tensor, w: torch.Tensor,
                         circular: bool = False) -> torch.Tensor:
    """The input gradient of :func:`conv3d_k3s1_zhalo_fwd`: ct (B, D, H, W,
    Cout) and w (3, 3, 3, Cin, Cout) give (B, D + 2, H, W, Cin) in ct's
    dtype, full in z (the forward kernel's third z mode on w flipped in
    space and transposed). The halo planes' share goes back to the
    neighbours in the halo exchange's backward. Forward only."""
    check_operand("ct", ct, 5)
    B, D, H, W, cout = ct.shape
    if w.ndim != 5 or tuple(w.shape[:3]) != (3, 3, 3) or w.shape[4] != cout:
        raise ValueError(f"w shape {tuple(w.shape)} does not fit ct "
                         f"{tuple(ct.shape)}")
    if not supports(w.shape[3], cout):
        raise ValueError(f"channels {w.shape[3]}->{cout}: need multiples "
                         "of 8")
    check_forward_only("conv3d_k3s1_zhalo_dx", ct, w)
    if not on_cuda("conv3d_k3s1_zhalo_dx", ct):
        return conv3d_k3s1_zhalo_dx_plain(ct, w, circular)
    w_t = w.flip(0, 1, 2).transpose(3, 4)
    out, _, n_kernels = _launch_fwd("conv3d_k3s1_zhalo_dx", ct, w_t, None,
                                    None, circular, False, D + 2, 2)
    conv3d_k3s1_zhalo_dx.launches += 1
    conv3d_k3s1_zhalo_dx.cuda_launches += n_kernels
    return out


def conv3d_k3s1_dx(ct: torch.Tensor, w: torch.Tensor,
                   circular: bool = False) -> torch.Tensor:
    """The input gradient of y = conv(x, w): the forward kernel on the output
    gradient ct (B, D, H, W, Cout) with w (3, 3, 3, Cin, Cout) flipped in
    space and transposed, same padding mode. Returns (B, D, H, W, Cin) in
    ct's dtype. Counts as a launch of ``conv3d_k3s1_fwd``."""
    w_t = w.flip(0, 1, 2).transpose(3, 4)
    return conv3d_k3s1_fwd(ct, w_t, circular=circular)[0]


def _launch_dw(name, x, ct, circular, zmode):
    B, D, H, W, cout = ct.shape
    cin = x.shape[-1]
    if not supports(cin, cout):
        raise ValueError(f"channels {cin}->{cout}: need multiples of 8")
    dw = torch.zeros((3, 3, 3, cin, cout), dtype=torch.float32,
                     device=x.device)
    db = torch.zeros((cout,), dtype=torch.float32, device=x.device)
    check_aligned(name, x, ct, dw, db)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn("conv3d_dw.cu", "conv3d_k3s1_dw", 4, 8)(
        DTYPE_CODE[x.dtype], x.data_ptr(), ct.data_ptr(), dw.data_ptr(),
        db.data_ptr(), B, D, H, W, cin, cout, int(bool(circular)), zmode,
        stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return dw, db


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
    if not supports(x.shape[4], ct.shape[4]):
        raise ValueError(f"channels {x.shape[4]}->{ct.shape[4]}: need "
                         "multiples of 8")
    check_forward_only("conv3d_k3s1_dw", x, ct)
    if not on_cuda("conv3d_k3s1_dw", x):
        return conv3d_k3s1_dw_plain(x, ct, circular)
    out = _launch_dw("conv3d_k3s1_dw", x, ct, circular, 0)
    conv3d_k3s1_dw.launches += 1
    return out


def conv3d_k3s1_zhalo_dw(x: torch.Tensor, ct: torch.Tensor,
                         circular: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db) of :func:`conv3d_k3s1_zhalo_fwd`: the haloed x (B, D + 2, H,
    W, Cin) and ct (B, D, H, W, Cout) in one dtype. Returns dw (3, 3, 3, Cin,
    Cout) and db (Cout,), both f32 and both this slab's own share."""
    check_operand("x", x, 5)
    check_operand("ct", ct, 5, (x.dtype,), x.device)
    B, D, H, W, _ = ct.shape
    if tuple(x.shape[:4]) != (B, D + 2, H, W):
        raise ValueError(f"x shape {tuple(x.shape)} is not ct "
                         f"{tuple(ct.shape)} with two halo planes")
    if not supports(x.shape[4], ct.shape[4]):
        raise ValueError(f"channels {x.shape[4]}->{ct.shape[4]}: need "
                         "multiples of 8")
    check_forward_only("conv3d_k3s1_zhalo_dw", x, ct)
    if not on_cuda("conv3d_k3s1_zhalo_dw", x):
        return conv3d_k3s1_zhalo_dw_plain(x, ct, circular)
    out = _launch_dw("conv3d_k3s1_zhalo_dw", x, ct, circular, 1)
    conv3d_k3s1_zhalo_dw.launches += 1
    return out


conv3d_k3s1_fwd.launches = 0
conv3d_k3s1_dw.launches = 0
conv3d_k3s1_zhalo_fwd.launches = 0
conv3d_k3s1_zhalo_dx.launches = 0
conv3d_k3s1_zhalo_dw.launches = 0
# The forward kernel's calls launch one to four CUDA kernels each (f32: the
# weight split and, where K is split, the reduce; with sums, their fold):
# ``cuda_launches`` counts them all, ``launches`` the calls.
conv3d_k3s1_fwd.cuda_launches = 0
conv3d_k3s1_zhalo_fwd.cuda_launches = 0
conv3d_k3s1_zhalo_dx.cuda_launches = 0
