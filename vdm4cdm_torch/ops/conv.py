"""Channels-last 2D and 3D convolution: counterpart of
``vdm4cdm_tpu/ops/conv.py``.

``conv_nd`` takes x (B, *spatial, Cin), 2 or 3 spatial dims, or a
:class:`Pair`, and weights in the JAX layout (*k, Cin, Cout):

  * 3D k3/s1 with Cin, Cout multiples of 8 runs the hand kernel
    ``conv3d_k3s1_fwd`` (bias in-kernel, optional GroupNorm sums of the output,
    optional residual added before the cast) through :class:`Conv3dK3S1`,
    whose backward is hand kernels too: the forward kernel on the output
    gradient for dx, ``conv3d_k3s1_dw`` for dw and db;
  * a Pair splits the weights over its halves, conv(concat(a, b), W) =
    conv(a, W_a) + conv(b, W_b): the second half's conv takes the first
    half's output as its residual, so the joined input is never written and
    the joined output's sums still come from the kernel where it ran;
  * k1/s1 (the ResBlock ``skip_proj``), 2D or 3D, with Cin, Cout multiples
    of 8 runs the hand kernel ``mm1x1_fwd`` (bias and the optional residual
    added in-kernel before the one cast) through :class:`Conv1x1`, whose
    backward is ``mm1x1_dx`` (the forward kernel on the transposed weight)
    and ``mm1x1_dw``; over a Pair the second half's product takes the first
    half's output as its residual, as for k3;
  * everything else goes to cuDNN through :class:`LibraryConv`
    (``F.conv2d`` / ``F.conv3d``), as the JAX package leaves it to XLA: every
    k3 conv of a 2D model (the Pallas conv is 3D only,
    ``vdm4cdm_tpu/ops/conv.py:95-99``), and in 3D ``conv_in`` 2->32,
    ``conv_out`` 32->1, the stride-2 downsample and a k1 outside the
    multiples of 8. The bias is added in the cuDNN call; a residual is one
    more pass. Such a conv emits no sums (the next norm takes its own).
    Its operands stay channels-last: the circular wrap pad is one copy in
    (B, *spatial, C) (:func:`wrap_pad`), the NC* view of a contiguous
    channels-last tensor is cuDNN's ``channels_last`` layout, and so is the
    output, which returns to (B, *spatial, C) without a copy. On f32
    operands each call, forward and both backward products, runs cuDNN with
    TF32 off and in benchmark mode, and restores the process's settings
    after (:func:`cudnn_settings`): the f32 function the CPU path and the
    hand kernels compute, whatever PyTorch's default (TF32 on for cuDNN
    convs).
    Padding is the torch-style symmetric (k//2, k//2).

Under spatial sharding (a sharded ``ctx``, ``vdm4cdm_tpu/ops/conv.py:111-150``)
the split dim (D in 3D, H in 2D) is not padded locally: the slab is extended
by the neighbours' halo planes or rows (``parallel.halo.halo_exchange``) and
the conv runs valid along it, padded in the other dims only:

  * k3/s1 with supported channels: a (1, 1) halo, then the z-halo kernels
    through :class:`Conv3dK3S1` with ``zhalo`` (bias, residual and the
    slab's own sums in-kernel; dx and dw are z-halo kernels too, and the
    halo exchange's backward returns the halo planes' gradient to the
    neighbours). On a CUDA tensor it launches them or raises: no library
    conv stands in;
  * k1: no halo, as unsharded;
  * everything else (``conv_in``, ``conv_out``, the stride-2 downsample, a k3
    outside the multiples of 8, and every k3 of a 2D model): a (k//2, k//2)
    halo, then the library conv valid along the split dim and padded in the
    others (a wrap pad for circular; in 2D that is W alone). The stride-2
    downsample's (1, 1) halo is JAX's ``(k//2, (k-1)//2)`` for k = 3.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..parallel.halo import NO_SHARD, ShardCtx, halo_exchange
from .kernels import (conv3d_k3s1_dw, conv3d_k3s1_dx, conv3d_k3s1_fwd,
                      conv3d_k3s1_zhalo_dw, conv3d_k3s1_zhalo_dx,
                      conv3d_k3s1_zhalo_fwd, mm1x1_dw, mm1x1_dx, mm1x1_fwd)
from .kernels.conv3d import supports
from .pair import Pair


# the (forward, dx, dw) wrappers of the k3/s1 conv, by z mode: SAME in z,
# or valid in z on a haloed slab (``zhalo``)
_K3S1_KERNELS = {
    False: (conv3d_k3s1_fwd, conv3d_k3s1_dx, conv3d_k3s1_dw),
    True: (conv3d_k3s1_zhalo_fwd, conv3d_k3s1_zhalo_dx, conv3d_k3s1_zhalo_dw),
}


class Conv3dK3S1(torch.autograd.Function):
    """(x, w, bias, residual) -> (y, sums) through ``conv3d_k3s1_fwd``, or
    with ``zhalo`` through ``conv3d_k3s1_zhalo_fwd`` on a haloed slab x
    (B, D + 2, H, W, Cin), y then having D planes.

    Backward, as the JAX package's ``_bs_bwd_core`` (``_bwd_zh`` with
    ``zhalo``): the output gradient is cast to x's dtype; dx is the forward
    kernel on it with flipped, transposed weights (with ``zhalo`` full in z:
    D + 2 planes); (dw, db) come from the dw kernel in f32 and return in the
    parameters' dtypes; the residual's gradient is the output gradient
    itself. ``sums`` exists to feed the following GroupNorm, whose dx already
    carries the whole statistics -> x dependence, so it is
    non-differentiable."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, circular, with_sums, zhalo=False):
        fwd = _K3S1_KERNELS[zhalo][0]
        with torch.no_grad():
            y, sums = fwd(x, w, bias, residual, circular=circular,
                          with_sums=with_sums)
        ctx.save_for_backward(x, w)
        ctx.circular = circular
        ctx.zhalo = zhalo
        ctx.bias_dtype = None if bias is None else bias.dtype
        if sums is None:
            sums = x.new_empty(0)
        ctx.mark_non_differentiable(sums)
        return y, sums

    @staticmethod
    def backward(ctx, ct, _ct_sums):
        x, w = ctx.saved_tensors
        _, dx_kernel, dw_kernel = _K3S1_KERNELS[ctx.zhalo]
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        ct = ct.to(x.dtype).contiguous()
        dx = dx_kernel(ct, w, ctx.circular) if need_x else None
        dw = db = None
        if need_w or need_b:
            dw, db = dw_kernel(x, ct, ctx.circular)
            dw = dw.to(w.dtype) if need_w else None
            db = db.to(ctx.bias_dtype) if need_b else None
        return dx, dw, db, (ct if need_r else None), None, None, None


class Conv1x1(torch.autograd.Function):
    """(x, w, bias, residual) -> y through ``mm1x1_fwd``, w in the conv
    layout (1, 1, 1, Cin, Cout).

    Backward, as the JAX package's ``lane_matmul``: the output gradient is
    cast to x's dtype; dx is the forward kernel on it with the weight read
    transposed, where it lies; (dw, db) come from ``mm1x1_dw`` in f32 and return in the
    parameters' dtypes; the residual's gradient is the output gradient
    itself."""

    @staticmethod
    def forward(ctx, x, w, bias, residual):
        with torch.no_grad():
            y = mm1x1_fwd(x, w.reshape(w.shape[-2:]), bias, residual)
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad
        ct = ct.to(x.dtype).contiguous()
        dx = mm1x1_dx(ct, w.reshape(w.shape[-2:])) if need_x else None
        dw = db = None
        if need_w or need_b:
            dw, db = mm1x1_dw(x, ct)
            dw = dw.to(w.dtype).reshape(w.shape) if need_w else None
            db = db.to(ctx.bias_dtype) if need_b else None
        return dx, dw, db, (ct if need_r else None)


@contextlib.contextmanager
def cudnn_settings(x: torch.Tensor):
    """cuDNN's settings for one library conv on operands like ``x``, the
    process's restored after the block. On f32 CUDA operands: TF32 off (the
    f32 function; PyTorch's default lets cuDNN round f32 operands to TF32)
    and benchmark mode on (cuDNN times its algorithms once for each new
    shape and keeps the fastest; with TF32 off its own heuristic picked FFT
    tilings for the 2D convs, 1.54 s of a 2D train step on an H100 against
    0.35 s). Other operands (bf16, or on the CPU) leave every setting
    alone."""
    if not (x.is_cuda and x.dtype == torch.float32):
        yield
        return
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.conv.fp32_precision
    cudnn.benchmark, cudnn.conv.fp32_precision = True, "ieee"
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.conv.fp32_precision = saved


_LIBRARY = {2: (F.conv2d, torch.channels_last),
            3: (F.conv3d, torch.channels_last_3d)}


class LibraryConv(torch.autograd.Function):
    """(xc, wc, b, stride, padding) -> cuDNN's conv of the NC* operands with
    the bias b (or None) added in the call, under :func:`cudnn_settings` in
    the forward and in the backward (one ``aten.convolution_backward`` call
    for dx, dw and db)."""

    @staticmethod
    def forward(ctx, xc, wc, b, stride, padding):
        with cudnn_settings(xc):
            y = _LIBRARY[xc.ndim - 2][0](xc, wc, b, stride=stride,
                                         padding=padding)
        ctx.save_for_backward(xc, wc)
        ctx.conf = (stride, padding, b is not None)
        return y

    @staticmethod
    def backward(ctx, ct):
        xc, wc = ctx.saved_tensors
        stride, padding, has_bias = ctx.conf
        nd = xc.ndim - 2
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        with cudnn_settings(xc):
            dx, dw, db = torch.ops.aten.convolution_backward(
                ct, xc, wc, [wc.shape[0]] if has_bias else None,
                [stride] * nd, list(padding), [1] * nd, False, [0] * nd, 1,
                (need_x, need_w, has_bias and need_b))
        return dx, dw, db, None, None


def wrap_pad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Circular pad of channels-last x (B, *spatial, C) by ``pads[d]``
    planes on both sides of spatial dim d, written once in x's layout: the
    last spatial dim and the channels are one flat dim, padded by
    ``pads[-1] * C`` elements."""
    B, *sp, C = x.shape
    flat = x.reshape(B, 1, *sp[:-1], sp[-1] * C)
    pad = [pads[-1] * C] * 2
    for p in reversed(pads[:-1]):
        pad += [p, p]
    y = F.pad(flat, pad, mode="circular")
    return y.reshape(B, *(n + 2 * p for n, p in zip(sp, pads)), C)


def _library_conv(x, w, b, stride, circular, pad_z=True):
    """:class:`LibraryConv` with symmetric (k//2) padding on channels-last
    x, bias b or None; ``pad_z=False`` leaves the first spatial dim unpadded (a haloed
    slab)."""
    nd = x.ndim - 2
    pads = [w.shape[0] // 2] * nd
    if not pad_z:
        pads[0] = 0
    if circular and any(pads):
        x = wrap_pad(x, pads)
        pads = [0] * nd
    xc = x.permute(0, nd + 1, *range(1, nd + 1))
    wc = w.to(x.dtype).permute(nd + 1, nd, *range(nd)).contiguous(
        memory_format=_LIBRARY[nd][1])
    y = LibraryConv.apply(xc, wc, None if b is None else b.to(x.dtype),
                          stride, tuple(pads))
    return y.permute(0, *range(2, nd + 2), 1).contiguous()


def conv_nd(
    x,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding_mode: str = "zeros",
    emit_stats: bool = False,
    residual: Optional[torch.Tensor] = None,
    ctx: ShardCtx = NO_SHARD,
):
    """y = conv(x, w) + b (+ residual), x (B, *spatial, Cin) with 2 or 3
    spatial dims. With ``emit_stats`` returns (y, sums), sums the (B, 2,
    Cout) f32 (sum y, sum y^2) where the 3D hand kernel produced y, else
    None. Under a sharded ``ctx`` x is this rank's slab of the split dim (D
    in 3D, H in 2D), and so are y and the sums."""
    if padding_mode not in ("zeros", "circular"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    if isinstance(x, Pair):
        ca = x.a.shape[-1]
        if w.shape[-2] != x.channels:
            raise ValueError(f"w {tuple(w.shape)} for {x.channels} channels")
        ya = conv_nd(x.a, w[..., :ca, :], b, stride, padding_mode,
                     residual=residual, ctx=ctx)
        return conv_nd(x.b, w[..., ca:, :], None, stride, padding_mode,
                       emit_stats=emit_stats, residual=ya, ctx=ctx)
    nd = x.ndim - 2
    if nd not in (2, 3) or w.ndim != x.ndim:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: need "
                         "(B, *spatial, C) and (*k, Cin, Cout), 2 or 3 "
                         "spatial dims")
    cin, cout = w.shape[-2], w.shape[-1]
    if x.shape[-1] != cin:
        raise ValueError(f"x has {x.shape[-1]} channels, w expects {cin}")
    k = w.shape[0]
    circular = padding_mode == "circular"
    sums = None
    if k == 1 and stride == 1 and supports(cin, cout):
        out = Conv1x1.apply(x, w, b, residual)
    elif nd == 3 and k == 3 and stride == 1 and supports(cin, cout):
        if ctx.sharded:
            x = halo_exchange(x, ctx, 1, 1, periodic=circular)
        out, sums = Conv3dK3S1.apply(x, w, b, residual, circular, emit_stats,
                                     ctx.sharded)
        if not emit_stats:
            sums = None
    else:
        if ctx.sharded and k > 1:
            x = halo_exchange(x, ctx, k // 2, k // 2, periodic=circular)
        out = _library_conv(x, w, b, stride, circular,
                            pad_z=not ctx.sharded)
        if residual is not None:
            out = out + residual
    return (out, sums) if emit_stats else out
