"""Channels-last 3D convolution: counterpart of ``vdm4cdm_tpu/ops/conv.py``.

``conv_nd`` takes x (B, D, H, W, Cin) or a :class:`Pair` and weights in the
JAX layout (k, k, k, Cin, Cout):

  * k3/s1 with Cin, Cout multiples of 8 runs the hand kernel
    ``conv3d_k3s1_fwd`` (bias in-kernel, optional GroupNorm sums of the output,
    optional residual added before the cast) through :class:`Conv3dK3S1`,
    whose backward is hand kernels too: the forward kernel on the output
    gradient for dx, ``conv3d_k3s1_dw`` for dw and db;
  * a Pair splits the weights over its halves, conv(concat(a, b), W) =
    conv(a, W_a) + conv(b, W_b): the second half's conv takes the first
    half's output as its residual, so the joined input is never written and
    the joined output's sums still come from the kernel;
  * k1/s1 (the ResBlock ``skip_proj``) with Cin, Cout multiples of 8 runs
    the hand kernel ``mm1x1_fwd`` (bias and the optional residual added
    in-kernel before the one cast) through :class:`Conv1x1`, whose backward
    is ``mm1x1_dx`` (the forward kernel on the transposed weight) and
    ``mm1x1_dw``; over a Pair the second half's product takes the first
    half's output as its residual, as for k3;
  * everything else (``conv_in`` 2->32, ``conv_out`` 32->1, the stride-2
    downsample, a k1 outside the multiples of 8) goes to ``torch.nn.functional.conv3d``, as the JAX package
    leaves these to XLA. Circular padding there is an explicit wrap pad and a
    valid conv; padding is the torch-style symmetric (k//2, k//2).

Under spatial sharding (a sharded ``ctx``, ``vdm4cdm_tpu/ops/conv.py:111-150``)
the split dim D is not padded locally: the slab is extended by the
neighbours' halo planes (``parallel.halo.halo_exchange``) and the conv runs
valid in z, padded in-plane only:

  * k3/s1 with supported channels: a (1, 1) halo, then the z-halo kernels
    through :class:`Conv3dK3S1` with ``zhalo`` (bias, residual and the
    slab's own sums in-kernel; dx and dw are z-halo kernels too, and the
    halo exchange's backward returns the halo planes' gradient to the
    neighbours). On a CUDA tensor it launches them or raises: no library
    conv stands in;
  * k1: no halo, as unsharded;
  * everything else (``conv_in``, ``conv_out``, the stride-2 downsample, a k3
    outside the multiples of 8): a (k//2, k//2) halo, then
    ``torch.nn.functional.conv3d`` valid in z and padded in H and W (a wrap
    pad for circular).
"""

from __future__ import annotations

from typing import Optional

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


def _library_conv(x, w, stride, circular, pad_z=True):
    """``F.conv3d`` with symmetric (k//2) padding; ``pad_z=False`` leaves D
    unpadded (a haloed slab) and pads H and W only."""
    xc = x.permute(0, 4, 1, 2, 3)
    wc = w.to(x.dtype).permute(4, 3, 0, 1, 2)
    pad = w.shape[0] // 2
    pz = pad if pad_z else 0
    if circular and pad:
        y = F.conv3d(F.pad(xc, (pad, pad, pad, pad, pz, pz),
                           mode="circular"), wc, stride=stride)
    else:
        y = F.conv3d(xc, wc, stride=stride, padding=(pz, pad, pad))
    return y.permute(0, 2, 3, 4, 1).contiguous()


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
    """y = conv(x, w) + b (+ residual). With ``emit_stats`` returns
    (y, sums), sums the (B, 2, Cout) f32 (sum y, sum y^2) where the hand
    kernel produced y, else None. Under a sharded ``ctx`` x is this rank's
    slab of the split dim D, and so are y and the sums."""
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
    if x.ndim != 5 or w.ndim != 5:
        raise NotImplementedError("the port runs 3D convolutions only")
    cin, cout = w.shape[-2], w.shape[-1]
    if x.shape[-1] != cin:
        raise ValueError(f"x has {x.shape[-1]} channels, w expects {cin}")
    k = w.shape[0]
    circular = padding_mode == "circular"
    sums = None
    if k == 1 and stride == 1 and supports(cin, cout):
        out = Conv1x1.apply(x, w, b, residual)
    elif k == 3 and stride == 1 and supports(cin, cout):
        if ctx.sharded:
            x = halo_exchange(x, ctx, 1, 1, periodic=circular)
        out, sums = Conv3dK3S1.apply(x, w, b, residual, circular, emit_stats,
                                     ctx.sharded)
        if not emit_stats:
            sums = None
    else:
        if ctx.sharded and k > 1:
            x = halo_exchange(x, ctx, k // 2, k // 2, periodic=circular)
        out = _library_conv(x, w, stride, circular, pad_z=not ctx.sharded)
        if b is not None:
            out = out + b.to(out.dtype)
        if residual is not None:
            out = out + residual
    return (out, sums) if emit_stats else out
