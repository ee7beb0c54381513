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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .kernels import (conv3d_k3s1_dw, conv3d_k3s1_dx, conv3d_k3s1_fwd,
                      mm1x1_dw, mm1x1_dx, mm1x1_fwd)
from .kernels.conv3d import supports
from .pair import Pair


class Conv3dK3S1(torch.autograd.Function):
    """(x, w, bias, residual) -> (y, sums) through ``conv3d_k3s1_fwd``.

    Backward, as the JAX package's ``_bs_bwd_core``: the output gradient is
    cast to x's dtype; dx is the forward kernel on it with flipped, transposed
    weights; (dw, db) come from ``conv3d_k3s1_dw`` in f32 and return in the
    parameters' dtypes; the residual's gradient is the output gradient itself.
    ``sums`` exists to feed the following GroupNorm, whose dx already carries
    the whole statistics -> x dependence, so it is non-differentiable."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, circular, with_sums):
        with torch.no_grad():
            y, sums = conv3d_k3s1_fwd(x, w, bias, residual, circular=circular,
                                      with_sums=with_sums)
        ctx.save_for_backward(x, w)
        ctx.circular = circular
        ctx.bias_dtype = None if bias is None else bias.dtype
        if sums is None:
            sums = x.new_empty(0)
        ctx.mark_non_differentiable(sums)
        return y, sums

    @staticmethod
    def backward(ctx, ct, _ct_sums):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        ct = ct.to(x.dtype).contiguous()
        dx = conv3d_k3s1_dx(ct, w, ctx.circular) if need_x else None
        dw = db = None
        if need_w or need_b:
            dw, db = conv3d_k3s1_dw(x, ct, ctx.circular)
            dw = dw.to(w.dtype) if need_w else None
            db = db.to(ctx.bias_dtype) if need_b else None
        return dx, dw, db, (ct if need_r else None), None, None


class Conv1x1(torch.autograd.Function):
    """(x, w, bias, residual) -> y through ``mm1x1_fwd``, w in the conv
    layout (1, 1, 1, Cin, Cout).

    Backward, as the JAX package's ``lane_matmul``: the output gradient is
    cast to x's dtype; dx is the forward kernel on it with the transposed
    weight; (dw, db) come from ``mm1x1_dw`` in f32 and return in the
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


def _library_conv(x, w, stride, circular):
    xc = x.permute(0, 4, 1, 2, 3)
    wc = w.to(x.dtype).permute(4, 3, 0, 1, 2)
    pad = w.shape[0] // 2
    if circular and pad:
        y = F.conv3d(F.pad(xc, (pad,) * 6, mode="circular"), wc,
                     stride=stride)
    else:
        y = F.conv3d(xc, wc, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv_nd(
    x,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding_mode: str = "zeros",
    emit_stats: bool = False,
    residual: Optional[torch.Tensor] = None,
):
    """y = conv(x, w) + b (+ residual). With ``emit_stats`` returns
    (y, sums), sums the (B, 2, Cout) f32 (sum y, sum y^2) where the hand
    kernel produced y, else None."""
    if padding_mode not in ("zeros", "circular"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    if isinstance(x, Pair):
        ca = x.a.shape[-1]
        if w.shape[-2] != x.channels:
            raise ValueError(f"w {tuple(w.shape)} for {x.channels} channels")
        ya = conv_nd(x.a, w[..., :ca, :], b, stride, padding_mode,
                     residual=residual)
        return conv_nd(x.b, w[..., ca:, :], None, stride, padding_mode,
                       emit_stats=emit_stats, residual=ya)
    if x.ndim != 5 or w.ndim != 5:
        raise NotImplementedError("the port runs 3D convolutions only")
    cin, cout = w.shape[-2], w.shape[-1]
    if x.shape[-1] != cin:
        raise ValueError(f"x has {x.shape[-1]} channels, w expects {cin}")
    k = w.shape[0]
    sums = None
    if k == 1 and stride == 1 and supports(cin, cout):
        out = Conv1x1.apply(x, w, b, residual)
    elif k == 3 and stride == 1 and supports(cin, cout):
        out, sums = Conv3dK3S1.apply(x, w, b, residual,
                                     padding_mode == "circular", emit_stats)
        if not emit_stats:
            sums = None
    else:
        out = _library_conv(x, w, stride, padding_mode == "circular")
        if b is not None:
            out = out + b.to(out.dtype)
        if residual is not None:
            out = out + residual
    return (out, sums) if emit_stats else out
