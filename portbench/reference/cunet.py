"""A plain float32 UNet: the conditional 2D/3D UNet of the VDM written out in
torch operations, from the architecture that ``Arch`` states.

Parameters are a mapping of names to tensors, in the layout of the
reference's JAX tree: conv kernels (*k, Cin, Cout), dense kernels (in, out),
GroupNorm ``scale`` / ``bias`` (C,). Activations are channels-last
(B, *spatial, C). The network, level by level:

    conv_in -> [ResBlock x n_res, stride-2 conv] per level -> mid ResBlock,
    (attention), mid ResBlock -> [ResBlock(concat(h, skip)) x (n_res + 1),
    nearest x2 then conv] per level -> GroupNorm, SiLU -> conv_out

A ResBlock is GroupNorm -> SiLU -> conv -> GroupNorm with FiLM (scale, shift)
from the embedding -> SiLU -> dropout -> conv, plus the input (through a 1x1
conv where the widths differ). The embedding is a sinusoidal one of t through
two dense layers, plus each conditioning vector through two dense layers.
GroupNorm has eps 1e-6. A stride-2 conv pads (1, 1), as every k3 conv does.

``prec`` says how the products are computed: "f32" in float32 (TF32 off);
"tf32" with the operands of every conv and dense layer rounded to TF32's 10
mantissa bits, as TF32 tensor cores take them; "fp8" with those operands
rounded to float8 e4m3 under a per-tensor scale. The two lower ones are the
controls of the benchmark's output check; their rounding is explicit, so
they read the same on any device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .philox import keep_mask, mix_seed

Params = Dict[str, torch.Tensor]
_FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Arch:
    ndim: int
    size: int
    in_channels: int
    s_channels: int
    v_dims: Sequence[int]
    chs: Sequence[int]
    groups: int
    dropout: float
    n_res: int
    circular: bool
    mid_attn: bool = False
    heads: int = 4

    @classmethod
    def from_config(cls, cfg: dict) -> "Arch":
        """From a benchmark configuration file's dict."""
        m, d = cfg["config"]["model"], cfg["config"]["data"]
        return cls(ndim=m["ndim"], size=d["cropsize"],
                   in_channels=m["input_channels"],
                   s_channels=1 if d["in_field"] else 0,
                   v_dims=((d["conditioning_values"],)
                           if d["conditioning_values"] else ()),
                   chs=tuple(m["chs"]), groups=m["norm_groups"],
                   dropout=m["dropout_prob"], n_res=m["num_res_blocks"],
                   circular=cfg["padding"] == "circular",
                   mid_attn=m["mid_attn"], heads=m["n_attention_heads"])


@contextlib.contextmanager
def precision(prec: str):
    """float32 products with TF32 off (the lower precisions round their
    operands explicitly); the process's settings restored after."""
    if prec not in ("f32", "tf32", "fp8"):
        raise ValueError(f"unknown precision {prec!r}")
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = conv.fp32_precision, mm.fp32_precision
    conv.fp32_precision, mm.fp32_precision = "ieee", "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, mm.fp32_precision = saved


class _Round(torch.autograd.Function):
    """x rounded to a lower precision; the gradient passes straight
    through, and a product's backward takes the rounded operand it saved."""

    @staticmethod
    def forward(ctx, x, prec):
        v = x.detach()
        if prec == "tf32":
            # round to nearest at 10 mantissa bits (the low 13 of 23 cleared)
            bits = v.contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view(
                v.shape)
        s = _FP8_MAX / v.abs().amax().clamp(min=1e-30)
        r = (v * s).to(torch.float8_e4m3fn).to(torch.float32)
        return r.div_(s)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _q(x: torch.Tensor, prec: str) -> torch.Tensor:
    return x if prec == "f32" else _Round.apply(x, prec)


def conv(x, w, b, prec: str, circular: bool, stride: int = 1):
    """k x k (x k) conv of channels-last x with a (*k, Cin, Cout) kernel,
    padded by k // 2 (zeros or wrapped)."""
    nd = x.ndim - 2
    xc = x.movedim(-1, 1)
    wc = w.permute(nd + 1, nd, *range(nd))
    p = w.shape[0] // 2
    pad = p
    if circular and p:
        xc = F.pad(xc, [p] * (2 * nd), mode="circular")
        pad = 0
    fn = F.conv3d if nd == 3 else F.conv2d
    y = fn(_q(xc, prec), _q(wc, prec), b, stride=stride, padding=pad)
    return y.movedim(1, -1)


def dense(x, params: Params, name: str, prec: str):
    return _q(x, prec) @ _q(params[name + ".kernel"], prec) + \
        params[name + ".bias"]


def norm_act(x, scale, bias, groups: int, act: bool, film=None,
             drop: Optional[tuple] = None, masks: Optional[dict] = None):
    """GroupNorm of channels-last x over (spatial, C / groups), then
    * scale + bias (with FiLM: * (1 + fs) and + fsh), SiLU, dropout
    ``drop = (seed, p, row)``, x being rows ``row`` onwards of the batch
    whose (B, S, C) stream the mask indexes; ``masks`` keeps each seed's
    mask for a recomputation."""
    B, C = x.shape[0], x.shape[-1]
    xs = x.reshape(B, -1, groups, C // groups)
    var, mean = torch.var_mean(xs, dim=(1, 3), keepdim=True,
                               unbiased=False)
    xhat = ((xs - mean) * torch.rsqrt(var + 1e-6)).reshape(B, -1, C)
    a, b = scale[None, None], bias[None, None]
    if film is not None:
        fs, fsh = film
        a = a * (1.0 + fs[:, None])
        b = b * (1.0 + fs[:, None]) + fsh[:, None]
    y = xhat * a + b
    if act:
        y = F.silu(y)
    if drop is not None:
        seed, p, row = drop
        keep = None if masks is None else masks.get(seed)
        if keep is None:
            keep = keep_mask(seed, y.shape, p, y.device,
                             first=row * y[0].numel())
            if masks is not None:
                masks[seed] = keep
        y = torch.where(keep, y * (1.0 / (1.0 - p)), 0.0)
    return y.reshape(x.shape)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.linspace(0.0, math.log(1000.0), half,
                                     device=t.device))
    ang = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return F.pad(emb, (0, dim % 2))


def _res_block(arch: Arch, params: Params, name: str, x, emb, prec: str,
               seed: Optional[int], masks: dict, row: int):
    p = f"score_model.{name}."
    h = norm_act(x, params[p + "GroupNorm_0.scale"],
                 params[p + "GroupNorm_0.bias"], arch.groups, True)
    h = conv(h, params[p + "Conv_0.kernel"], params[p + "Conv_0.bias"], prec,
             arch.circular)
    film = dense(F.silu(emb), params, p + "film", prec).chunk(2, dim=-1)
    drop = None if seed is None else (seed, arch.dropout, row)
    h = norm_act(h, params[p + "GroupNorm_1.scale"],
                 params[p + "GroupNorm_1.bias"], arch.groups, True, film=film,
                 drop=drop, masks=masks)
    skip = x
    if p + "skip_proj.kernel" in params:
        skip = conv(x, params[p + "skip_proj.kernel"],
                    params[p + "skip_proj.bias"], prec, arch.circular)
    return conv(h, params[p + "Conv_1.kernel"], params[p + "Conv_1.bias"],
                prec, arch.circular) + skip


def _attention(arch: Arch, params: Params, x, prec: str):
    p = "score_model.mid_attn_block."
    B, C = x.shape[0], x.shape[-1]
    h = norm_act(x, params[p + "GroupNorm_0.scale"],
                 params[p + "GroupNorm_0.bias"], arch.groups, False)
    seq = h.reshape(B, -1, C)
    qkv = _q(seq, prec) @ _q(params[p + "qkv.kernel"].reshape(C, -1), prec)
    qkv = (qkv + params[p + "qkv.bias"].reshape(-1)).reshape(
        B, seq.shape[1], 3, arch.heads, -1)
    q, k, v = qkv.unbind(2)
    logits = torch.einsum("btnh,bsnh->bnts", q, k) / math.sqrt(q.shape[-1])
    att = torch.einsum("bnts,bsnh->btnh", logits.softmax(-1), v)
    out = _q(att.reshape(B, seq.shape[1], -1), prec) @ _q(
        params[p + "proj.kernel"].reshape(-1, C), prec) + params[p + "proj.bias"]
    return x + out.reshape(x.shape)


def unet(arch: Arch, params: Params, z, t, s_cond=None, v_conds=(),
         prec: str = "f32", dropout_seed: Optional[int] = None,
         remat: bool = False, row: int = 0):
    """eps_hat of channels-last z at times t (B,). ``dropout_seed`` (the
    step's) turns dropout on, z being rows ``row`` onwards of the batch the
    masks were drawn for (every sample is computed alone: GroupNorm is per
    sample); ``remat`` recomputes each ResBlock in the backward (the same
    function; it bounds memory, and the dropout masks of the forward are
    kept for it)."""
    sm = "score_model."
    x = z.float()
    if arch.s_channels:
        x = torch.cat([x, s_cond.float()], dim=-1)
    t = t.float().reshape(-1) * torch.ones(x.shape[0], device=x.device)
    c0 = arch.chs[0]
    emb = dense(timestep_embedding(t, c0), params, sm + "t_dense0", prec)
    emb = dense(F.silu(emb), params, sm + "t_dense1", prec)
    for i, v in enumerate(v_conds):
        e = dense(v.float(), params, sm + f"v_dense0_{i}", prec)
        emb = emb + dense(F.silu(e), params, sm + f"v_dense1_{i}", prec)

    n_block = 0
    masks: dict = {}

    def block(name, h):
        nonlocal n_block
        seed = (None if dropout_seed is None or arch.dropout == 0.0
                else mix_seed(int(dropout_seed), n_block))
        n_block += 1
        if remat and torch.is_grad_enabled():
            return checkpoint(_res_block, arch, params, name, h, emb, prec,
                              seed, masks, row, use_reentrant=False)
        return _res_block(arch, params, name, h, emb, prec, seed, masks, row)

    def k3(name, h, stride=1):
        return conv(h, params[sm + name + ".kernel"],
                    params[sm + name + ".bias"], prec, arch.circular, stride)

    h = k3("conv_in", x)
    skips = [h]
    for lv in range(len(arch.chs)):
        for b in range(arch.n_res):
            h = block(f"down_{lv}_{b}", h)
            skips.append(h)
        if lv < len(arch.chs) - 1:
            h = k3(f"downsample_{lv}", h, stride=2)
            skips.append(h)
    h = block("mid_0", h)
    if arch.mid_attn:
        h = _attention(arch, params, h, prec)
    h = block("mid_1", h)
    for lv in reversed(range(len(arch.chs))):
        for b in range(arch.n_res + 1):
            h = block(f"up_{lv}_{b}", torch.cat([h, skips.pop()], dim=-1))
        if lv > 0:
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            if arch.ndim == 3:
                h = h.repeat_interleave(2, dim=3)
            h = k3(f"upsample_{lv}", h)
    h = norm_act(h, params[sm + "norm_out.scale"],
                 params[sm + "norm_out.bias"], arch.groups, True)
    return k3("conv_out", h)
