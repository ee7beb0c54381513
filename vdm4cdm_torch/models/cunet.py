"""CUNet: the conditional 2D/3D UNet behind the VDM and the SFM, counterpart
of ``vdm4cdm_tpu/models/cunet.py``. The dimensionality comes from
``shape=(C, *spatial)``: (C, H, W) builds the 2D net, (C, D, H, W) the 3D.

Same constructor fields as the JAX module, same parameter names and layouts,
so a JAX params tree maps onto ``state_dict`` by name alone
(``interop/from_jax.py``):

  * activations are channels-last (B, *spatial, C) in ``compute_dtype``;
    embeddings, FiLM and the attention products stay f32; the output is f32;
  * conv kernels are (*k, Cin, Cout) with one k per spatial dim, dense
    kernels (in, out);
  * each ResBlock's first conv emits the GroupNorm sums that its second norm
    consumes where the 3D hand kernel runs it (a 2D conv is cuDNN's, and
    the norm takes its own sums), and its second conv adds the skip
    connection;
  * every decoder skip join stays lazy (:class:`~vdm4cdm_torch.ops.pair.Pair`):
    joint-statistics GroupNorm, then a weight-split conv;
  * in train mode each ResBlock drops activations after its second norm's
    SiLU, inside the norm kernel, with a mask that is a function of the
    block's seed and the element index (``ops/kernels/philox.py``). The
    block's seed is mixed on the host from the step's ``dropout_seed`` and
    the block's index: no device round trip;
  * ``remat`` / ``remat_levels`` / ``remat_blocks`` choose ResBlocks whose
    activations are not kept for the backward but recomputed
    (``torch.utils.checkpoint``): a block is checkpointed if ``remat and
    (remat_levels is None or level < remat_levels)`` or its name (``down_{l}_
    {b}``, ``mid_0``, ``mid_1``, ``up_{l}_{b}``; the bottleneck counts as the
    last level) is in ``remat_blocks``. The recomputed forward regenerates
    the same dropout mask from (seed, index), so no RNG state is kept;
  * ``ctx`` (a :class:`~vdm4cdm_torch.parallel.halo.ShardCtx`; 3D only, a
    2D net under a sharded one raises) splits the
    first spatial dim over the ``sp`` ranks, as the JAX module's ``ctx``
    does: every conv exchanges halo planes, every GroupNorm all-reduces its
    sums, the stride-2 downsamples need an even local size (so a rank's
    share of D must divide by 2^(levels - 1)), and the bottleneck attention
    gathers the whole field and takes its chunk back. Inputs and outputs
    are then this rank's slab.

Parameters initialize as the JAX module's do (LeCun-normal kernels, zero
biases, unit norm scales, zero ``conv_out``, second ResBlock convs and
attention ``proj``), drawn on the CPU from the optional ``generator`` and then
moved to ``device``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.conv import conv_nd
from ..ops.kernels.philox import mix_seed
from ..ops.norm import group_norm, group_norm_film
from ..ops.pair import Pair
from ..ops.resample import downsample_conv, upsample_nearest
from ..parallel.halo import (NO_SHARD, ShardCtx, all_gather_spatial,
                             take_local_spatial)

# flax's lecun_normal: a normal truncated at two deviations, rescaled to unit
# variance (the std of a standard normal truncated to [-2, 2])
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in, generator):
    t = torch.empty(shape)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return t


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_freq: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding of continuous t in [0, 1]: (B,) -> (B, dim) f32,
    on t's device."""
    half = dim // 2
    log_max = torch.log(torch.tensor([max_freq], dtype=torch.float32,
                                     device=t.device))
    # linspace(0, log_max, half) as jnp.linspace forms it: iota * delta,
    # with the endpoint exact
    if half > 1:
        iota = torch.arange(half - 1, dtype=torch.float32, device=t.device)
        exponents = torch.cat([iota * (log_max / (half - 1)), log_max])
    else:
        exponents = torch.zeros(half, device=t.device)
    freqs = torch.exp(exponents)
    ang = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class Dense(nn.Module):
    """y = x @ kernel + bias with kernel (in, out), in f32."""

    def __init__(self, din: int, dout: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal((din, dout), din, generator))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x):
        return x.float() @ self.kernel + self.bias


class Conv(nn.Module):
    """Parameters of an ``nd``-dimensional (*(k,) * nd, Cin, Cout) conv;
    compute in ``conv_nd``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding_mode: str = "zeros", zero_init: bool = False,
                 generator=None, ctx: ShardCtx = NO_SHARD, nd: int = 3):
        super().__init__()
        shape = (k,) * nd + (cin, cout)
        w = (torch.zeros(shape) if zero_init
             else _lecun_normal(shape, k ** nd * cin, generator))
        self.kernel = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.padding_mode = padding_mode
        self.ctx = ctx

    def forward(self, x, emit_stats: bool = False, residual=None):
        if self.stride == 2:
            return downsample_conv(x, self.kernel, self.bias,
                                   padding_mode=self.padding_mode,
                                   ctx=self.ctx)
        return conv_nd(x, self.kernel, self.bias, stride=self.stride,
                       padding_mode=self.padding_mode, emit_stats=emit_stats,
                       residual=residual, ctx=self.ctx)


class GroupNorm(nn.Module):
    """GroupNorm with an optional FiLM (scale, shift) and SiLU."""

    def __init__(self, channels: int, groups: int, act: Optional[str] = None,
                 ctx: ShardCtx = NO_SHARD):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups = groups
        self.act = act
        self.ctx = ctx

    def forward(self, x, film=None, ext_sums=None, dropout_p: float = 0.0,
                dropout_seed: Optional[int] = None):
        if film is None and dropout_p == 0.0:
            return group_norm(x, self.scale, self.bias, self.groups,
                              act=self.act, ext_sums=ext_sums, ctx=self.ctx)
        if film is None:
            bsz = x.a.shape[0] if isinstance(x, Pair) else x.shape[0]
            zero = torch.zeros(bsz, self.scale.shape[0],
                               device=self.scale.device)
            film = (zero, zero)
        return group_norm_film(x, self.scale, self.bias, film[0], film[1],
                               self.groups, act=self.act, ext_sums=ext_sums,
                               dropout_p=dropout_p,
                               dropout_seed=dropout_seed, ctx=self.ctx)


class ResBlock(nn.Module):
    """GroupNorm -> SiLU -> conv -> FiLM(emb) GroupNorm -> SiLU -> conv, plus
    a (1x1-projected) skip connection. ``x`` may be a Pair."""

    def __init__(self, cin: int, features: int, norm_groups: int,
                 dropout_prob: float, padding_mode: str,
                 emb_dim: Optional[int], generator=None,
                 ctx: ShardCtx = NO_SHARD, nd: int = 3):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.GroupNorm_0 = GroupNorm(cin, norm_groups, act="silu", ctx=ctx)
        self.Conv_0 = Conv(cin, features, 3, padding_mode=padding_mode,
                           generator=generator, ctx=ctx, nd=nd)
        self.film = (Dense(emb_dim, 2 * features, generator)
                     if emb_dim else None)
        self.GroupNorm_1 = GroupNorm(features, norm_groups, act="silu",
                                     ctx=ctx)
        self.Conv_1 = Conv(features, features, 3, padding_mode=padding_mode,
                           zero_init=True, ctx=ctx, nd=nd)
        self.skip_proj = (Conv(cin, features, 1, generator=generator,
                               ctx=ctx, nd=nd)
                          if cin != features else None)

    def forward(self, x, emb, train: bool = False,
                dropout_seed: Optional[int] = None):
        p = self.dropout_prob if train else 0.0
        if p > 0.0 and dropout_seed is None:
            raise ValueError("train=True with dropout needs a dropout_seed")
        h = self.GroupNorm_0(x)
        # conv1 emits the GroupNorm sums of its output: the second norm skips
        # its sums pass
        h, hsums = self.Conv_0(h, emit_stats=True)
        film = None
        if self.film is not None and emb is not None:
            film = self.film(F.silu(emb)).chunk(2, dim=-1)
        h = self.GroupNorm_1(h, film=film, ext_sums=hsums, dropout_p=p,
                             dropout_seed=dropout_seed)
        if self.skip_proj is not None:
            skip = self.skip_proj(x)
        elif isinstance(x, Pair):
            skip = x.materialize()
        else:
            skip = x
        return self.Conv_1(h, residual=skip)


class AttentionBlock(nn.Module):
    """Self-attention over all voxels (pixels in 2D), used at the bottleneck
    (``mid_attn``).
    qkv kernel (C, 3, heads, hd), proj kernel (heads, hd, C); the products
    run in f32 as flax promotes them. Under a sharded ``ctx`` every rank
    gathers the normalized field, attends over all of it and keeps its own
    chunk of the result (``cunet.py:216-227`` of the JAX package)."""

    def __init__(self, channels: int, num_heads: int, norm_groups: int,
                 generator=None, ctx: ShardCtx = NO_SHARD):
        super().__init__()
        hd = channels // num_heads
        self.num_heads = num_heads
        self.ctx = ctx
        self.GroupNorm_0 = GroupNorm(channels, norm_groups, ctx=ctx)
        self.qkv = nn.Module()
        self.qkv.kernel = nn.Parameter(_lecun_normal(
            (channels, 3, num_heads, hd), channels, generator))
        self.qkv.bias = nn.Parameter(torch.zeros(3, num_heads, hd))
        self.proj = nn.Module()
        self.proj.kernel = nn.Parameter(torch.zeros(num_heads, hd, channels))
        self.proj.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        B, C = x.shape[0], x.shape[-1]
        h = all_gather_spatial(self.GroupNorm_0(x), self.ctx)
        full = h.shape
        seq = h.reshape(B, -1, C).float()
        qkv = seq @ self.qkv.kernel.reshape(C, -1) + self.qkv.bias.reshape(-1)
        qkv = qkv.reshape(B, seq.shape[1], 3, self.num_heads, -1)
        q, k, v = qkv.unbind(2)  # (B, T, heads, hd)
        logits = torch.einsum("btnh,bsnh->bnts", q, k) / math.sqrt(q.shape[-1])
        attn = torch.einsum("bnts,bsnh->btnh", logits.softmax(-1), v)
        out = (attn.reshape(B, seq.shape[1], -1)
               @ self.proj.kernel.reshape(-1, C) + self.proj.bias)
        out = take_local_spatial(out.reshape(full), self.ctx)
        return x + out.to(x.dtype)


class CUNet(nn.Module):
    """``shape`` is (C_out, *spatial), the whole field's, with 2 or 3
    spatial dims; inputs and outputs are channels-last (this rank's slab
    under a sharded ``ctx``, 3D only). ``device=None`` means CUDA (and
    raises without it)."""

    def __init__(
        self,
        shape: Tuple[int, ...],
        chs: Sequence[int] = (48, 96, 192, 384),
        s_conditioning_channels: int = 0,
        v_conditioning_dims: Sequence[int] = (),
        t_conditioning: bool = True,
        norm_groups: int = 8,
        mid_attn: bool = False,
        n_attention_heads: int = 4,
        dropout_prob: float = 0.1,
        conv_padding_mode: str = "zeros",
        num_res_blocks: int = 2,
        compute_dtype: torch.dtype = torch.float32,
        remat: bool = False,
        remat_levels: Optional[int] = None,
        remat_blocks: Sequence[str] = (),
        device=None,
        generator: Optional[torch.Generator] = None,
        ctx: ShardCtx = NO_SHARD,
    ):
        super().__init__()
        dev = resolve_device(device)
        if len(shape) not in (3, 4):
            raise ValueError(f"shape {tuple(shape)}: need (C, H, W) or "
                             "(C, D, H, W)")
        nd = len(shape) - 1
        if nd == 2 and ctx.sharded:
            raise NotImplementedError("a 2D CUNet under sp sharding is not "
                                      "ported yet (ROADMAP.md, queue 1)")
        self.shape = tuple(shape)
        self.chs = tuple(chs)
        self.s_conditioning_channels = s_conditioning_channels
        self.v_conditioning_dims = tuple(v_conditioning_dims)
        self.t_conditioning = t_conditioning
        self.norm_groups = norm_groups
        self.mid_attn = mid_attn
        self.dropout_prob = dropout_prob
        self.conv_padding_mode = conv_padding_mode
        self.num_res_blocks = num_res_blocks
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.remat_levels = remat_levels
        self.remat_blocks = tuple(remat_blocks)
        self.ctx = ctx

        g, pm, ng = generator, conv_padding_mode, norm_groups
        c0 = self.chs[0]
        emb_dim = 4 * c0 if (t_conditioning or self.v_conditioning_dims) \
            else None
        if t_conditioning:
            self.t_dense0 = Dense(c0, emb_dim, g)
            self.t_dense1 = Dense(emb_dim, emb_dim, g)
        for i, d in enumerate(self.v_conditioning_dims):
            self.add_module(f"v_dense0_{i}", Dense(d, emb_dim, g))
            self.add_module(f"v_dense1_{i}", Dense(emb_dim, emb_dim, g))

        def res(name, cin, cout):
            self.add_module(name, ResBlock(cin, cout, ng, dropout_prob, pm,
                                           emb_dim, g, ctx, nd))

        self.conv_in = Conv(shape[0] + s_conditioning_channels, c0, 3,
                            padding_mode=pm, generator=g, ctx=ctx, nd=nd)
        skips, h = [c0], c0
        for level, ch in enumerate(self.chs):
            for blk in range(num_res_blocks):
                res(f"down_{level}_{blk}", h, ch)
                h = ch
                skips.append(h)
            if level < len(self.chs) - 1:
                self.add_module(f"downsample_{level}",
                                Conv(ch, ch, 3, stride=2, padding_mode=pm,
                                     generator=g, ctx=ctx, nd=nd))
                skips.append(ch)
        res("mid_0", h, self.chs[-1])
        if mid_attn:
            self.mid_attn_block = AttentionBlock(self.chs[-1],
                                                 n_attention_heads, ng, g,
                                                 ctx)
        res("mid_1", self.chs[-1], self.chs[-1])
        h = self.chs[-1]
        for level, ch in reversed(list(enumerate(self.chs))):
            for blk in range(num_res_blocks + 1):
                res(f"up_{level}_{blk}", h + skips.pop(), ch)
                h = ch
            if level > 0:
                self.add_module(f"upsample_{level}",
                                Conv(ch, ch, 3, padding_mode=pm, generator=g,
                                     ctx=ctx, nd=nd))
        self.norm_out = GroupNorm(h, ng, act="silu", ctx=ctx)
        self.conv_out = Conv(h, shape[0], 3, padding_mode=pm, zero_init=True,
                             ctx=ctx, nd=nd)
        self.to(dev)

    def _block_levels(self):
        """(name, level) of every ResBlock, in the order the forward runs
        them; the bottleneck blocks count as the last level."""
        last = len(self.chs) - 1
        for level in range(len(self.chs)):
            for blk in range(self.num_res_blocks):
                yield f"down_{level}_{blk}", level
        yield "mid_0", last
        yield "mid_1", last
        for level in reversed(range(len(self.chs))):
            for blk in range(self.num_res_blocks + 1):
                yield f"up_{level}_{blk}", level

    def remat_block_names(self) -> Tuple[str, ...]:
        """The ResBlocks that a differentiated forward checkpoints."""
        def use(name, level):
            by_level = self.remat and (self.remat_levels is None
                                       or level < self.remat_levels)
            return by_level or name in self.remat_blocks
        return tuple(n for n, lv in self._block_levels() if use(n, lv))

    def forward(
        self,
        z: torch.Tensor,
        t: Optional[torch.Tensor] = None,
        s_conditioning: Optional[torch.Tensor] = None,
        v_conditionings: Sequence[torch.Tensor] = (),
        train: bool = False,
        dropout_seed: Optional[int] = None,
    ) -> torch.Tensor:
        """z (B, *spatial, C); t (B,) or scalar in [0, 1]; s_conditioning
        (B, *spatial, Cs); v_conditionings list of (B, d_i). ``train=True``
        turns dropout on and then needs the step's integer ``dropout_seed``.
        Returns f32 (B, *spatial, C)."""
        if train and self.dropout_prob > 0.0 and dropout_seed is None:
            raise ValueError("train=True with dropout needs a dropout_seed")
        if self.s_conditioning_channels:
            if s_conditioning is None:
                raise ValueError("model expects s_conditioning")
            if s_conditioning.shape[-1] != self.s_conditioning_channels:
                raise ValueError("s_conditioning has "
                                 f"{s_conditioning.shape[-1]} channels")
            z = torch.cat([z, s_conditioning.to(z.dtype)], dim=-1)
        if len(v_conditionings) != len(self.v_conditioning_dims):
            raise ValueError(
                f"expected {len(self.v_conditioning_dims)} v_conditionings, "
                f"got {len(v_conditionings)}")
        x = z.to(self.compute_dtype).contiguous()
        bsz = x.shape[0]
        halvings = 2 ** (len(self.chs) - 1)
        if self.ctx.sharded and x.shape[1] % halvings:
            raise ValueError(
                f"a rank's {x.shape[1]} planes do not divide by {halvings}: "
                f"the {len(self.chs) - 1} downsamples need an even slab")

        emb = None
        if self.t_conditioning:
            if t is None:
                raise ValueError("model expects t conditioning")
            tt = torch.as_tensor(t, dtype=torch.float32, device=x.device)
            tt = tt.reshape(-1) * torch.ones(bsz, device=x.device)
            temb = self.t_dense0(timestep_embedding(tt, self.chs[0]))
            emb = self.t_dense1(F.silu(temb))
        for i, (v, d) in enumerate(zip(v_conditionings,
                                       self.v_conditioning_dims)):
            if v.shape[-1] != d:
                raise ValueError(f"v_conditioning {i} dim {v.shape[-1]} != {d}")
            vemb = getattr(self, f"v_dense0_{i}")(v)
            vemb = getattr(self, f"v_dense1_{i}")(F.silu(vemb))
            emb = vemb if emb is None else emb + vemb

        n_blocks = 0
        rematted = (self.remat_block_names() if torch.is_grad_enabled()
                    else ())

        def block(name, h):
            nonlocal n_blocks
            seed = None
            if train and self.dropout_prob > 0.0:
                seed = mix_seed(int(dropout_seed), n_blocks)
            n_blocks += 1
            if name in rematted:
                return checkpoint(getattr(self, name), h, emb, train, seed,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            return getattr(self, name)(h, emb, train, seed)

        h = self.conv_in(x)
        skips = [h]
        for level in range(len(self.chs)):
            for blk in range(self.num_res_blocks):
                h = block(f"down_{level}_{blk}", h)
                skips.append(h)
            if level < len(self.chs) - 1:
                h = getattr(self, f"downsample_{level}")(h)
                skips.append(h)
        h = block("mid_0", h)
        if self.mid_attn:
            h = self.mid_attn_block(h)
        h = block("mid_1", h)
        for level in reversed(range(len(self.chs))):
            for blk in range(self.num_res_blocks + 1):
                h = block(f"up_{level}_{blk}", Pair(h, skips.pop()))
            if level > 0:
                h = getattr(self, f"upsample_{level}")(upsample_nearest(h))
        h = self.norm_out(h)
        return self.conv_out(h).float()
