"""Down- and upsampling for the UNet: counterpart of
``vdm4cdm_tpu/ops/resample.py``.

Down: the stride-2 k3 convolution, which halves every spatial dim. Under
spatial sharding it runs on a slab extended by one halo plane on each side
(``ops/conv.py``), so each rank's share of D must be even: then rank r's
output planes are exactly the global output's planes r * D / 2 onwards.

Up: nearest-neighbour x2, purely local also under sharding (each slab
doubles in place); the k3 conv that follows is a ``Conv`` of its own.
"""

from __future__ import annotations

import torch

from ..parallel.halo import NO_SHARD, ShardCtx
from .conv import conv_nd


def downsample_conv(x: torch.Tensor, w: torch.Tensor, b=None,
                    padding_mode: str = "zeros",
                    ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Stride-2 conv of a channels-last (B, D, H, W, C) tensor (this rank's
    slab under a sharded ``ctx``)."""
    if ctx.sharded and x.shape[ctx.array_dim] % 2:
        raise ValueError(f"a rank's {x.shape[ctx.array_dim]} planes do not "
                         "halve: the local size must be even")
    return conv_nd(x, w, b, stride=2, padding_mode=padding_mode, ctx=ctx)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of a channels-last (B, D, H, W, C) tensor:
    one broadcast and one copy."""
    B, D, H, W, C = x.shape
    v = x[:, :, None, :, None, :, None, :]
    v = v.expand(B, D, factor, H, factor, W, factor, C)
    return v.reshape(B, D * factor, H * factor, W * factor, C).contiguous()
