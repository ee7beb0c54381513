"""GroupNorm with a fused per-(batch, channel) affine and SiLU.

Counterpart of ``vdm4cdm_tpu/ops/norm.py``. Every normalization site of the
UNet is

    y = act(groupnorm(x) * a + b),   a, b (B, C)

with a = gamma, b = beta for a plain GroupNorm and a = gamma * (1 + fs),
b = beta * (1 + fs) + fsh at the FiLM site. Each site is one ``gn_sums`` pass
over x (skipped when the producing conv emitted the sums), a finalize on the
tiny (B, 2, C) sums in torch, and one ``gn_apply`` pass. A :class:`Pair`
(lazy skip concat) is normalized with joint group statistics over its two
halves, which may straddle the boundary, and stays a pair.

Statistics: f32 sums, eps 1e-6, variance clamped at 0 (the sum-based
variance of a near-constant group can come out negative in f32).
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import gn_apply, gn_sums
from .pair import Pair


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _finalize(sums: torch.Tensor, groups: int, count: float, eps: float):
    """(B, 2, C) sums -> per-channel (mean, inv) (B, C), f32."""
    B, _, C = sums.shape
    g = sums.reshape(B, 2, groups, C // groups).sum(-1)
    mean = g[:, 0] / count
    var = torch.clamp(g[:, 1] / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    rep = C // groups
    return mean.repeat_interleave(rep, -1), inv.repeat_interleave(rep, -1)


def norm_affine_act(
    x,
    a: torch.Tensor,
    b: torch.Tensor,
    groups: int,
    eps: float = 1e-6,
    act: Optional[str] = None,
    dropout_p: float = 0.0,
    ext_sums: Optional[torch.Tensor] = None,
):
    """y = act(groupnorm(x) * a + b). x (B, *spatial, C) or a :class:`Pair`
    of two such tensors (normalized over their joint channels, returned as a
    Pair); a, b (B, C). ``ext_sums`` (B, 2, C) f32 are (sum x, sum x^2) over
    x's voxels, as emitted by the conv that produced x: the sums pass is
    skipped."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown act {act!r}")
    if dropout_p > 0.0:
        raise NotImplementedError(
            "dropout comes with the training kernels; sampling runs at p=0")
    parts = [x.a, x.b] if isinstance(x, Pair) else [x]
    C = sum(p.shape[-1] for p in parts)
    if C % groups:
        raise ValueError(f"channels {C} not divisible by groups {groups}")
    flats = [_flat(p) for p in parts]
    if ext_sums is None:
        sums = torch.cat([gn_sums(f) for f in flats], dim=-1)
    else:
        sums = ext_sums
    if tuple(sums.shape) != (flats[0].shape[0], 2, C):
        raise ValueError(f"sums shape {tuple(sums.shape)} for {C} channels")
    count = float(flats[0].shape[1] * (C // groups))
    mean, inv = _finalize(sums, groups, count, eps)
    scale = a.float() * inv
    shift = b.float() - mean * scale
    outs, c0 = [], 0
    for p, f in zip(parts, flats):
        c1 = c0 + p.shape[-1]
        y = gn_apply(f, scale[:, c0:c1].contiguous(),
                     shift[:, c0:c1].contiguous(), act)
        outs.append(y.reshape(p.shape))
        c0 = c1
    return Pair(*outs) if isinstance(x, Pair) else outs[0]


def group_norm(x, scale, bias, groups: int, eps: float = 1e-6,
               act: Optional[str] = None, ext_sums=None):
    """Plain GroupNorm: x channels-last (or a Pair); scale/bias (C,)."""
    bsz = x.a.shape[0] if isinstance(x, Pair) else x.shape[0]
    a = scale.float()[None].expand(bsz, -1)
    b = bias.float()[None].expand(bsz, -1)
    return norm_affine_act(x, a, b, groups, eps=eps, act=act,
                           ext_sums=ext_sums)


def group_norm_film(x, scale, bias, film_scale, film_shift, groups: int,
                    eps: float = 1e-6, act: Optional[str] = "silu",
                    dropout_p: float = 0.0, ext_sums=None):
    """The ResBlock FiLM site: act(GN(x) * (1 + fs) + fsh) with GN's own
    gamma/beta folded in; film_scale/film_shift (B, C)."""
    one_fs = 1.0 + film_scale.float()
    a = scale.float()[None] * one_fs
    b = bias.float()[None] * one_fs + film_shift.float()
    return norm_affine_act(x, a, b, groups, eps=eps, act=act,
                           dropout_p=dropout_p, ext_sums=ext_sums)
