"""GroupNorm with a fused per-(batch, channel) affine and SiLU.

Counterpart of ``vdm4cdm_tpu/ops/norm.py``. Every normalization site of the
UNet is

    y = dropout(act(groupnorm(x) * a + b)),   a, b (B, C)

with a = gamma, b = beta for a plain GroupNorm and a = gamma * (1 + fs),
b = beta * (1 + fs) + fsh at the FiLM site. Each site is one ``gn_sums`` pass
over x (skipped when the producing conv emitted the sums), a finalize on the
tiny (B, 2, C) sums in torch, and one ``gn_apply`` pass. A :class:`Pair`
(lazy skip concat) is normalized with joint group statistics over its two
halves, which may straddle the boundary, and stays a pair.

The site is one ``torch.autograd.Function`` (:class:`NormAffineAct`) over x
(or both halves of a pair), a and b. Its backward is ``gn_bwd_sums`` on each
half, a finalize on (B, 2, C) (da, db, and the group means over the joint
channels), and ``gn_bwd_apply`` on each half. It saves x, a, b, the
per-channel (mean, inv) and the dropout seed, never the mask or y: both
backward passes regenerate the mask from (seed, element index). gamma, beta
and FiLM get their gradients from autograd through the (B, C) torch ops
around the Function.

Statistics: f32 sums, eps 1e-6, variance clamped at 0 (the sum-based
variance of a near-constant group can come out negative in f32).
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import gn_apply, gn_bwd_apply, gn_bwd_sums, gn_sums
from .kernels.philox import mix_seed
from .pair import Pair

# mixed into a dropout site's seed for the second half of a Pair, whose
# element indices start again at 0
_PAIR_HALF = 0x5061697242


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


def _group_mean(v: torch.Tensor, groups: int, count: float):
    """(B, C) per-channel sums -> their group means, broadcast to (B, C)."""
    B, C = v.shape
    g = v.reshape(B, groups, C // groups).sum(-1) / count
    return g.repeat_interleave(C // groups, -1)


def _half_seed(seed, half: int):
    return seed if seed is None or half == 0 else mix_seed(seed, _PAIR_HALF)


def _halves(xs, *rows):
    """For each half x of a site: (half index, x, the halves' columns of each
    (B, C) row as contiguous tensors)."""
    c0 = 0
    for half, x in enumerate(xs):
        c1 = c0 + x.shape[-1]
        yield half, x, [t[:, c0:c1].contiguous() for t in rows]
        c0 = c1


class NormAffineAct(torch.autograd.Function):
    """(a, b, ext_sums, groups, eps, act, dropout_p, seed, *xs) -> ys, with
    xs the (B, S, C_i) halves of one site (one tensor, or the two of a
    Pair). ``ext_sums`` gets no gradient."""

    @staticmethod
    def forward(ctx, a, b, ext_sums, groups, eps, act, dropout_p, seed, *xs):
        with torch.no_grad():
            a, b = a.float().contiguous(), b.float().contiguous()
            sums = ext_sums
            if sums is None:
                sums = torch.cat([gn_sums(x) for x in xs], dim=-1)
            count = float(xs[0].shape[1] * (sums.shape[-1] // groups))
            mean, inv = _finalize(sums, groups, count, eps)
            scale = a * inv
            shift = b - mean * scale
            ys = [gn_apply(x, *cols, act, dropout_p, _half_seed(seed, half))
                  for half, x, cols in _halves(xs, scale, shift)]
        ctx.save_for_backward(a, b, mean, inv, *xs)
        ctx.site = (groups, count, act, dropout_p, seed)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *cts):
        a, b, mean, inv, *xs = ctx.saved_tensors
        groups, count, act, dropout_p, seed = ctx.site
        cts = [ct.to(x.dtype).contiguous() for ct, x in zip(cts, xs)]
        sums = torch.cat(
            [gn_bwd_sums(x, cts[half], *cols, act, dropout_p,
                         _half_seed(seed, half))
             for half, x, cols in _halves(xs, mean, inv, a, b)], dim=-1)
        db, da = sums[:, 0], sums[:, 1]
        m1 = _group_mean(a * db, groups, count)
        m2 = _group_mean(a * da, groups, count)
        dxs = [gn_bwd_apply(x, cts[half], *cols, act, dropout_p,
                            _half_seed(seed, half))
               for half, x, cols in _halves(xs, mean, inv, a, b, m1, m2)]
        return (da, db, None, None, None, None, None, None, *dxs)


def norm_affine_act(
    x,
    a: torch.Tensor,
    b: torch.Tensor,
    groups: int,
    eps: float = 1e-6,
    act: Optional[str] = None,
    dropout_p: float = 0.0,
    ext_sums: Optional[torch.Tensor] = None,
    dropout_seed: Optional[int] = None,
):
    """y = dropout(act(groupnorm(x) * a + b)). x (B, *spatial, C) or a
    :class:`Pair` of two such tensors (normalized over their joint channels,
    returned as a Pair); a, b (B, C). ``ext_sums`` (B, 2, C) f32 are
    (sum x, sum x^2) over x's voxels, as emitted by the conv that produced x:
    the sums pass is skipped. ``dropout_p`` > 0 needs the site's integer
    ``dropout_seed``; a Pair's second half uses a seed derived from it."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown act {act!r}")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 needs an integer dropout_seed")
    parts = [x.a, x.b] if isinstance(x, Pair) else [x]
    C = sum(p.shape[-1] for p in parts)
    if C % groups:
        raise ValueError(f"channels {C} not divisible by groups {groups}")
    if tuple(a.shape) != (parts[0].shape[0], C) or a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)} for "
                         f"{C} channels")
    if ext_sums is not None and tuple(ext_sums.shape) != (a.shape[0], 2, C):
        raise ValueError(f"sums shape {tuple(ext_sums.shape)} for "
                         f"{C} channels")
    seed = int(dropout_seed) if dropout_p > 0.0 else None
    outs = NormAffineAct.apply(a, b, ext_sums, groups, eps, act,
                               float(dropout_p), seed,
                               *[_flat(p) for p in parts])
    outs = [y.reshape(p.shape) for y, p in zip(outs, parts)]
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
                    dropout_p: float = 0.0, ext_sums=None,
                    dropout_seed: Optional[int] = None):
    """The ResBlock FiLM site: act(GN(x) * (1 + fs) + fsh) with GN's own
    gamma/beta folded in; film_scale/film_shift (B, C)."""
    one_fs = 1.0 + film_scale.float()
    a = scale.float()[None] * one_fs
    b = bias.float()[None] * one_fs + film_shift.float()
    return norm_affine_act(x, a, b, groups, eps=eps, act=act,
                           dropout_p=dropout_p, ext_sums=ext_sums,
                           dropout_seed=dropout_seed)
