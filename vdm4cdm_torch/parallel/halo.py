"""Spatial-domain parallelism: halo exchange over the ``sp`` process group,
counterpart of ``vdm4cdm_tpu/parallel/halo.py``.

The first spatial dimension of the field (D of a 3D (B, D, H, W, C) field,
H of a 2D (B, H, W, C) map) is split over the ranks of the ``sp`` group, one
process per rank (``torch.distributed``). Every convolution exchanges a
one-plane (one-row in 2D) halo with its ring neighbours before it runs valid
along the split dim, and every GroupNorm all-reduces its (B, 2, C) sums.
Circular padding is the periodic ring; zeros padding drops the wrap-around
edge, so the open ends receive zero planes.

``ppermute`` is the counterpart of ``jax.lax.ppermute``: a batch of
``isend`` / ``irecv`` (``dist.batch_isend_irecv``). The route follows the
group's backend and nothing else: an NCCL group hands CUDA tensors over
directly (the multi-card route); a ``gloo`` group takes CPU tensors, so a
CUDA tensor is staged through a pinned host buffer on each side (gloo has no
point-to-point for CUDA tensors). ``gloo`` is how several ranks share one
card, which NCCL refuses. All-reduces go to ``dist.all_reduce`` whatever the
backend (gloo reduces CUDA tensors itself).

Every function here is the identity or a local pad when ``ctx`` is
unsharded, so the same model code runs on one process.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclasses.dataclass
class CommStats:
    """What the collectives of one :class:`ShardCtx` cost on this rank.

    ``sync=True`` synchronizes the device before and after each collective,
    so that its wall time is its own and not that of the kernels queued
    before it; leave it off where steps are timed."""

    sync: bool = False
    ppermute_calls: int = 0
    ppermute_s: float = 0.0
    all_reduce_calls: int = 0
    all_reduce_s: float = 0.0
    host_bytes: int = 0  # bytes copied between the device and the host

    def reset(self) -> None:
        sync = self.sync
        self.__init__()
        self.sync = sync

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """How the computation of this rank is split.

    group:       the ``sp`` process group (None = unsharded);
    ranks:       its global ranks in ``sp`` order;
    spatial_dim: the split spatial dimension (0 only, as the JAX CUNet
                 uses: arrays are channels-last (B, D, H, W, C) or (B, H,
                 W, C), so it is array dim 1, D in 3D and H in 2D);
    data_group / data_ranks: the data-parallel group of this rank (None =
                 no data parallelism), used by the train step and samplers;
    stats:       the collectives' counters (:class:`CommStats`)."""

    group: Optional[dist.ProcessGroup] = None
    ranks: Tuple[int, ...] = ()
    spatial_dim: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    data_ranks: Tuple[int, ...] = ()
    stats: CommStats = dataclasses.field(default_factory=CommStats,
                                         compare=False, repr=False)

    def __post_init__(self):
        if self.spatial_dim != 0:
            raise NotImplementedError("only the first spatial dim is split")
        if (self.group is None) != (not self.ranks):
            raise ValueError("group and ranks go together")
        if (self.data_group is None) != (not self.data_ranks):
            raise ValueError("data_group and data_ranks go together")

    @property
    def sharded(self) -> bool:
        return self.group is not None

    @property
    def array_dim(self) -> int:
        return 1 + self.spatial_dim

    @property
    def size(self) -> int:
        return len(self.ranks) if self.sharded else 1

    @property
    def index(self) -> int:
        return self.ranks.index(dist.get_rank()) if self.sharded else 0

    @property
    def data_size(self) -> int:
        return len(self.data_ranks) if self.data_group is not None else 1

    @property
    def data_index(self) -> int:
        return (self.data_ranks.index(dist.get_rank())
                if self.data_group is not None else 0)

    @property
    def world_size(self) -> int:
        return self.size * self.data_size


NO_SHARD = ShardCtx()


class _Clock:
    """Adds a collective's wall time to ``stats`` (synchronizing the device
    around it when ``stats.sync``)."""

    def __init__(self, stats: CommStats, kind: str, device: torch.device):
        self.stats, self.kind, self.device = stats, kind, device

    def __enter__(self):
        if self.stats.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.stats.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        s = self.stats
        setattr(s, f"{self.kind}_s",
                getattr(s, f"{self.kind}_s") + time.perf_counter() - self.t0)
        setattr(s, f"{self.kind}_calls", getattr(s, f"{self.kind}_calls") + 1)


def _stages_through_host(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) != dist.Backend.NCCL


def ppermute(x: torch.Tensor, ctx: ShardCtx, shift: int,
             periodic: bool) -> torch.Tensor:
    """Send ``x`` ``shift`` steps up the ``sp`` ring and return what this
    rank receives: from ``index - shift``, or zeros at an open end when not
    ``periodic``. Every rank of the group must call it with the same shift
    and a tensor of the same shape."""
    n = ctx.size
    if n == 1:
        return x.clone() if periodic else torch.zeros_like(x)
    i = ctx.index
    dst, src = i + shift, i - shift
    if periodic:
        dst, src = dst % n, src % n
    out = torch.zeros_like(x)
    if not (0 <= dst < n or 0 <= src < n):
        return out
    with _Clock(ctx.stats, "ppermute", x.device):
        staged = _stages_through_host(ctx.group, x)
        if staged:
            send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            recv = torch.empty_like(send)
        else:
            send, recv = x, out
        ops = []
        if 0 <= dst < n:
            if staged:
                send.copy_(x)
                ctx.stats.host_bytes += x.numel() * x.element_size()
            ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                  ctx.ranks[dst], ctx.group))
        if 0 <= src < n:
            ops.append(dist.P2POp(dist.irecv, recv, ctx.ranks[src],
                                  ctx.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged and 0 <= src < n:
            out.copy_(recv)
            ctx.stats.host_bytes += out.numel() * out.element_size()
    return out


def all_reduce_(t: torch.Tensor, ctx: ShardCtx, group=None) -> torch.Tensor:
    """In-place sum of ``t`` over ``group`` (the ``sp`` group by default),
    counted in ``ctx.stats``. Returns ``t``."""
    group = ctx.group if group is None else group
    with _Clock(ctx.stats, "all_reduce", t.device):
        dist.all_reduce(t, group=group)
    return t


def _edge(x, dim, start, length):
    return x.narrow(dim, start, length).contiguous()


class _HaloExchange(torch.autograd.Function):
    """Forward: [left halo from index - 1, x, right halo from index + 1]
    along the split dim. Backward: the transpose of each ``ppermute``, which
    JAX derives itself: each received halo's gradient goes back to the rank
    that sent it and is added onto that rank's edge planes."""

    @staticmethod
    def forward(fctx, x, shard, lo, hi, periodic):
        dim = shard.array_dim
        n = x.shape[dim]
        if lo > n or hi > n:
            raise ValueError(f"halo ({lo}, {hi}) wider than the slab ({n})")
        fctx.shard, fctx.lo, fctx.hi, fctx.periodic = shard, lo, hi, periodic
        parts = []
        if lo:
            parts.append(ppermute(_edge(x, dim, n - lo, lo), shard, +1,
                                  periodic))
        parts.append(x)
        if hi:
            parts.append(ppermute(_edge(x, dim, 0, hi), shard, -1, periodic))
        return torch.cat(parts, dim)

    @staticmethod
    def backward(fctx, g):
        shard, lo, hi = fctx.shard, fctx.lo, fctx.hi
        dim = shard.array_dim
        n = g.shape[dim] - lo - hi
        dx = g.narrow(dim, lo, n).clone()
        if lo:
            back = ppermute(_edge(g, dim, 0, lo), shard, -1, fctx.periodic)
            dx.narrow(dim, n - lo, lo).add_(back)
        if hi:
            back = ppermute(_edge(g, dim, lo + n, hi), shard, +1,
                            fctx.periodic)
            dx.narrow(dim, 0, hi).add_(back)
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, ctx: ShardCtx, lo: int, hi: int,
                  periodic: bool) -> torch.Tensor:
    """Extend the split dim of the local slab ``x`` (3D or 2D) by ``lo`` /
    ``hi`` planes (rows) from the ring neighbours (zeros at open ends unless
    ``periodic``). Unsharded it is the plain wrap or zero pad."""
    if lo == 0 and hi == 0:
        return x
    if ctx.sharded:
        return _HaloExchange.apply(x, ctx, lo, hi, periodic)
    dim = ctx.array_dim
    n = x.shape[dim]
    if periodic:
        return torch.cat([x.narrow(dim, n - lo, lo), x,
                          x.narrow(dim, 0, hi)], dim)
    pad = [0, 0] * (x.ndim - dim - 1) + [lo, hi]
    return F.pad(x, pad)


class _AllGather(torch.autograd.Function):
    """Forward: every rank's slab placed in a zero field, summed over the
    group (an all-gather built from the all-reduce, which gloo runs on CUDA
    tensors). Backward: the all-gather's transpose, a reduce-scatter, as an
    all-reduce followed by this rank's slice (gloo has no reduce-scatter for
    CUDA tensors)."""

    @staticmethod
    def forward(fctx, x, shard):
        dim, n, i = shard.array_dim, shard.size, shard.index
        fctx.shard = shard
        local = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = local * n
        full = x.new_zeros(shape)
        full.narrow(dim, i * local, local).copy_(x)
        return all_reduce_(full, shard)

    @staticmethod
    def backward(fctx, g):
        shard = fctx.shard
        dim = shard.array_dim
        local = g.shape[dim] // shard.size
        g = all_reduce_(g.contiguous().clone(), shard)
        return g.narrow(dim, shard.index * local, local).contiguous(), None


def all_gather_spatial(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The whole split dim on every rank, 3D or 2D (the tiny UNet
    bottleneck, for full self-attention)."""
    return _AllGather.apply(x, ctx) if ctx.sharded else x


def take_local_spatial(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """Inverse of :func:`all_gather_spatial`: this rank's chunk of the split
    dim. Autograd's transpose of the slice is the zero pad JAX uses, with no
    communication."""
    if not ctx.sharded:
        return x
    dim = ctx.array_dim
    local = x.shape[dim] // ctx.size
    return x.narrow(dim, ctx.index * local, local)
