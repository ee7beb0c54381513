"""The (data, sp) mesh over the ranks of a ``torch.distributed`` job:
counterpart of ``vdm4cdm_tpu/parallel/shard.py`` and of the mesh part of
``vdm4cdm_tpu/utils/mesh.py``.

Parameters are replicated. A global batch is split over the mesh: the batch
dim over ``data``, the first spatial dim over ``sp`` (D of a 3D box, H of a
2D map). ``sp`` is the minor
axis, so the ranks of one ``sp`` group are consecutive (rank = data_index *
n_sp + sp_index), as the JAX mesh lays ``sp`` out on neighbouring devices.

The caller starts the job: ``dist.init_process_group`` with the address, the
world size and the rank (nothing on the machine tells a program of a
cluster), then :func:`make_mesh` on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.kernels.philox import mix_seed
from ..utils.rng import seeded_generator
from .halo import ShardCtx, all_gather_spatial, all_reduce_


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of an (n_data, n_sp) mesh: its groups (None where
    the axis has size 1) and their global ranks."""

    n_data: int
    n_sp: int
    sp_group: Optional[dist.ProcessGroup]
    sp_ranks: Tuple[int, ...]
    data_group: Optional[dist.ProcessGroup]
    data_ranks: Tuple[int, ...]


def make_mesh(n_data: int = 1, n_sp: int = 1) -> Mesh:
    """Build the mesh over the initialised default group, whose size must be
    ``n_data * n_sp``. Every rank calls it (``dist.new_group`` is a
    collective over the whole job)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs dist.init_process_group first")
    world = dist.get_world_size()
    if n_data * n_sp != world:
        raise ValueError(f"mesh {n_data} x {n_sp} for {world} ranks")
    rank = dist.get_rank()
    sp_group = data_group = None
    sp_ranks = data_ranks = ()
    if n_sp > 1:
        for d in range(n_data):
            ranks = tuple(d * n_sp + s for s in range(n_sp))
            group = dist.new_group(list(ranks))
            if rank in ranks:
                sp_group, sp_ranks = group, ranks
    if n_data > 1:
        for s in range(n_sp):
            ranks = tuple(d * n_sp + s for d in range(n_data))
            group = dist.new_group(list(ranks))
            if rank in ranks:
                data_group, data_ranks = group, ranks
    return Mesh(n_data, n_sp, sp_group, sp_ranks, data_group, data_ranks)


def process_rank() -> Tuple[int, int]:
    """(rank, world size) of the ``torch.distributed`` job, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_process(n_sp: int) -> Tuple[int, int]:
    """(data index, n_data) of this process in a job laid out as an
    (n_data, n_sp) mesh (rank = data_index * n_sp + sp_index), else (0, 1):
    which block of a global batch's rows a data module serves."""
    rank, world = process_rank()
    if world == 1:
        return 0, 1
    if world % n_sp:
        raise ValueError(f"{world} ranks do not make a mesh of sp = {n_sp}")
    return rank // n_sp, world // n_sp


def make_shard_ctx(mesh: Mesh) -> ShardCtx:
    """The :class:`ShardCtx` of this rank on ``mesh``."""
    return ShardCtx(group=mesh.sp_group, ranks=mesh.sp_ranks, spatial_dim=0,
                    data_group=mesh.data_group, data_ranks=mesh.data_ranks)


def local_slab(x: torch.Tensor, ctx: ShardCtx, rows: bool = True
               ) -> torch.Tensor:
    """This rank's block of a global (B, D, H, W, C) or (B, H, W, C) field:
    its data rank's batch rows and its ``sp`` rank's planes of D (rows of H
    in 2D). A (B, d) vector (a
    conditioning value) is split on the batch only. ``rows=False``: x holds
    this data rank's rows already (a data module that serves its process's
    block), and only the planes are taken."""
    if rows:
        b = x.shape[0]
        if b % ctx.data_size:
            raise ValueError(f"batch {b} over {ctx.data_size} data ranks")
        lb = b // ctx.data_size
        x = x.narrow(0, ctx.data_index * lb, lb)
    if x.ndim >= 3 and ctx.sharded:
        dim, n = ctx.array_dim, x.shape[ctx.array_dim]
        if n % ctx.size:
            raise ValueError(f"{n} planes over {ctx.size} sp ranks")
        local = n // ctx.size
        x = x.narrow(dim, ctx.index * local, local)
    return x.contiguous()


def gather_slab(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """Inverse of :func:`local_slab` on every rank: the global field from
    each rank's block (an all-gather over ``sp``, then over ``data``)."""
    return gather_rows(all_gather_spatial(x, ctx), ctx)


def gather_rows(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The global batch from each data rank's rows of it, on every rank
    (the rows' part of :func:`gather_slab`)."""
    if ctx.data_group is None:
        return x
    lb = x.shape[0]
    full = x.new_zeros((lb * ctx.data_size,) + tuple(x.shape[1:]))
    full.narrow(0, ctx.data_index * lb, lb).copy_(x)
    return all_reduce_(full, ctx, ctx.data_group)


def mean_over_mesh_(t: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """In place: the mean of ``t`` over every rank of the mesh (JAX's
    ``pmean`` over both axes). The mesh is the whole job."""
    if ctx.world_size > 1:
        all_reduce_(t, ctx, dist.group.WORLD)
        t.div_(ctx.world_size)
    return t


def rank_generator(generator: torch.Generator, *indices: int
                   ) -> torch.Generator:
    """A generator on ``generator``'s device for this rank's own noise: one
    62-bit integer drawn from ``generator`` (which ranks that must agree
    hold in the same state), mixed with ``indices``. The draw advances
    ``generator`` and, on a CUDA generator, reads one integer back from the
    device."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    return seeded_generator(generator.device, seed, *indices)


# the eps site of a loss under its step seed, apart from the dropout sites
# (the ResBlock indices) mixed under the same seed
_EPS_SITE = 0x657073


def eps_generator(generator: torch.Generator, seed: Optional[int],
                  index: int) -> torch.Generator:
    """The generator of a sharded loss's eps on ``sp`` rank ``index``: with
    a host ``seed`` (the step's, which the loss also takes for dropout) it is
    seeded on the host from that seed, the eps site and ``index``, so the
    step reads nothing back from the device and leaves ``generator`` as it
    was; without one it is :func:`rank_generator` on ``generator``."""
    if seed is None:
        return rank_generator(generator, index)
    return seeded_generator(generator.device, mix_seed(int(seed), _EPS_SITE),
                            index)
