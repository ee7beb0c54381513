"""The ``sp`` / data-parallel path: halo exchange, the (data, sp) mesh and
the sharded samplers, on ``torch.distributed`` (one process per rank)."""

from .halo import (NO_SHARD, CommStats, ShardCtx, all_gather_spatial,
                   halo_exchange, ppermute, take_local_spatial)
from .sampling import make_sharded_sfm_sampler, make_sharded_vdm_sampler
from .shard import (Mesh, eps_generator, gather_slab, local_slab, make_mesh,
                    make_shard_ctx, mean_over_mesh_, rank_generator,
                    seeded_generator)

__all__ = ["CommStats", "Mesh", "NO_SHARD", "ShardCtx", "all_gather_spatial",
           "eps_generator", "gather_slab", "halo_exchange", "local_slab", "make_mesh",
           "make_shard_ctx", "make_sharded_sfm_sampler",
           "make_sharded_vdm_sampler", "mean_over_mesh_", "ppermute",
           "rank_generator", "seeded_generator", "take_local_spatial"]
