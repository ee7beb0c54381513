"""Spatially sharded sampling: counterpart of
``vdm4cdm_tpu/parallel/sampling.py``.

Each rank runs the model's sampler on its slab of the field, 3D or 2D (the
batch split over ``data``, the first spatial dim over ``sp``: D of a box, H
of a map); every UNet evaluation exchanges halo planes and all-reduces its GroupNorm sums, and only the final
field is gathered. The returned functions take the global conditioning,
split it with :func:`~vdm4cdm_torch.parallel.shard.local_slab`, and return
the global samples on every rank.

VDM: the noise folds in the data index here and the ``sp`` index inside
``VDM.draw_samples``, so the global initial z and every step's noise are iid
while the time ladder is shared. SFM: the ODE methods are deterministic, so
sharded and unsharded sampling agree to rounding: the end-to-end test of the
halo machinery. With a generator, the SFM's noise folds in both indices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .shard import gather_slab, local_slab, rank_generator


def make_sharded_vdm_sampler(vdm, batch_size: int = 1,
                             n_sampling_steps: int = 250):
    """``sample(generator, s_conditioning=None, v_conditionings=())`` for a
    VDM whose score model holds this rank's ``ctx``. ``s_conditioning`` is
    the global (batch_size, *spatial, Cs) field (3D or 2D) and ``v_conditionings`` the
    global (batch_size, d) vectors. ``generator`` is in the same state on
    every rank."""
    ctx = vdm.score_model.ctx
    if batch_size % ctx.data_size:
        raise ValueError(f"batch {batch_size} over {ctx.data_size} data "
                         "ranks")
    local_batch = batch_size // ctx.data_size

    @torch.inference_mode()
    def sample(generator: torch.Generator,
               s_conditioning: Optional[torch.Tensor] = None,
               v_conditionings: Sequence[torch.Tensor] = ()):
        if ctx.data_group is not None:
            generator = rank_generator(generator, ctx.data_index)
        cond = (None if s_conditioning is None
                else local_slab(s_conditioning.to(vdm.device), ctx))
        vv = [local_slab(v.to(vdm.device), ctx) for v in v_conditionings]
        z = vdm.draw_samples(generator, batch_size=local_batch,
                             n_sampling_steps=n_sampling_steps,
                             s_conditioning=cond, v_conditionings=vv)
        return gather_slab(z, ctx)

    return sample


def make_sharded_sfm_sampler(sfm, n_sampling_steps: int = 250,
                             method: str = "heun"):
    """``sample(x0, v_conditionings=(), generator=None)`` for an SFM whose
    velocity model holds this rank's ``ctx``: x0 the global (B, *spatial, C)
    start field (3D or 2D), ``v_conditionings`` the global (B, d) vectors. Without a
    generator the euler and heun methods are deterministic; with one (in the
    same state on every rank) the start noise and the ``sde`` steps' noise
    fold in both mesh indices."""
    ctx = sfm.velocity_model.ctx

    @torch.inference_mode()
    def sample(x0: torch.Tensor, v_conditionings: Sequence[torch.Tensor] = (),
               generator: Optional[torch.Generator] = None):
        if generator is not None:
            generator = rank_generator(generator, ctx.data_index, ctx.index)
        x = local_slab(x0.to(sfm.device), ctx)
        vv = [local_slab(v.to(sfm.device), ctx) for v in v_conditionings]
        out = sfm.draw_samples(x, n_sampling_steps, vv, method=method,
                               generator=generator)
        return gather_slab(out, ctx)

    return sample
