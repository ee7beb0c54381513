"""A forward step of the flagship and a multi-rank dry run of the sharded
train step: counterparts of ``entry()`` and ``dryrun_multichip(n)`` in
``__graft_entry__.py``.

    entry(device=None)    -> (fn, example_args): the flagship 3D conditional
                             VDM's eps prediction at 32^3, batch 1, on the
                             card unless ``device`` names another device;
    dryrun_multichip(n)   -> an n-rank gloo job of CPU processes
                             (``parallel/launch.py::spawn_ranks``) on the
                             (data, sp) mesh ``pick_mesh_shape(n)`` gives,
                             taking one sharded train step of each model
                             stage and one z-halo conv with a CP GroupNorm,
                             forward and backward.

    python -m vdm4cdm_torch.parallel.dryrun [N]

The dry run is budgeted in wall seconds: ``VDM4CDM_DRYRUN_BUDGET_S`` (420 by
default), counted from the call. Before each stage after the first, rank 0
compares the budget left with the stage's estimate and all ranks follow its
decision, so a stage that would not fit prints a ``SKIPPED (budget)`` line
and the run ends cleanly instead of at a time limit. The stages:

  1. the flagship VDM (chs 32..256, circular, dropout 0.1) at 32^3, global
     batch max(2, n_data);
  2. an SFM with zeros padding (chs 16 x 4, no dropout);
  3. a VDM with the bottleneck attention (``mid_attn``, chs 16 x 4), whose
     ranks gather the whole bottleneck;
  4. one k3 conv that emits its GroupNorm sums feeding one GroupNorm with
     SiLU on a (1, 2 * n_sp, 8, 8, 16) field split over ``sp``: on the CPU
     the z-halo conv's and the CP norm's plain versions, with the halo
     exchange and the all-reduced statistics, forward and backward.

The JAX dry run's fifth stage, a ResBlock on the lane-packed carrier, checks
a TPU layout that the port does not have.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

SIZE = 32
BUDGET_ENV = "VDM4CDM_DRYRUN_BUDGET_S"
# each later stage's estimate (CPU seconds, one thread a rank); stage 1
# always runs
STAGE_ESTIMATE_S = {2: 60.0, 3: 60.0, 4: 15.0}
STAGE_NAMES = {1: "1 (flagship VDM)", 2: "2 (SFM zeros)",
               3: "3 (mid_attn VDM)", 4: "4 (z-halo conv -> CP norm)"}


def _flagship(size: int, device, ctx=None, generator=None):
    """The flagship 3D field-to-field conditional VDM (preset
    ``trainVDM3D128_c_c``'s net at crop ``size``)."""
    from ..diffusion import VDM, make_schedule
    from ..models import CUNet
    from .halo import NO_SHARD

    net = CUNet(shape=(1, size, size, size), chs=(32, 64, 128, 256),
                s_conditioning_channels=1, v_conditioning_dims=(6,),
                norm_groups=8, mid_attn=False, dropout_prob=0.1,
                conv_padding_mode="circular", device=device,
                generator=generator, ctx=NO_SHARD if ctx is None else ctx)
    return VDM(net, make_schedule("learned_linear", -13.3, 13.3,
                                  device=device))


def entry(device=None):
    """``(fn, example_args)``: ``fn(z, t, cond, vvals)`` is the flagship's
    eps prediction (no autograd graph) at 32^3, batch 1, f32, parameters
    drawn from seed 0, on the CUDA card (``device=None``; raises without
    one) or on ``device``; ``example_args`` are its inputs there, and
    ``fn.model`` the VDM."""
    from .._device import resolve_device

    dev = resolve_device(device)
    size, batch = SIZE, 1
    vdm = _flagship(size, dev, generator=torch.Generator().manual_seed(0))
    vdm.eval()

    @torch.inference_mode()
    def fn(z, t, cond, vvals):
        return vdm.eps_hat(z, t, cond, [vvals])

    fn.model = vdm

    example_args = (
        torch.zeros(batch, size, size, size, 1, device=dev),
        torch.full((batch,), 0.5, device=dev),
        torch.zeros(batch, size, size, size, 1, device=dev),
        torch.zeros(batch, 6, device=dev),
    )
    return fn, example_args


def pick_mesh_shape(n: int, sp_cap: int = 4) -> Tuple[int, int]:
    """Factor n into (data, sp): sp gets the largest power-of-2 divisor of n
    up to ``sp_cap`` (32^3 halves three times, so sp <= 4)."""
    sp = 1
    while sp * 2 <= sp_cap and n % (sp * 2) == 0:
        sp *= 2
    return n // sp, sp


def _say(rank: int, text: str) -> None:
    if rank == 0:
        print(f"[dryrun_multichip] {text}", flush=True)


def _run_stage(number: int, rank: int, t0: float, budget_s: float) -> bool:
    """Whether every rank runs stage ``number``: rank 0 decides from the
    budget left (printing the skip line), the others take its word."""
    import torch.distributed as dist

    run = [True]
    if rank == 0 and number in STAGE_ESTIMATE_S:
        left = budget_s - (time.monotonic() - t0)
        need = STAGE_ESTIMATE_S[number]
        if left < need:
            run[0] = False
            _say(rank, f"stage {STAGE_NAMES[number]} SKIPPED (budget: "
                 f"{left:.0f}s left < {need:.0f}s est; coverage lives in the "
                 "pytest suite)")
    dist.broadcast_object_list(run, src=0)
    return run[0]


def _train_step(model, batch: Dict, seed: int) -> float:
    """One sharded train step (Adam 3e-4, clip 0.5) on this rank's slab of
    ``batch``; returns the mesh's loss."""
    from ..train import TrainState, make_optimizer, make_train_step
    from .shard import local_slab

    ctx = (model.score_model if hasattr(model, "score_model")
           else model.unet).ctx
    opt = make_optimizer()
    state = TrainState(0, model, opt.init(model), None)
    step = make_train_step(model, opt)
    slab = {k: ([local_slab(torch.from_numpy(a), ctx) for a in v]
                if isinstance(v, list) else local_slab(torch.from_numpy(v),
                                                       ctx))
            for k, v in batch.items()}
    _, metrics = step(state, slab, torch.Generator().manual_seed(seed))
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")
    return loss


def _conv_norm(ctx) -> Tuple[float, float]:
    """Stage 4: conv (k3, bias, emitted sums) -> GroupNorm + SiLU on the
    ``sp`` ranks' slabs of one field, then the gradients of the field's
    mean square; returns (loss, |grad|) over the mesh."""
    from ..ops.conv import conv_nd
    from ..ops.norm import group_norm
    from .halo import all_reduce_
    from .shard import local_slab

    B, D, H, W, C, groups = 1, 2 * ctx.size, 8, 8, 16, 4
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((B, D, H, W, C))
                         .astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((3, 3, 3, C, C)))
                         .astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32)
                         ).requires_grad_(True)
    scale = torch.ones(C, requires_grad=True)
    bias = torch.zeros(C, requires_grad=True)
    xl = local_slab(x, ctx)
    y, sums = conv_nd(xl, w, b, padding_mode="circular", emit_stats=True,
                      ctx=ctx)
    y = group_norm(y, scale, bias, groups, act="silu", ext_sums=sums,
                   ctx=ctx)
    loss = y.square().sum() / (B * D * H * W * C)
    loss.backward()
    # each rank holds its slab's share of the loss and of the parameters'
    # gradients: the field's are their sums over the sp group
    grads = torch.cat([t.grad.reshape(-1) for t in (w, b, scale, bias)])
    all_reduce_(grads, ctx)
    loss = float(all_reduce_(loss.detach().reshape(1), ctx))
    gnorm = float(grads.square().sum().sqrt())
    if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
        raise FloatingPointError(f"stage 4: loss {loss}, |g| {gnorm}")
    return loss, gnorm


def _rank(rank: int, world: int, n_data: int, n_sp: int, t0: float,
          budget_s: float) -> Dict[str, Optional[float]]:
    """One rank of the dry run (one torch thread): every stage on this
    rank's slabs; the stages' losses (None where skipped)."""
    from ..diffusion import VDM, make_schedule
    from ..flows import SFM
    from ..models import CUNet
    from .shard import make_mesh, make_shard_ctx

    torch.set_num_threads(1)
    ctx = make_shard_ctx(make_mesh(n_data, n_sp))
    size, batch = SIZE, max(2, n_data)
    gen = np.random.default_rng(0)
    x = gen.standard_normal((batch, size, size, size, 1), np.float32)
    cond = np.random.default_rng(1).standard_normal(
        (batch, size, size, size, 1), np.float32)
    vvals = [np.zeros((batch, 6), np.float32)]
    mesh = f"mesh=(data={n_data}, sp={n_sp})"
    out: Dict[str, Optional[float]] = {}

    vdm = _flagship(size, "cpu", ctx, torch.Generator().manual_seed(0))
    out["vdm"] = _train_step(vdm, {"x": x, "conditioning": cond,
                                   "conditioning_values": vvals}, 1)
    _say(rank, f"VDM {mesh} crop={size}^3 batch={batch} step=1 "
         f"loss={out['vdm']:.4f} OK")
    del vdm

    small = dict(shape=(1, size, size, size), chs=(16, 16, 16, 16),
                 v_conditioning_dims=(6,), norm_groups=8, device="cpu",
                 ctx=ctx)
    out["sfm"] = None
    if _run_stage(2, rank, t0, budget_s):
        sfm = SFM(CUNet(**small, dropout_prob=0.0, conv_padding_mode="zeros",
                        generator=torch.Generator().manual_seed(2)))
        out["sfm"] = _train_step(sfm, {"x0": cond, "x1": x,
                                       "conditioning_values": vvals}, 3)
        _say(rank, f"SFM (zeros padding) {mesh} step=1 "
             f"loss={out['sfm']:.4f} OK")
        del sfm

    out["mid_attn"] = None
    if _run_stage(3, rank, t0, budget_s):
        net = CUNet(**small, s_conditioning_channels=1, mid_attn=True,
                    dropout_prob=0.1, conv_padding_mode="circular",
                    generator=torch.Generator().manual_seed(4))
        avdm = VDM(net, make_schedule("learned_linear", -13.3, 13.3,
                                      device="cpu"))
        out["mid_attn"] = _train_step(avdm, {"x": x, "conditioning": cond,
                                             "conditioning_values": vvals}, 5)
        _say(rank, f"VDM mid_attn=True {mesh} step=1 "
             f"loss={out['mid_attn']:.4f} OK")
        del avdm

    out["conv_norm"] = None
    if _run_stage(4, rank, t0, budget_s):
        loss, gnorm = _conv_norm(ctx)
        out["conv_norm"] = loss
        _say(rank, f"z-halo conv -> CP norm, fwd+bwd, {mesh} "
             f"loss={loss:.4f} |g|={gnorm:.4f} OK")
    return out


def dryrun_multichip(n_devices: int) -> Dict[str, Optional[float]]:
    """Run the dry run on ``n_devices`` CPU ranks and return rank 0's stage
    losses (None for a skipped stage). A
    rank that fails, or a job that outlasts the budget by ten minutes (a
    hung rank), raises."""
    from .launch import spawn_ranks

    t0 = time.monotonic()
    budget_s = float(os.environ.get(BUDGET_ENV, "420"))
    n_data, n_sp = pick_mesh_shape(n_devices)
    with tempfile.TemporaryDirectory(prefix="dryrun-") as store:
        ranks = spawn_ranks(_rank, n_devices,
                            (n_data, n_sp, t0, budget_s),
                            store_dir=store, timeout=budget_s + 600.0)
    return ranks[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
