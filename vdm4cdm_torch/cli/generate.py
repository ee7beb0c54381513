"""Generation CLI: posterior-sampling campaigns from trained checkpoints,
counterpart of ``vdm4cdm_tpu/cli/generate.py``.

    python -m vdm4cdm_torch.cli.generate MODEL_NAME SAVE_PATH RUNTYPE \
        --ckpt-dir RUN/checkpoints
    python -m vdm4cdm_torch.cli.generate VDM_GRF_c_c_32 SAVE_PATH CV_12_12

Without ``--ckpt-dir`` the checkpoint, its step and the preset come from the
model's entry in ``--model-registry`` (default ``configs/models_torch.yaml``,
the checkpoints this package reads).

Runtypes (reference generate_3D.py:43-97, generate_3D_1P.py:43-70):
    CV_12_12 — 12 held-out CV boxes x 12 posterior samples -> gen_{i}.npy
    CV_1_128 — CV box index 2 x 128 samples               -> gen_0.npy
    1P_24 / 1P_128 — parameter-variation boxes {0,4,7,23,28} =
        (fid, Om-, Om+, ASN1-, ASN1+) x {24,128} samples   -> {name}_{rep}.npy

Outputs are normalized samples, channels-first (B, C, *spatial) float32 .npy
stacks, laid out as the JAX CLI's. The checkpoint is one of this package's
(``train/checkpoint.py``), its EMA weights when it has them. Runs on the CUDA
card unless ``--device`` names another device.

``parallel.n_data`` / ``n_sp`` > 1 (``--set``, as the run was trained)
samples under the (data, sp) mesh, one process a rank, started as
``cli.train``'s ranks are: the field splits over ``sp`` (D of a 3D box, H of
a 2D map) and each sampler
call's reps over ``data`` (``--reps-per-batch`` a multiple of
``parallel.n_data``), through ``make_sharded_vdm_sampler`` or
``make_sharded_sfm_sampler`` (its ODE, noise-injected and ``sde`` methods);
every rank steps the same ``RngStream``, and rank 0 writes the files, with
the names and shapes of the unsharded campaign.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ._common import (add_device_arg, add_dist_args, apply_overrides,
                      init_distributed, make_mesh_from_config, parse_overrides,
                      read_registry)

ONE_P_INDICES = [0, 4, 7, 23, 28]
ONE_P_NAMES = ["fid", "Om_m2", "Om_p2", "ASN1_m3", "ASN1_p3"]


def build_parser() -> argparse.ArgumentParser:
    """The command line of ``cli.generate`` (also what
    ``examples/make_generation_jobs.py`` writes)."""
    ap = argparse.ArgumentParser(description="Generate posterior samples")
    ap.add_argument("model_name", type=str, help="preset / registry model name")
    ap.add_argument("save_path", type=str)
    ap.add_argument("runtype", type=str,
                    choices=["CV_12_12", "CV_1_128", "1P_24", "1P_128"])
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="checkpoint directory of a run (default: looked up "
                         "in --model-registry by model name)")
    ap.add_argument("--model-registry", type=str,
                    default="configs/models_torch.yaml",
                    help="trained-model registry (YAML, read only): the "
                         "checkpoints this package reads")
    ap.add_argument("--ckpt-step", type=int, default=None)
    ap.add_argument("--n-sampling-steps", type=int, default=250)
    ap.add_argument("--reps-per-batch", type=int, default=1,
                    help="posterior samples drawn per sampler call (must "
                         "divide the campaign's reps)")
    ap.add_argument("--sfm-method", type=str, default="heun",
                    choices=["heun", "euler", "sde"],
                    help="SFM sampler: ODE (heun/euler, noise-injected start "
                         "when the model was trained with sfm_sigma > 0) or "
                         "the score-corrected SDE (requires sfm_sigma > 0)")
    ap.add_argument("--boxes", type=int, default=None, metavar="N",
                    help="only the campaign's first N boxes (a quick check; "
                         "each file keeps its name and shape)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", dest="overrides", nargs="*", metavar="SEC.KEY=VAL",
                    help="config overrides — must match the training run's")
    add_device_arg(ap)
    add_dist_args(ap)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    from ..presets import preset as get_preset

    registry_entry = {}
    if args.ckpt_dir is None and os.path.exists(args.model_registry):
        reg = read_registry(args.model_registry)
        registry_entry = reg.get(args.model_name) or {}
        args.ckpt_dir = registry_entry.get("ckpt_dir")
        if args.ckpt_step is None:
            args.ckpt_step = registry_entry.get("ckpt_step")
    if args.ckpt_dir is None:
        ap.error(f"--ckpt-dir not given and {args.model_name!r} has no ckpt_dir "
                 f"in {args.model_registry}")
    cfg = get_preset(registry_entry.get("preset", args.model_name))
    overrides = dict(registry_entry.get("overrides") or {})
    overrides.update(parse_overrides(args.overrides))
    apply_overrides(cfg, overrides)
    cfg.data.set_name = args.runtype.split("_")[0]
    cfg.data.batch_size = 1
    is_sfm = cfg.model.family == "sfm"

    # SFM models trained with sfm_sigma > 0 sample stochastically (noise-
    # injected start / SDE, flows/sfm.py), so their campaigns rep-batch like
    # VDM's. A sigma=0 SFM remains a deterministic ODE from x0: every rep of
    # a box is the same field, so it is drawn once and repeated.
    sfm_stochastic = is_sfm and cfg.model.sfm_sigma > 0.0
    deterministic = is_sfm and not sfm_stochastic
    if is_sfm and args.sfm_method == "sde" and not sfm_stochastic:
        ap.error("--sfm-method sde requires a model trained with "
                 "model.sfm_sigma > 0")
    rpb = 1 if deterministic else max(1, args.reps_per_batch)

    device, joined = init_distributed(args)
    try:
        return _generate(ap, args, cfg, device, rpb, sfm_stochastic)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _generate(ap, args, cfg, device, rpb, sfm_stochastic) -> int:
    from ..config import build_datamodule, build_model
    from ..parallel import (make_shard_ctx, make_sharded_sfm_sampler,
                            make_sharded_vdm_sampler, process_rank)
    from ..train.checkpoint import load_params
    from ..utils.array import nlast_to_nchw, to_np
    from ..utils.rng import RngStream

    is_sfm = cfg.model.family == "sfm"
    deterministic = is_sfm and not sfm_stochastic
    mesh = make_mesh_from_config(cfg)
    rank0 = process_rank()[0] == 0
    if mesh is not None and rpb % mesh.n_data:
        # sharded sampling: the volume shards over ``sp``, and the rep batch
        # over ``data`` (the JAX CLI's message)
        ap.error(f"--reps-per-batch ({rpb}) must be a multiple of "
                 f"parallel.n_data ({mesh.n_data})")
    model = build_model(cfg, device=device,
                        ctx=make_shard_ctx(mesh) if mesh is not None else None)
    load_params(args.ckpt_dir, model, step=args.ckpt_step)
    model.eval()
    dm = build_datamodule(cfg, stage="test")
    rngs = RngStream(args.seed, device=device)  # the same on every rank
    sharded = None
    if mesh is not None and is_sfm:
        sharded = make_sharded_sfm_sampler(model, args.n_sampling_steps,
                                           method=args.sfm_method)
    elif mesh is not None:
        sharded = make_sharded_vdm_sampler(model, rpb, args.n_sampling_steps)
    if rank0:
        os.makedirs(args.save_path, exist_ok=True)

    def _tile(a):
        """A (1, ...) host array as a tensor on the device, repeated to the
        rep batch."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t.expand((rpb,) + tuple(t.shape[1:])).contiguous()

    def draw(batch, generator):
        v = [_tile(a) for a in (batch.get("conditioning_values") or [])]
        if cfg.data.conditioning_values == 0:
            v = []
        gen = generator if sfm_stochastic else None
        if is_sfm and sharded is not None:
            return sharded(_tile(batch["x0"]), v, gen)
        if is_sfm:
            return model.draw_samples(
                _tile(batch["x0"]), n_sampling_steps=args.n_sampling_steps,
                v_conditionings=v, method=args.sfm_method, generator=gen)
        cond = batch.get("conditioning")
        if sharded is not None:
            return sharded(generator, None if cond is None else _tile(cond),
                           v)
        return model.draw_samples(
            generator, batch_size=rpb, n_sampling_steps=args.n_sampling_steps,
            s_conditioning=None if cond is None else _tile(cond),
            v_conditionings=v)

    def campaign(batch_filter, reps, name_fn):
        if reps % rpb:
            ap.error(f"--reps-per-batch ({rpb}) must divide the campaign's "
                     f"reps ({reps})")
        count = 0
        for i_batch, batch in enumerate(dm.test_dataloader()):
            if count == args.boxes:
                break
            if not batch_filter(i_batch):
                continue
            if deterministic:
                one = to_np(nlast_to_nchw(draw(batch, None)).float())
                out = np.repeat(one, reps, axis=0)
                if rank0:
                    print(f"[generate] box {i_batch} drawn once for {reps} "
                          f"reps (deterministic SFM)", flush=True)
            else:
                gens = []
                for r in range(0, reps, rpb):
                    gen = draw(batch, rngs.next())
                    gens.append(to_np(nlast_to_nchw(gen).float()))
                    if rank0:
                        print(f"[generate] box {i_batch} rep "
                              f"{r + rpb}/{reps}", flush=True)
                out = np.concatenate(gens, axis=0)
            if rank0:  # every rank holds the gathered samples
                np.save(os.path.join(args.save_path, name_fn(count, i_batch)),
                        out)
            count += 1

    if args.runtype == "CV_12_12":
        campaign(lambda i: i < 12, 12, lambda c, i: f"gen_{c}.npy")
    elif args.runtype == "CV_1_128":
        campaign(lambda i: i == 2, 128, lambda c, i: f"gen_{c}.npy")
    else:
        reps = 24 if args.runtype == "1P_24" else 128
        campaign(
            lambda i: i in ONE_P_INDICES,
            reps,
            lambda c, i: f"{ONE_P_NAMES[ONE_P_INDICES.index(i)]}_{reps}.npy",
        )
    if mesh is not None:  # no rank returns before rank 0's files exist
        import torch.distributed as dist

        dist.barrier()
    if rank0:
        print(f"[generate] campaign {args.runtype} written to "
              f"{args.save_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
