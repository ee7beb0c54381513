"""Training CLI: counterpart of ``vdm4cdm_tpu/cli/train.py``.

Usage:
    python -m vdm4cdm_torch.cli.train --preset trainVDM3D128_c_c \
        --set data.kind=grf run.max_steps=1000
    python -m vdm4cdm_torch.cli.train --config my_experiment.yaml
    python -m vdm4cdm_torch.cli.train --preset smoke_sfm_3d --device cpu
    torchrun --nproc-per-node 2 -m vdm4cdm_torch.cli.train \
        --preset trainVDM3D128_c_c --set parallel.n_sp=2
    torchrun --nproc-per-node 2 -m vdm4cdm_torch.cli.train \
        --preset train_uc_c --set parallel.n_sp=2 data.kind=grf

Runs on the CUDA card unless ``--device`` names another device; without a
card and without ``--device cpu`` it raises. The run's directory is
``<run.out_dir>/<run.experiment_name>/`` (``metrics.csv`` and
``checkpoints/<step>/``); running the same command again resumes from its
latest checkpoint. ``--until S`` stops the run at step S (a checkpoint
is written there) without changing its length: the same command without
it, or with a later S, carries the run on. ``--config`` reads YAML
(PyYAML); ``--preset`` needs nothing beyond torch and numpy. Each
validation samples from the model and hands the validation figure to the
loggers; without matplotlib the CLI says so once and trains without
figures.

``parallel.n_data`` / ``n_sp`` > 1 trains under the (data, sp) mesh, one
process a rank (``torchrun``, or ``--coordinator HOST:PORT --num-processes
N --process-id R`` on each rank; ``cli/_common.py`` says more), 3D and 2D
models alike (``sp`` splits D of a box, H of a map): the model is built on
every rank from the same seed with this rank's ``ctx``, each rank feeds its
slab of the global batch, rank 0 writes the logs and the
checkpoints, and the validation figure samples through the sharded samplers.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys

import torch

from ._common import (add_device_arg, add_dist_args, apply_overrides,
                      init_distributed, make_mesh_from_config,
                      make_validation_figure_fn, parse_overrides)

__all__ = ["main", "parse_overrides"]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a VDM/SFM field emulator (PyTorch/CUDA)")
    ap.add_argument("--preset", type=str,
                    help="preset name (see vdm4cdm_torch.presets)")
    ap.add_argument("--config", type=str,
                    help="path to an ExperimentConfig YAML")
    ap.add_argument("--set", dest="overrides", nargs="*", metavar="SEC.KEY=VAL",
                    help="config overrides, e.g. data.cropsize=128 "
                         "run.max_steps=1000")
    ap.add_argument("--until", type=int, default=None, metavar="STEP",
                    help="stop at this step (default: run.max_steps); the "
                         "run resumes from there when started again")
    add_device_arg(ap)
    add_dist_args(ap)
    args = ap.parse_args(argv)

    from ..config import ExperimentConfig
    from ..presets import preset as get_preset

    if args.config:
        cfg = ExperimentConfig.load(args.config)
    elif args.preset:
        cfg = get_preset(args.preset)
    else:
        ap.error("need --preset or --config")
    apply_overrides(cfg, parse_overrides(args.overrides))
    device, joined = init_distributed(args)
    try:
        return _train(cfg, args, device)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(cfg, args, device) -> int:
    from ..config import build_datamodule, build_model
    from ..parallel import make_shard_ctx, process_rank
    from ..train import TrainConfig, Trainer
    from ..train.checkpoint import load_params
    from ..utils.array import count_params

    mesh = make_mesh_from_config(cfg)
    ctx = make_shard_ctx(mesh) if mesh is not None else None
    rank0 = process_rank()[0] == 0
    # the same seed on every rank: the ranks start from equal parameters
    model = build_model(cfg, device=device, ctx=ctx,
                        generator=torch.Generator().manual_seed(cfg.run.seed))
    dm = build_datamodule(cfg, stage="fit")
    tc = TrainConfig(
        max_steps=cfg.run.max_steps,
        val_check_interval=cfg.run.val_check_interval,
        n_val_batches=cfg.run.n_val_batches,
        ckpt_every_steps=cfg.run.ckpt_every_steps,
        log_every_steps=cfg.run.log_every_steps,
        learning_rate=cfg.run.learning_rate,
        grad_clip=cfg.run.grad_clip,
        weight_decay=cfg.run.weight_decay,
        warmup_steps=cfg.run.warmup_steps,
        seed=cfg.run.seed,
        out_dir=cfg.run.out_dir,
        experiment_name=cfg.run.experiment_name,
        resume=cfg.run.resume,
        ema_decay=cfg.run.ema_decay,
    )
    draw_figure = None
    if importlib.util.find_spec("matplotlib") is None:
        if rank0:
            print("[train] validation figures are off: matplotlib is not "
                  "installed", flush=True)
    else:
        draw_figure = make_validation_figure_fn(cfg, model, dm)
    trainer = Trainer(model, tc, draw_figure=draw_figure)

    if cfg.run.warm_start_ckpt:
        load_params(cfg.run.warm_start_ckpt, model)  # every rank: one file
        if rank0:
            print(f"[train] warm-started params from "
                  f"{cfg.run.warm_start_ckpt}")

    if rank0:
        axes = None if mesh is None else {"data": mesh.n_data,
                                          "sp": mesh.n_sp}
        print(f"[train] experiment={cfg.run.experiment_name} "
              f"family={cfg.model.family} ndim={cfg.model.ndim} "
              f"crop={cfg.data.cropsize} chs={list(cfg.model.chs)} "
              f"mesh={axes} device={device}", flush=True)
    until = (cfg.run.max_steps if args.until is None
             else min(args.until, cfg.run.max_steps))
    state = trainer.fit(dm, max_steps=until)
    if rank0:
        print(f"[train] done at step {state.step}; "
              f"params={count_params(model):,}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
