"""Training CLI: counterpart of ``vdm4cdm_tpu/cli/train.py``.

Usage:
    python -m vdm4cdm_torch.cli.train --preset trainVDM3D128_c_c \
        --set data.kind=grf run.max_steps=1000
    python -m vdm4cdm_torch.cli.train --config my_experiment.yaml
    python -m vdm4cdm_torch.cli.train --preset smoke_sfm_3d --device cpu

Runs on the CUDA card unless ``--device`` names another device; without a
card and without ``--device cpu`` it raises. The run's directory is
``<run.out_dir>/<run.experiment_name>/`` (``metrics.csv`` and
``checkpoints/<step>/``); running the same command again resumes from its
latest checkpoint. ``--config`` reads YAML (PyYAML); ``--preset`` needs
nothing beyond torch and numpy.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .._device import resolve_device
from ._common import (add_device_arg, apply_overrides, parse_overrides,
                      require_unsharded)

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
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..config import ExperimentConfig, build_datamodule, build_model
    from ..presets import preset as get_preset
    from ..train import TrainConfig, Trainer
    from ..train.checkpoint import load_params
    from ..utils.array import count_params

    if args.config:
        cfg = ExperimentConfig.load(args.config)
    elif args.preset:
        cfg = get_preset(args.preset)
    else:
        ap.error("need --preset or --config")
    apply_overrides(cfg, parse_overrides(args.overrides))
    require_unsharded(cfg)
    device = resolve_device(args.device)

    model = build_model(cfg, device=device,
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
    trainer = Trainer(model, tc)

    if cfg.run.warm_start_ckpt:
        load_params(cfg.run.warm_start_ckpt, model)
        print(f"[train] warm-started params from {cfg.run.warm_start_ckpt}")

    print(f"[train] experiment={cfg.run.experiment_name} family={cfg.model.family} "
          f"ndim={cfg.model.ndim} crop={cfg.data.cropsize} chs={list(cfg.model.chs)} "
          f"device={device}", flush=True)
    state = trainer.fit(dm)
    print(f"[train] done at step {state.step}; params={count_params(model):,}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
