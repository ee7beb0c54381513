"""The trained-model chain: counterpart of the JAX package's
``tools/blessed_chain.sh``, in Python.

    python -m vdm4cdm_torch.cli.blessed_chain [--out DIR] [--until STEP]
        [--stages train,bless,generate,calc_ss,gate] [--set SEC.KEY=VAL ...]

Trains ``VDM_GRF_c_c_32`` from scratch and takes it through the entry points
a user runs, each stage in this process:

  train     ``cli.train --preset VDM_GRF_c_c_32`` into ``<out>/runs``;
            ``--until S`` stops at step S, and the same command carries the
            run on from its latest checkpoint (the learning rate is constant,
            so a run split over several calls is the same run). After it,
            the latest checkpoint's params and EMA and every logged loss
            must be finite (``utils/profiling.py::assert_finite``);
  bless     ``cli.bless`` of the registry's step (the preset's
            ``run.max_steps``, 20000) into ``<out>/blessed``;
  generate  a registry of its own, ``<out>/models.yaml``, naming the blessed
            copy, and ``cli.generate VDM_GRF_c_c_32 <out>/CV_12_12 CV_12_12``
            from it (12 reps a call, 250 sampler steps);
  calc_ss   ``cli.calc_ss`` of ``<out>`` (``<out>/summary.pkl``);
  gate      the acceptance gate (``evals/acceptance.py::run_gate``) on the
            blessed copy: boxes 0 and 1, 4 samples each at 100 steps, DDNM
            at 50 steps and l = 3, as the JAX package's test_acceptance.py.

Each stage prints one JSON line with its seconds (train also the median
``step_s`` and mean ``feed_wait_s`` of its rows of ``metrics.csv``, and its
validation losses); the gate's line gives every statistic beside its
threshold, the JAX run's recorded value and the converted JAX model's figure
on the card. The exit code is 1 when the gate fails (the failing statistics
are named); a non-finite run raises, naming the step and the leaves. Runs on
the CUDA card unless ``--device`` names another device (``cpu`` runs the
kernels' plain versions). ``--set`` overrides the preset in every stage.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import statistics
import sys

from ._common import add_device_arg, apply_overrides, parse_overrides

NAME = "VDM_GRF_c_c_32"
STAGES = ("train", "bless", "generate", "calc_ss", "gate")
CAMPAIGN = "CV_12_12"
REPS_PER_BATCH = 12  # posterior samples a sampler call, as the JAX script


class Chain:
    """Paths and arguments of one chain directory."""

    def __init__(self, out: str, overrides, device, n_sampling_steps: int):
        from ..presets import preset

        self.out = os.path.abspath(out)
        self.overrides = list(overrides or [])
        self.device = device
        self.n_sampling_steps = n_sampling_steps
        self.cfg = preset(NAME)
        apply_overrides(self.cfg, parse_overrides(self.overrides))
        self.run_dir = os.path.join(self.out, "runs", NAME)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        self.blessed_dir = os.path.join(self.out, "blessed", NAME)
        self.registry = os.path.join(self.out, "models.yaml")
        self.step = self.cfg.run.max_steps  # the registry's step

    def cli_tail(self, out_dir_override: bool = False) -> list:
        sets = self.overrides + ([f"run.out_dir={self.out}/runs"]
                                 if out_dir_override else [])
        tail = ["--set", *sets] if sets else []
        if self.device is not None:
            tail += ["--device", str(self.device)]
        return tail


def read_metrics(path: str) -> list:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _floats(rows, key):
    return [float(r[key]) for r in rows if r.get(key) not in (None, "")]


def stage_train(chain: Chain, until) -> dict:
    from ..train.checkpoint import all_steps, read_checkpoint
    from ..utils.profiling import assert_finite
    from . import train

    steps = all_steps(chain.ckpt_dir)
    start = steps[-1] if steps else 0
    argv = ["--preset", NAME] + chain.cli_tail(out_dir_override=True)
    if until is not None:
        argv += ["--until", str(until)]
    rc = train.main(argv)
    if rc:
        raise RuntimeError(f"cli.train exited {rc}")
    payload = read_checkpoint(chain.ckpt_dir)
    step = payload["step"]
    rows = [r for r in read_metrics(os.path.join(chain.run_dir, "metrics.csv"))
            if int(r["step"]) > start]
    train_rows = [r for r in rows if r.get("step_s") not in (None, "")]
    assert_finite({"params": payload["params"],
                   "ema_params": payload["ema_params"],
                   "loss": {r["step"]: float(r["loss"]) for r in train_rows}},
                  f"the run at step {step}")
    step_s, wait_s = _floats(train_rows, "step_s"), _floats(train_rows,
                                                             "feed_wait_s")
    return {"from_step": start, "step": step,
            "step_s": statistics.median(step_s) if step_s else None,
            "feed_wait_s": statistics.fmean(wait_s) if wait_s else None,
            "loss_last": float(train_rows[-1]["loss"]) if train_rows else None,
            "val": {r["step"]: {k: float(v) for k, v in r.items()
                                if k.startswith("val_") and v != ""}
                    for r in rows if r.get("val_loss") not in (None, "")}}


def stage_bless(chain: Chain) -> dict:
    from . import bless

    argv = [NAME, "--step", str(chain.step), "--run-dir", chain.ckpt_dir,
            "--out", chain.blessed_dir]
    if chain.device is not None:
        argv += ["--device", str(chain.device)]
    rc = bless.main(argv)
    if rc:
        raise RuntimeError(f"cli.bless exited {rc}")
    path = os.path.join(chain.blessed_dir, str(chain.step), "checkpoint.pt")
    return {"step": chain.step, "path": path, "bytes": os.path.getsize(path)}


def write_registry(chain: Chain) -> None:
    with open(chain.registry, "w") as fh:
        fh.write(f"# the blessed copy of this chain's run "
                 f"(vdm4cdm_torch.cli.blessed_chain)\n{NAME}:\n"
                 f"  preset: {NAME}\n  ckpt_dir: {chain.blessed_dir}\n"
                 f"  ckpt_step: {chain.step}\n")


def stage_generate(chain: Chain) -> dict:
    from . import generate

    write_registry(chain)
    save = os.path.join(chain.out, CAMPAIGN)
    rc = generate.main([NAME, save, CAMPAIGN, "--model-registry",
                        chain.registry, "--reps-per-batch",
                        str(REPS_PER_BATCH), "--n-sampling-steps",
                        str(chain.n_sampling_steps)] + chain.cli_tail())
    if rc:
        raise RuntimeError(f"cli.generate exited {rc}")
    return {"campaign": CAMPAIGN, "files": len(os.listdir(save)),
            "sampling_steps": chain.n_sampling_steps}


def stage_calc_ss(chain: Chain) -> dict:
    from . import calc_ss

    rc = calc_ss.main([NAME, "--data-dir", chain.out] + chain.cli_tail())
    if rc:
        raise RuntimeError(f"cli.calc_ss exited {rc}")
    return {"summary": os.path.join(chain.out, "summary.pkl")}


def stage_gate(chain: Chain):
    from .._device import resolve_device
    from ..config import build_model
    from ..evals.acceptance import run_gate
    from ..train.checkpoint import load_params
    from ._common import read_registry

    entry = read_registry(chain.registry)[NAME]
    model = build_model(chain.cfg, device=resolve_device(chain.device)).eval()
    load_params(entry["ckpt_dir"], model, step=entry["ckpt_step"])
    result = run_gate(model, chain.cfg)
    return result, {"step": entry["ckpt_step"], "sample_s": result.sample_s,
                    "ddnm_s": result.ddnm_s,
                    "gate": result.table(converted=True),
                    "passed": not result.failed, "failed": result.failed}


def main(argv=None):
    from .._device import resolve_device
    from ..utils.profiling import StepTimer

    ap = argparse.ArgumentParser(
        description=f"Train {NAME} from scratch and take it through bless, "
                    "generate, calc_ss and the acceptance gate")
    ap.add_argument("--out", default=os.path.join("runs", "blessed_chain"),
                    help="the chain's directory (default runs/blessed_chain)")
    ap.add_argument("--until", type=int, default=None, metavar="STEP",
                    help="the train stage stops at this step")
    ap.add_argument("--stages", default=",".join(STAGES),
                    help=f"comma-separated subset of {','.join(STAGES)}")
    ap.add_argument("--n-sampling-steps", type=int, default=250,
                    help="the campaign's sampler steps")
    ap.add_argument("--set", dest="overrides", nargs="*", metavar="SEC.KEY=VAL",
                    help="preset overrides, passed to every stage")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    stages = [s for s in args.stages.split(",") if s]
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}")
    resolve_device(args.device)  # the card, or an error before any stage

    chain = Chain(args.out, args.overrides, args.device,
                  args.n_sampling_steps)
    os.makedirs(chain.out, exist_ok=True)
    timer = StepTimer(window=len(STAGES))
    timer.tick()
    failed = []
    for stage in STAGES:
        if stage not in stages:
            continue
        if stage == "train":
            facts = stage_train(chain, args.until)
        elif stage == "bless":
            facts = stage_bless(chain)
        elif stage == "generate":
            facts = stage_generate(chain)
        elif stage == "calc_ss":
            facts = stage_calc_ss(chain)
        else:
            result, facts = stage_gate(chain)
            failed = result.failed
        print(json.dumps({"chain": stage, "model": NAME,
                          "seconds": timer.tick(), **facts}), flush=True)
    if failed:
        print(f"[chain] the gate failed: {', '.join(failed)}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
