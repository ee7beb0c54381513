"""Bless a trained run: counterpart of the JAX package's ``tools/bless.py``.

    python -m vdm4cdm_torch.cli.bless NAME [--step S] [--run-dir D] [--out D]
        [--ema-only]

Copies the parameters of one step of a run's keep-all checkpoints
(``train/checkpoint.py``; default the latest step of
``runs/NAME/checkpoints``, where ``cli.train --preset NAME`` writes them)
into a compact checkpoint of the same format without the optimizer state:
``{params, ema_params}`` with ``opt_state`` None, or with ``--ema-only``
the EMA alone (``params`` None, the converted blessed copy's layout, which
``load_params(prefer_ema=False)`` refuses). The copy is written as
``<out>/<step>/checkpoint.pt`` (default ``runs/blessed/NAME``, a directory
git ignores: trained weights are not committed) and is what a registry
entry's ``ckpt_dir`` names for ``cli.generate``. A missing step is an error
that lists the steps there are; a JAX (orbax) directory is refused. The copy
is read back onto the device (the CUDA card unless ``--device`` names
another) and held bit for bit against the run's tensors.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from .._device import resolve_device
from ..train.checkpoint import FORMAT, read_checkpoint, write_payload
from ._common import add_device_arg


def bless(run_dir: str, out: str, step=None, ema_only: bool = False,
          device="cpu") -> dict:
    """Write the blessed copy of ``step`` (None = the latest) of the run
    checkpoints in ``run_dir`` under ``out`` and check it, read back onto
    ``device``, against the run's tensors; returns {"step", "src", "path",
    "bytes"}."""
    payload = read_checkpoint(run_dir, step)
    ema = payload.get("ema_params")
    if ema_only and ema is None:
        raise ValueError(f"{run_dir} step {payload['step']} has no EMA "
                         f"to bless alone")
    blessed = {"format": FORMAT, "step": int(payload["step"]),
               "params": None if ema_only else payload["params"],
               "opt_state": None, "ema_params": ema}
    path = write_payload(out, blessed)
    back = read_checkpoint(out, blessed["step"])
    for tree in ("params", "ema_params"):
        want, got = blessed[tree], back[tree]
        if want is None:
            continue
        for k, t in want.items():
            if not torch.equal(got[k].to(device), t.to(device)):
                raise RuntimeError(f"{path}: {tree}.{k} differs from the run")
    return {"step": blessed["step"], "src": os.path.abspath(run_dir),
            "path": path, "bytes": os.path.getsize(path)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Copy one step of a training run's parameters into a "
                    "compact checkpoint for the model registry")
    ap.add_argument("name", help="the run's experiment name")
    ap.add_argument("--step", type=int, default=None,
                    help="default: the latest")
    ap.add_argument("--run-dir", default=None,
                    help="source checkpoints (default runs/NAME/checkpoints)")
    ap.add_argument("--out", default=None,
                    help="destination checkpoint directory (default "
                         "runs/blessed/NAME)")
    ap.add_argument("--ema-only", action="store_true",
                    help="write the EMA alone (params None)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    src = args.run_dir or os.path.join("runs", args.name, "checkpoints")
    dst = args.out or os.path.join("runs", "blessed", args.name)
    info = bless(src, dst, args.step, args.ema_only, device)
    print(f"[bless] {args.name} step {info['step']}: {info['src']} -> "
          f"{info['path']} ({info['bytes'] / 1e6:.1f} MB)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
