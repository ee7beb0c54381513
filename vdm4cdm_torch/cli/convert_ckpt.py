"""Convert a reference torch/Lightning checkpoint to a checkpoint of this
package: counterpart of ``tools/convert_torch_ckpt.py``.

    python -m vdm4cdm_torch.cli.convert_ckpt CKPT.ckpt OUT_DIR \
        --preset trainVDM3D128_c_c [--set model.chs=...] \
        [--strip-prefix model.score_model.] [--rename 'old_re=new'] \
        [--step 320000] [--allow-missing]

The reference's trained models (reference configs.yaml:1-217) are Lightning
``.ckpt`` files holding a ``state_dict`` over mltools' torch CUNet+LightVDM.
This maps those weights onto the preset's VDM (``interop/from_torch.py``)
and writes ``OUT_DIR/<step>/checkpoint.pt`` in this package's format
(``train/checkpoint.py``; no optimizer state), which
``python -m vdm4cdm_torch.cli.generate ... --ckpt-dir OUT_DIR`` samples
from. Runs on the CPU; needs torch and numpy only. The file is read with
``torch.load(weights_only=False)``, as a Lightning checkpoint holds more
than tensors: convert only checkpoints you trust.

mltools is not distributed with the reference, so a real checkpoint may name
modules differently: ``--rename`` regex pairs fix that (the conversion is
shape-driven and prints every missing and unused key).
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert a reference torch checkpoint (VDM) to this "
                    "package's checkpoint format")
    ap.add_argument("ckpt", help="torch .ckpt/.pt file (Lightning or plain "
                                 "state_dict)")
    ap.add_argument("out_dir", help="checkpoint directory to write into "
                                    "(OUT_DIR/<step>/checkpoint.pt)")
    ap.add_argument("--preset", required=True,
                    help="model preset matching the checkpoint's "
                         "architecture")
    ap.add_argument("--set", dest="overrides", nargs="*",
                    metavar="SEC.KEY=VAL")
    ap.add_argument("--strip-prefix", default=None,
                    help="key prefix to strip (default: up to the first "
                         "'score_model.')")
    ap.add_argument("--rename", nargs="*", default=[], metavar="REGEX=REPL",
                    help="regex renames applied to torch keys after "
                         "stripping")
    ap.add_argument("--step", type=int, default=0,
                    help="step label of the checkpoint (e.g. the "
                         "reference's trained steps)")
    ap.add_argument("--allow-missing", action="store_true",
                    help="leave parameters missing from the state_dict at "
                         "their initial values instead of failing")
    args = ap.parse_args(argv)

    import torch

    from ..config import build_model
    from ..interop.from_torch import params_from_torch, strip_and_rename
    from ..presets import preset as get_preset
    from ..train.checkpoint import FORMAT, write_payload
    from ._common import apply_overrides, parse_overrides

    cfg = get_preset(args.preset)
    apply_overrides(cfg, parse_overrides(args.overrides))
    if cfg.model.family != "vdm":
        ap.error(f"{args.preset} is an {cfg.model.family.upper()}: the "
                 "converter maps reference VDM checkpoints only")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))

    raw = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    renames = [tuple(r.split("=", 1)) for r in args.rename]
    sd = strip_and_rename(sd, strip_prefix=args.strip_prefix,
                          regex_renames=renames)

    params, report = params_from_torch(sd, model,
                                       strict=not args.allow_missing)
    if report["missing"]:
        print(f"[convert] {len(report['missing'])} params left at init, "
              f"e.g. {report['missing'][:5]}")
        for name, p in model.named_parameters():
            params.setdefault(name, p.detach().to("cpu", torch.float32))
    if report["unused"]:
        print(f"[convert] {len(report['unused'])} torch keys unused, e.g. "
              f"{report['unused'][:5]}")
    if not report["gamma_found"]:
        print("[convert] no gamma.{b,w} in state_dict -> schedule at init "
              "(use --rename to map the checkpoint's schedule params)")
    path = write_payload(args.out_dir, {
        "format": FORMAT, "step": args.step, "params": params,
        "opt_state": None, "ema_params": None})
    print(f"[convert] wrote step {args.step} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
