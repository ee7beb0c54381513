"""DDNM zero-shot inpainting, the scripted equivalent of the reference's
notebook use of get_ddnm_result (reference src/utils.py:277-304): mask a
region of a field, then sample a completion consistent with the observed
part using a trained (or, for a smoke run, fresh) VDM:

    python -m vdm4cdm_torch.examples.ddnm_inpainting \
        [--ckpt-dir runs/.../checkpoints] [--device cpu] [--steps 50] \
        [--travel 3]

The model is ``smoke_vdm_2d`` without conditioning. The three panels
(ground truth, observed, completion) are a PNG where matplotlib is
installed; without it they go to an ``.npz`` beside it and the script says
so.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--travel", type=int, default=3,
                    help="DDNM time-travel depth l")
    ap.add_argument("--out", type=str, default="runs/examples/ddnm_demo.png")
    ap.add_argument("--set", dest="overrides", nargs="*",
                    metavar="SEC.KEY=VAL",
                    help="config overrides of the smoke_vdm_2d preset (as "
                         "the checkpoint was trained)")
    args = ap.parse_args(argv)

    from .._device import resolve_device
    from ..cli._common import apply_overrides, parse_overrides
    from ..config import build_datamodule, build_model
    from ..diffusion import ddnm_sample
    from ..presets import preset
    from ..train.checkpoint import load_params
    from ..utils.array import to_np

    device = resolve_device(args.device)
    cfg = preset("smoke_vdm_2d")
    cfg.data.conditioning_values = 0
    cfg.data.in_field = None
    apply_overrides(cfg, parse_overrides(args.overrides))
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(0))
    if args.ckpt_dir:
        load_params(args.ckpt_dir, model)
    model.eval()

    batch = next(iter(build_datamodule(cfg, stage="fit").val_dataloader()))
    x = torch.from_numpy(np.ascontiguousarray(batch["x"][:1])).to(device)

    # the inpainting operator: observe the left half
    size = x.shape[1]
    mask = torch.zeros_like(x)
    mask[:, :, : size // 2] = 1.0

    def A(z):
        return z * mask

    y = A(x)
    x_hat = ddnm_sample(model, y, A, A, n_sampling_steps=args.steps,
                        l=args.travel,
                        generator=torch.Generator(device=device)
                        .manual_seed(1))
    consistency = float((A(x_hat) - y).abs().max())
    print(f"measurement consistency |A(x̂)-y|∞ = {consistency:.2e}")
    if not bool(torch.isfinite(x_hat).all()):
        raise FloatingPointError("the completion is not finite")

    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    panels = [(to_np(im)[0, :, :, 0], title) for im, title in
              ((x, "ground truth"), (y, "observed (masked)"),
               (x_hat, "DDNM completion"))]
    if importlib.util.find_spec("matplotlib") is None:
        path = os.path.splitext(args.out)[0] + ".npz"
        np.savez(path, **{t.split(" ")[0]: im for im, t in panels})
        print(f"matplotlib is not installed: the panels' arrays go to {path}")
        return 0
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, (im, title) in zip(axes, panels):
        ax.imshow(im)
        ax.set_title(title)
        ax.axis("off")
    fig.savefig(args.out, dpi=80, bbox_inches="tight")
    print(f"figure: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
