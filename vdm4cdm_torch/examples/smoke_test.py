"""Smoke test, the scripted equivalent of the reference's test.ipynb: build
a data module and a model, inspect a batch, train a few steps, draw samples,
cross-correlate them with the batch and write the validation panel. Runs
anywhere (synthetic GRF data):

    python -m vdm4cdm_torch.examples.smoke_test [--steps 100] [--device cpu]

The panel is a PNG where matplotlib is installed; without it the panel's
arrays go to ``smoke_panel.npz`` (``evals.figures.panel_data``) and the
script says so.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch


def save_panel(panel: dict, out_dir: str, name: str) -> str:
    """The panel as ``<name>.png`` with matplotlib, else its images,
    histograms and curves as ``<name>.npz``; returns the path written."""
    if importlib.util.find_spec("matplotlib") is not None:
        from ..evals.figures import render

        path = os.path.join(out_dir, f"{name}.png")
        render(panel).savefig(path, dpi=70)
        return path
    arrays = {f"image_{k.replace(' ', '_')}": v
              for k, v in panel["images"].items()}
    arrays["hist_edges"] = np.asarray(panel["hist_bins"])
    for i, (_, _, counts) in enumerate(panel["hist"]):
        arrays[f"hist_{i}"] = counts
    for kind in ("pk", "cc"):
        for i, (_, ks, ys) in enumerate(panel[kind]):
            arrays[f"{kind}_{i}_k"], arrays[f"{kind}_{i}"] = ks, ys
    path = os.path.join(out_dir, f"{name}.npz")
    np.savez(path, **arrays)
    print(f"matplotlib is not installed: the panel's arrays go to {path}")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", type=str, default="runs/examples/smoke")
    ap.add_argument("--set", dest="overrides", nargs="*",
                    metavar="SEC.KEY=VAL",
                    help="config overrides of the smoke_vdm_2d preset")
    args = ap.parse_args(argv)

    from .._device import resolve_device
    from ..cli._common import apply_overrides, parse_overrides
    from ..config import build_datamodule, build_model
    from ..evals import get_ccs, panel_data
    from ..presets import preset
    from ..train import TrainConfig, Trainer
    from ..utils.array import count_params, nlast_to_nchw, to_np

    device = resolve_device(args.device)
    cfg = preset("smoke_vdm_2d")
    cfg.run.max_steps = args.steps
    cfg.run.out_dir = args.out
    apply_overrides(cfg, parse_overrides(args.overrides))
    os.makedirs(args.out, exist_ok=True)

    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(cfg.run.seed))
    dm = build_datamodule(cfg)
    batch = next(iter(dm.val_dataloader()))
    print("batch:", {k: (None if v is None else
                         np.asarray(v[0] if isinstance(v, list) else v).shape)
                     for k, v in batch.items()})

    tc = TrainConfig(max_steps=cfg.run.max_steps, val_check_interval=0,
                     ckpt_every_steps=10 ** 9, learning_rate=2e-3,
                     out_dir=args.out, experiment_name="smoke")
    state = Trainer(model, tc).fit(dm)
    print(f"trained {state.step} steps; params={count_params(model):,}")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a[:2])).to(device)

    model.eval()
    samples = model.draw_samples(
        torch.Generator(device=device).manual_seed(0), batch_size=2,
        n_sampling_steps=100,
        s_conditioning=dev(batch["conditioning"]),
        v_conditionings=[dev(v) for v in batch["conditioning_values"]])
    print("samples:", tuple(samples.shape), "std:", float(samples.std()))
    if not bool(torch.isfinite(samples).all()):
        raise FloatingPointError("the samples are not finite")

    x = dev(batch["x"])
    _, ccs = get_ccs(nlast_to_nchw(samples), nlast_to_nchw(x))
    print("cross-correlation r(k):", np.round(to_np(ccs.mean(0)), 2))

    panel = panel_data({k: (None if v is None else
                            [dev(a) for a in v] if isinstance(v, list)
                            else dev(v)) for k, v in batch.items()},
                       samples, x_to_im=lambda f: f[0],
                       conditioning_to_im=lambda f: f[0])
    print(f"figure: {save_panel(panel, args.out, 'smoke_panel')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
