"""Dataset production CLI: counterpart of ``vdm4cdm_tpu/cli/prepare_data.py``
(scripted replacements for the reference's data-prep notebooks):

  downsample — trilinear-downsample 256^3 grid stacks to {128,160,192,224}^3
               as ``jax.image.resize(..., "trilinear")`` does it, which
               antialiases: a separable resample by one (out, in) weight
               matrix an axis, applied as three matmuls on the device (the
               CUDA card unless ``--device`` names another).
               ``F.interpolate(mode="trilinear")`` has no 3D antialias and
               would give another field.
  project    — 3D -> 2D slabs with linear-taper depth weights (numpy).
  normalize  — per-field log-space mean/std over a set -> normalizations
               JSON (numpy).

All deterministic and streaming (one simulation at a time).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .._device import resolve_device
from ._common import add_device_arg


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """The (n_in, n_out) weights of ``jax.image.resize``'s triangle kernel
    along one axis: samples at half-pixel centres, the kernel widened by
    1 / scale when downsampling (antialias), each output's weights
    normalised to sum to 1, outputs whose centre lies outside the input
    given none. float64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_trilinear(vol: torch.Tensor, out_size: int) -> torch.Tensor:
    """A 3D volume resized to ``out_size``^3 on its device, f32: one
    weight matrix a spatial axis, each applied as a matmul."""
    out = vol.float()
    for axis in range(3):
        w = torch.as_tensor(resize_weights(out.shape[axis], out_size),
                            dtype=torch.float32, device=out.device)
        out = torch.movedim(torch.movedim(out, axis, -1) @ w, -1, axis)
    return out


def cmd_downsample(args):
    device = resolve_device(args.device)
    data = np.load(args.input, mmap_mode="r")
    n = len(data)
    out = None
    for i in range(n):
        vol = torch.from_numpy(np.array(data[i], np.float32)).to(device)
        ds = resize_trilinear(vol, args.size).cpu().numpy()
        if out is None:
            out = np.lib.format.open_memmap(
                args.output, mode="w+", dtype=np.float32, shape=(n, *ds.shape)
            )
        if args.conserve_mass:
            # mass-weighted fields: preserve the total, not the mean
            ds = ds * (np.asarray(data[i]).sum() / max(ds.sum(), 1e-30))
        out[i] = ds
        print(f"[downsample] {i + 1}/{n}", flush=True)
    out.flush()
    print(f"[downsample] wrote {args.output} shape {out.shape}")


def cmd_project(args):
    """3D (N, R, R, R) -> 2D maps (N*nslabs, R, R): sum over a depth slab with
    linear taper weights at both slab edges."""
    data = np.load(args.input, mmap_mode="r")
    n = len(data)
    size = data.shape[-1]
    depth = args.depth
    nslabs = size // depth
    taper = np.ones(depth, np.float32)
    if args.taper > 0:
        ramp = np.linspace(0, 1, args.taper + 1, dtype=np.float32)[1:]
        taper[: args.taper] = ramp
        taper[-args.taper :] = ramp[::-1]
    maps = []
    for i in range(n):
        vol = np.asarray(data[i], np.float32)
        for s in range(nslabs):
            slab = vol[s * depth : (s + 1) * depth]
            maps.append((slab * taper[:, None, None]).sum(0))
        print(f"[project] {i + 1}/{n}", flush=True)
    out = np.stack(maps)
    np.save(args.output, out)
    print(f"[project] wrote {args.output} shape {out.shape}")


def cmd_normalize(args):
    """Compute per-field log10(x + alpha) mean/std -> normalizations JSON."""
    result = {}
    alphas = json.load(open(args.alphas)) if args.alphas else {}
    for spec in args.fields:
        name, path = spec.split("=", 1)
        alpha = float(alphas.get(name, 1.0))
        data = np.load(path, mmap_mode="r")
        s1, s2, count = 0.0, 0.0, 0
        for i in range(len(data)):
            logx = np.log10(np.asarray(data[i], np.float64) + alpha)
            s1 += logx.sum()
            s2 += (logx**2).sum()
            count += logx.size
        mean = s1 / count
        std = float(np.sqrt(s2 / count - mean**2))
        result[f"{name}_m"] = float(mean)
        result[f"{name}_s"] = std
        print(f"[normalize] {name}: mean={mean:.4f} std={std:.4f}", flush=True)
    if os.path.exists(args.output) and args.merge:
        existing = json.load(open(args.output))
        existing.update(result)
        result = existing
    with open(args.output, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[normalize] wrote {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dataset production tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("downsample", help="trilinear-downsample a 3D grid stack")
    d.add_argument("input"), d.add_argument("output")
    d.add_argument("--size", type=int, required=True)
    d.add_argument("--conserve-mass", action="store_true")
    add_device_arg(d)
    d.set_defaults(fn=cmd_downsample)

    p = sub.add_parser("project", help="project 3D grids to tapered 2D slabs")
    p.add_argument("input"), p.add_argument("output")
    p.add_argument("--depth", type=int, required=True)
    p.add_argument("--taper", type=int, default=4)
    p.set_defaults(fn=cmd_project)

    n = sub.add_parser("normalize", help="compute log-space normalizations")
    n.add_argument("fields", nargs="+", metavar="NAME=PATH.npy")
    n.add_argument("--output", required=True)
    n.add_argument("--alphas", default=None, help="alphas JSON for log offsets")
    n.add_argument("--merge", action="store_true")
    n.set_defaults(fn=cmd_normalize)

    args = ap.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
