"""Data-product sanity check, the scripted equivalent of the reference's
scripts/check_cc.ipynb: cross-correlate two field stacks (a downsampled
product against its source, or Mstar against Mcdm) and report r(k):

    python -m vdm4cdm_torch.examples.check_cc A=path_a.npy B=path_b.npy \
        [--n 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def cross_correlation(a: np.ndarray, b: np.ndarray, device) -> tuple:
    """(k, r(k)) of two (N, [C,] *spatial) stacks, each field normalized to
    unit total first (the reference's convention for mass-weighted fields):
    k (kmax,), r (N, kmax) as numpy."""
    from ..evals import get_ccs
    from ..utils.array import to_np

    if a.shape != b.shape:
        raise ValueError(f"{a.shape} != {b.shape}")
    if a.ndim in (3, 4):  # no channel dim: (N, 1, *spatial)
        a, b = np.asarray(a)[:, None], np.asarray(b)[:, None]
    axes = tuple(range(2, a.ndim))
    a = a / a.sum(axis=axes, keepdims=True)
    b = b / b.sum(axis=axes, keepdims=True)
    ks, ccs = get_ccs(torch.as_tensor(a, dtype=torch.float32, device=device),
                      torch.as_tensor(b, dtype=torch.float32, device=device))
    return to_np(ks[0]), to_np(ccs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("fields", nargs=2, metavar="NAME=PATH.npy")
    ap.add_argument("--n", type=int, default=4,
                    help="number of sims to check")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from .._device import resolve_device

    (name_a, path_a), (name_b, path_b) = (s.split("=", 1)
                                          for s in args.fields)
    a = np.load(path_a, mmap_mode="r")[: args.n]
    b = np.load(path_b, mmap_mode="r")[: args.n]
    _, ccs = cross_correlation(a, b, resolve_device(args.device))
    print(f"cross-correlation r(k) of {name_a} x {name_b} over {len(a)} "
          "sims:")
    for i in range(len(ccs)):
        print(f"  sim {i}: " + " ".join(f"{v:+.3f}" for v in ccs[i]))
    print("mean r(k):", " ".join(f"{v:+.3f}" for v in ccs.mean(0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
