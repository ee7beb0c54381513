"""The blessed model's acceptance gate: counterpart of the JAX package's
``tests/test_acceptance.py``, as statistics of posterior samples against
their ground-truth boxes and the thresholds they are held to.

``gate_statistics`` takes the samples and boxes as tensors on any one
device (P(k) and r(k) run there, the pixel histograms on the host, as
numpy's are in the JAX gate); ``ddnm_statistics`` takes a DDNM inpainting
of a box whose masked part was observed. ``gate_passes`` says, for each
statistic given, whether it is inside its threshold.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import spectra

# statistic -> threshold (the JAX gate's constants)
THRESHOLDS = {
    "pk_ratio": (0.5, 2.0),     # mean sample over mean GT P(k), every k
    "overlap": 0.25,            # pixel-value histogram overlap, at least
    "low_k_r": 0.7,             # r(k) over the lowest quarter of k, at least
    "spread_over_std": 0.05,    # std over reps / field std, more than
    "ddnm_consistency": 1e-4,   # |A(x_hat) - y| max, less than
    "ddnm_hole_r": 0.5,         # r of x_hat and x in the hole, more than
}
PDF_BINS = np.linspace(-4.0, 4.0, 51)


def gate_statistics(gen: torch.Tensor, gt: torch.Tensor,
                    n_reps: int) -> Dict[str, object]:
    """The gate's four statistics: gen (boxes * n_reps, 1, *spatial)
    posterior samples, n_reps consecutive ones per box, and gt (boxes, 1,
    *spatial), channels-first f32. ``pk_ratio`` and ``low_k_r`` (one per
    sample) are numpy arrays, the others floats."""
    _, pk_gen, _ = spectra.power(gen)
    _, pk_gt, _ = spectra.power(gt)
    _, ccs = spectra.get_ccs(gen, gt.repeat_interleave(n_reps, dim=0))
    ccs = ccs.cpu().numpy()
    gen_np, gt_np = gen.cpu().numpy(), gt.cpu().numpy()
    h_gen, _ = np.histogram(gen_np, bins=PDF_BINS, density=True)
    h_gt, _ = np.histogram(gt_np, bins=PDF_BINS, density=True)
    dx = PDF_BINS[1] - PDF_BINS[0]
    per_box = gen_np.reshape(-1, n_reps, *gen_np.shape[1:])
    return {
        "pk_ratio": (pk_gen / pk_gt).cpu().numpy(),
        "overlap": float(1.0 - 0.5 * np.abs(h_gen - h_gt).sum() * dx),
        "low_k_r": ccs[:, :max(1, ccs.shape[-1] // 4)].mean(axis=1),
        "spread_over_std": float(per_box.std(axis=1).mean() / gen_np.std()),
    }


def ddnm_statistics(x_hat: torch.Tensor, x: torch.Tensor,
                    mask: torch.Tensor) -> Dict[str, float]:
    """DDNM inpainting of ``x`` observed through ``A(z) = z * mask``: the
    measurement consistency |A(x_hat) - A(x)| max, and the correlation of
    x_hat with x where the mask is 0."""
    hole = (mask == 0).cpu()
    a, b = x_hat.cpu()[hole].numpy(), x.cpu()[hole].numpy()
    return {"ddnm_consistency": float(((x_hat - x) * mask).abs().max()),
            "ddnm_hole_r": float(np.corrcoef(a, b)[0, 1])}


def gate_passes(stats: Dict[str, object]) -> Dict[str, bool]:
    """For each statistic in ``stats``, whether it passes its threshold."""
    lo, hi = THRESHOLDS["pk_ratio"]
    checks = {
        "pk_ratio": lambda v: bool(np.all(v > lo) and np.all(v < hi)),
        "overlap": lambda v: v >= THRESHOLDS["overlap"],
        "low_k_r": lambda v: bool(np.all(v >= THRESHOLDS["low_k_r"])),
        "spread_over_std": lambda v: v > THRESHOLDS["spread_over_std"],
        "ddnm_consistency": lambda v: v < THRESHOLDS["ddnm_consistency"],
        "ddnm_hole_r": lambda v: v > THRESHOLDS["ddnm_hole_r"],
    }
    return {k: bool(checks[k](v)) for k, v in stats.items()}
