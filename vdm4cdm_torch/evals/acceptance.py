"""The blessed model's acceptance gate: counterpart of the JAX package's
``tests/test_acceptance.py``, as statistics of posterior samples against
their ground-truth boxes and the thresholds they are held to.

``gate_statistics`` takes the samples and boxes as tensors on any one
device (P(k) and r(k) run there, the pixel histograms on the host, as
numpy's are in the JAX gate); ``ddnm_statistics`` takes a DDNM inpainting
of a box whose masked part was observed. ``gate_passes`` says, for each
statistic given, whether it is inside its threshold. ``run_gate`` is the
whole gate on a model: the test loader's first boxes, posterior samples
drawn through the model's sampler (or given), every statistic and its
verdict, as ``test_acceptance.py`` takes them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.array import nlast_to_nchw
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
# the JAX gate's draw: boxes 0 and 1 of the test loader, 4 posterior samples
# each at 100 sampler steps (one generator per box, seeded 1000 + box);
# DDNM on box 0 with its first half observed, 50 steps, time travel l = 3
GATE_BOXES, GATE_REPS, GATE_STEPS = 2, 4, 100
DDNM_STEPS, DDNM_L, DDNM_SEED = 50, 3, 123
# the statistics recorded for the JAX package's run of the same model
# (test_acceptance.py's docstrings), and those of its weights converted to
# this package and gated on an H100 (NVIDIA H100 80GB HBM3, 700 W)
GATE_JAX_RECORDED = {"pk_ratio": "[0.79, 1.29]", "overlap": "0.38",
                     "low_k_r": "min 0.967", "spread_over_std": "not recorded",
                     "ddnm_consistency": "not recorded", "ddnm_hole_r": "0.93"}
GATE_CONVERTED_CARD = {"pk_ratio": "[0.798, 1.219]", "overlap": "0.353",
                       "low_k_r": "min 0.940", "spread_over_std":
                       "not recorded", "ddnm_consistency": "2.4e-7",
                       "ddnm_hole_r": "not recorded"}


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


def gate_boxes(cfg, n_boxes: int = GATE_BOXES) -> list:
    """The first ``n_boxes`` batches of the CV test loader of the model's
    config, one box each (channels-last numpy dicts)."""
    from ..config import ExperimentConfig, build_datamodule

    cfg = ExperimentConfig.from_dict(cfg.to_dict())
    cfg.data.set_name, cfg.data.batch_size = "CV", 1
    boxes = []
    for i, batch in enumerate(build_datamodule(cfg, stage="test")
                              .test_dataloader()):
        if i >= n_boxes:
            break
        boxes.append(batch)
    return boxes


@dataclasses.dataclass
class GateResult:
    """``stats``: every statistic, JSON-ready (``pk_ratio`` as its [min,
    max], ``low_k_r`` one per sample); ``passes``: each one's verdict;
    the wall seconds of the draw (0 when the samples were given) and of
    DDNM."""
    stats: Dict[str, object]
    passes: Dict[str, bool]
    sample_s: float
    ddnm_s: float

    @property
    def failed(self) -> list:
        return [k for k in THRESHOLDS if not self.passes.get(k, False)]

    def table(self, converted: bool = False) -> Dict[str, dict]:
        """{statistic: {measured, threshold, jax_recorded, pass}}, with the
        converted model's card figure as ``converted_card`` when asked."""
        out = {}
        for k in THRESHOLDS:
            row = {"measured": self.stats[k], "threshold": THRESHOLDS[k],
                   "jax_recorded": GATE_JAX_RECORDED[k],
                   "pass": self.passes[k]}
            if converted:
                row["converted_card"] = GATE_CONVERTED_CARD[k]
            out[k] = row
        return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_gate(vdm, cfg, samples: Optional[torch.Tensor] = None) -> GateResult:
    """The acceptance gate of a VDM (its weights loaded, on its device) on
    the first GATE_BOXES boxes of ``cfg``'s test loader. ``samples``
    (GATE_BOXES * GATE_REPS, 1, *spatial), channels-first, GATE_REPS
    consecutive ones per box: the posterior draws to judge; None draws them
    here, GATE_REPS a box at GATE_STEPS with a generator seeded 1000 + box.
    Then DDNM on box 0 with its first half observed, DDNM_STEPS steps with
    time travel DDNM_L."""
    from ..diffusion.ddnm import ddnm_sample

    device = vdm.device
    n_reps = GATE_REPS
    boxes = gate_boxes(cfg)

    def on_device(a, reps=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t if reps is None else t[:1].expand(
            (reps,) + tuple(t.shape[1:])).contiguous()

    sample_s = 0.0
    if samples is None:
        gens = []
        _sync(device)
        t0 = time.perf_counter()
        for i, b in enumerate(boxes):
            gen = vdm.draw_samples(
                torch.Generator(device=device).manual_seed(1000 + i),
                batch_size=n_reps, n_sampling_steps=GATE_STEPS,
                s_conditioning=on_device(b["conditioning"], n_reps),
                v_conditionings=[on_device(a, n_reps)
                                 for a in b["conditioning_values"]])
            gens.append(nlast_to_nchw(gen).float())
        samples = torch.cat(gens)
        _sync(device)
        sample_s = time.perf_counter() - t0
    gt = np.concatenate([np.moveaxis(b["x"], -1, 1) for b in boxes])
    stats = gate_statistics(samples.to(device),
                            on_device(gt.astype(np.float32)), n_reps)

    b0 = boxes[0]
    x = on_device(b0["x"])
    mask = torch.zeros_like(x)
    mask[:, : x.shape[1] // 2] = 1.0
    A = lambda z: z * mask  # noqa: E731
    _sync(device)
    t0 = time.perf_counter()
    x_hat = ddnm_sample(
        vdm, A(x), A, A, n_sampling_steps=DDNM_STEPS, l=DDNM_L,
        s_conditioning=on_device(b0["conditioning"]),
        v_conditionings=[on_device(a) for a in b0["conditioning_values"]],
        generator=torch.Generator(device=device).manual_seed(DDNM_SEED))
    _sync(device)
    ddnm_s = time.perf_counter() - t0
    stats.update(ddnm_statistics(x_hat, x, mask))
    passes = gate_passes(stats)
    stats["pk_ratio"] = [float(stats["pk_ratio"].min()),
                         float(stats["pk_ratio"].max())]
    stats["low_k_r"] = [float(r) for r in stats["low_k_r"]]
    return GateResult(stats, passes, sample_s, ddnm_s)
