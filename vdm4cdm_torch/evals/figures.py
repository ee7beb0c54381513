"""Validation figure: counterpart of ``vdm4cdm_tpu/evals/figures.py``.

The 2x3 panel the reference logs (src/utils.py:131-275):
  [conditioning image | GT target image | sampled target image]
  [histograms (bins -4..4) | log-log raw P(k) | cross-correlation r(k)]
VDM batches key on ``x`` / ``conditioning``; SFM batches on ``x1`` / ``x0``.

Split in two: :func:`panel_data` computes every array of the panel (the
images, the histogram counts, the P(k) and r(k) curves) on the device of
the batch and returns them as numpy; :func:`render` draws them with
matplotlib, which it imports when called, so importing this module needs no
matplotlib (the card's host has none). Batches and samples are
channels-last (B, *spatial, C); the hooks (``x_to_im``, ``pk_func``,
``cc_func``, ...) receive channels-first per-sample tensors (C, *spatial),
as the JAX module's do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.array import nlast_to_nchw, to_np
from .pdfs import histogram

HIST_BINS = np.linspace(-4, 4, 50)


def _cfirst(a) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return nlast_to_nchw(torch.as_tensor(a))


def panel_data(batch: Dict[str, Any], samples, sfm: bool = False,
               index: int = 0, x_to_im=None, conditioning_to_im=None,
               conditioning_values_to_str=None, pk_func=None,
               cc_func=None) -> dict:
    """The panel's arrays for sample ``index`` of a channels-last batch and
    its samples: ``images`` (name -> 2D array), ``hist`` / ``pk`` / ``cc``
    (lists of (label, x, y): bin edges and counts, k and P(k), k and
    r(k)), and ``text`` (the conditioning values, or None)."""
    x = _cfirst(batch["x1"] if sfm else batch["x"])
    cond = _cfirst(batch["x0"] if sfm else batch.get("conditioning"))
    samples = _cfirst(samples)
    idx = index
    out = {"images": {}, "hist": [], "pk": [], "cc": [], "text": None,
           "hist_bins": HIST_BINS}
    if cond is not None and conditioning_to_im is not None:
        out["images"]["Conditioning"] = to_np(conditioning_to_im(cond[idx]))
    if x_to_im is not None:
        out["images"]["GT Target"] = to_np(x_to_im(x[idx]))
        out["images"]["Sampled Target"] = to_np(x_to_im(samples[idx]))

    groups = [("GT", x), ("Sampled", samples)]
    cond_group = [("Conditioning", cond)] if cond is not None else []
    edges = torch.as_tensor(HIST_BINS, device=x.device)
    rows, labels = [], []
    for c in range(x.shape[1]):
        for name, f in groups:
            rows.append(f[idx, c].reshape(-1))
            labels.append(f"{name} Channel {c}")
    for name, f in cond_group:
        for c in range(f.shape[1]):
            rows.append(f[idx, c].reshape(-1))
            labels.append(f"{name} Channel {c}")
    counts = to_np(histogram(torch.stack(rows), edges))
    out["hist"] = [(lab, HIST_BINS, cnt) for lab, cnt in zip(labels, counts)]

    if pk_func is not None:
        for c in range(x.shape[1]):
            for name, f in groups:
                ks, pks = pk_func(f[idx, c], c)
                out["pk"].append((f"{name} Channel {c}", to_np(ks), to_np(pks)))
        for name, f in cond_group:
            for c in range(f.shape[1]):
                ks, pks = pk_func(f[idx, c], c)
                out["pk"].append((f"{name} Channel {c}", to_np(ks), to_np(pks)))
    if cc_func is not None:
        for c in range(x.shape[1]):
            ks, ccs = cc_func(x[idx, c], samples[idx, c], c)
            out["cc"].append((f"CC GT-Sampled Channel {c}", to_np(ks),
                              to_np(ccs)))
    cv = batch.get("conditioning_values")
    if conditioning_values_to_str is not None and cv is not None:
        cv = cv[0] if isinstance(cv, (list, tuple)) else cv
        out["text"] = conditioning_values_to_str(to_np(cv[idx]))
    return out


def render(panel: dict, fontsize: int = 16):
    """The matplotlib figure of :func:`panel_data`'s arrays."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fs = fontsize
    fig, axes = plt.subplots(2, 3, figsize=(20, 12))
    for ax, (title, im) in zip(
            [axes.flat[0], axes.flat[1], axes.flat[2]],
            [(t, panel["images"].get(t)) for t in
             ("Conditioning", "GT Target", "Sampled Target")]):
        if im is not None:
            ax.imshow(im)
            ax.set_title(title, fontsize=fs)
    for label, edges, counts in panel["hist"]:
        axes.flat[3].stairs(counts, edges, label=label)
    axes.flat[3].legend(fontsize=fs)
    if panel["pk"]:
        ax = axes.flat[4]
        for label, ks, pks in panel["pk"]:
            ax.plot(ks, pks, label=label)
        ax.legend(fontsize=fs)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("k/k_grid", fontsize=fs)
        ax.set_ylabel("Raw Pk", fontsize=fs)
        ax.set_title("Powerspectra", fontsize=fs)
    if panel["cc"]:
        ax = axes.flat[5]
        for label, ks, ccs in panel["cc"]:
            ax.plot(ks, ccs, label=label)
        ax.legend(fontsize=fs)
        ax.set_xscale("log")
        ax.set_xlabel("k", fontsize=fs)
        ax.set_ylabel("CC", fontsize=fs)
        ax.set_title("Cross Correlation", fontsize=fs)
    if panel["text"] is not None:
        axes.flat[0].annotate(panel["text"], xy=(0, 0), xytext=(0.5, 0.5),
                              textcoords="axes fraction", fontsize=fs,
                              ha="center", va="center")
    return fig


def draw_figure(batch: Dict[str, Any], samples, fontsize: int = 16,
                **hooks):
    """VDM flavor: batch keys x / conditioning / conditioning_values."""
    return render(panel_data(batch, samples, **hooks), fontsize)


def draw_figure_sfm(batch: Dict[str, Any], samples, fontsize: int = 16,
                    **hooks):
    """SFM flavor: batch keys x1 (target) / x0 (conditioning)."""
    return render(panel_data(batch, samples, sfm=True, **hooks), fontsize)
