"""Log-PDF histograms: counterpart of ``vdm4cdm_tpu/evals/pdfs.py``.

``histogram`` has numpy's (and ``jnp.histogram``'s) semantics: bins closed
on the left, the last bin closed on both sides, values outside the edges
dropped. It locates each value with ``torch.searchsorted`` against the edge
tensor, never ``torch.histc``, which recomputes the edges from (min, max,
bins) and can put a value lying on an edge into another bin.
"""

from __future__ import annotations

import numpy as np
import torch


def histogram(rows: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Per-row counts of ``rows`` (R, n) in the bins of ``edges`` (E,):
    (R, E - 1), in ``rows``' dtype. Compared in ``edges``' dtype."""
    values = rows.to(edges.dtype)
    n_edges = edges.shape[0]
    idx = torch.searchsorted(edges, values.contiguous(), right=True)
    idx = torch.where(values == edges[-1], n_edges - 1, idx)
    # idx 0 lies below the first edge, idx n_edges above the last
    r = rows.shape[0]
    flat = idx + (n_edges + 1) * torch.arange(
        r, device=rows.device)[:, None]
    counts = torch.bincount(flat.reshape(-1), minlength=r * (n_edges + 1))
    return counts.reshape(r, n_edges + 1)[:, 1:-1].to(rows.dtype)


def log_pdf(fields: torch.Tensor, bins: np.ndarray) -> torch.Tensor:
    """Per-sample histogram of log10(field + 1) against f32 edges, as the
    JAX module computes it: field + 1 in f32, its log10 rounded to f32.
    The log10 is taken in float64, so its f32 value is the correctly
    rounded one on every device (XLA's f32 log10 can be an ulp off it, so a
    value within an ulp of an edge can land one bin over from the JAX
    module's). fields: (B, ...) -> (B, len(bins)-1) f32 counts."""
    plus1 = fields.reshape(fields.shape[0], -1).float() + 1.0
    logf = torch.log10(plus1.double()).float()
    edges = torch.as_tensor(np.asarray(bins, np.float32), device=fields.device)
    return histogram(logf, edges)


BINS_3D = np.linspace(8.5, 15.0, 100)   # reference calc_SS.py:52
BINS_2D = np.linspace(10.5, 15.5, 100)  # reference calc_SS.py:60
