"""Isotropic power spectra and cross-correlations on ``torch.fft``:
counterpart of ``vdm4cdm_tpu/evals/spectra.py``.

Semantics of the JAX module, kept exactly: rfftn -> P = Re(x1 conj(x2)) ->
radial binning by bincount into ``ceil(|k|)`` bins with Hermitian
double-count weights (2, except 1 on the DC plane and, for even sizes, the
Nyquist plane of the last axis) -> drop k = 0 -> cut at
``min(spatial) // 2``. k is in units of the fundamental frequency, power
unnormalized, summed over channels and averaged over the batch.

Everything runs on the fields' device. The k grid and weights are built in
numpy once per spatial shape and kept on each device they are used on (at
256^3 they take about 270 MB). ``pk`` and ``get_ccs`` take one batched
``rfftn`` over the leading dimension and one ``bincount`` over
(sample, bin) pairs where JAX vmaps. On CUDA ``bincount`` adds with atomics
in run-dependent order, so bins agree with the CPU to f32 rounding, not
bitwise.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _kgrid_and_weights(spatial: Tuple[int, ...]
                       ) -> tuple[np.ndarray, np.ndarray, int]:
    """|k| grid of the rfftn output, Hermitian weights, and kmax (numpy,
    the JAX module's function)."""
    *full, last = spatial
    rlast = last // 2 + 1
    axes = [np.fft.fftfreq(n) * n for n in full] + [np.arange(rlast)]
    grids = np.meshgrid(*axes, indexing="ij")
    k = np.sqrt(sum(g**2 for g in grids))
    n = np.full(k.shape, 2, np.float32)
    n[..., 0] = 1
    if last % 2 == 0:
        n[..., -1] = 1
    kmax = min(spatial) // 2
    return k.astype(np.float32), n, kmax


@functools.lru_cache(maxsize=8)
def _bins(spatial: Tuple[int, ...], device: str):
    """(bin index, k * weight, weight, number of bins, kmax) of a spatial
    shape, flattened, on ``device``."""
    kgrid, weights, kmax = _kgrid_and_weights(spatial)
    kbin = np.ceil(kgrid).astype(np.int64).ravel()
    w = weights.ravel()
    length = int(kbin.max()) + 1
    return (torch.from_numpy(kbin).to(device),
            torch.from_numpy(kgrid.ravel() * w).to(device),
            torch.from_numpy(w).to(device), length, kmax)


def _binned(P: torch.Tensor, spatial: Tuple[int, ...]):
    """(k, P(k), N(k)) of per-row power P (rows, *rfft shape): each row
    binned on its own, k = 0 dropped, cut at kmax."""
    kbin, kw, w, length, kmax = _bins(tuple(spatial), str(P.device))
    rows = P.shape[0]
    ksum = torch.bincount(kbin, weights=kw, minlength=length)
    nsum = torch.bincount(kbin, weights=w, minlength=length)
    idx = (torch.arange(rows, device=P.device)[:, None] * length
           + kbin[None]).reshape(-1)
    psum = torch.bincount(idx, weights=(P.reshape(rows, -1) * w).reshape(-1),
                          minlength=rows * length).reshape(rows, length)
    sl = slice(1, 1 + kmax)
    return ksum[sl] / nsum[sl], psum[:, sl] / nsum[sl], nsum[sl]


def _rfftn(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfftn(x.float(), dim=tuple(range(2, x.ndim)))


def _cross(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Re(f1 conj(f2)), summed over the channel axis 1."""
    return (f1.real * f2.real + f1.imag * f2.imag).sum(1)


def power(x: torch.Tensor, x2: Optional[torch.Tensor] = None
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, C, *spatial). Power summed over channels, averaged over batch.
    Returns (k, P, N), each of length kmax."""
    spatial = tuple(x.shape[2:])
    fx = _rfftn(x)
    fx2 = fx if x2 is None else _rfftn(x2)
    P = _cross(fx, fx2).mean(0, keepdim=True)
    k, Pk, n = _binned(P, spatial)
    return k, Pk[0], n


def pk(fields: torch.Tensor, fields2: Optional[torch.Tensor] = None
       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample spectra: fields (B, C, *spatial) -> (B, kmax) each."""
    spatial = tuple(fields.shape[2:])
    f1 = _rfftn(fields)
    f2 = f1 if fields2 is None else _rfftn(fields2)
    k, Pk, n = _binned(_cross(f1, f2), spatial)
    rows = fields.shape[0]
    return k.expand(rows, -1), Pk, n.expand(rows, -1)


def pk_conversion(dim: int = 2, boxsize: float = 25.0):
    """Unit conversion to physical k [h/Mpc] and P(k)."""
    k_conv = 2 * np.pi / boxsize
    p_conv = boxsize**dim
    return k_conv, p_conv


def get_ccs(fields1: torch.Tensor, fields2: torch.Tensor, full: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized cross-correlation r(k) = P12 / sqrt(P1 P2) per sample pair;
    ``full=True``: all pairs, (n1, n2, kmax)."""
    spatial = tuple(fields1.shape[2:])
    f1, f2 = _rfftn(fields1), _rfftn(fields2)
    ks, pks1, _ = _binned(_cross(f1, f1), spatial)
    pks2 = _binned(_cross(f2, f2), spatial)[1]
    n1, n2 = fields1.shape[0], fields2.shape[0]
    ks = ks.expand(n1, -1)
    if full:
        P12 = (f1.real[:, None] * f2.real[None]
               + f1.imag[:, None] * f2.imag[None]).sum(2)
        ccs = _binned(P12.reshape((n1 * n2,) + P12.shape[2:]), spatial)[1]
        ccs = ccs.reshape(n1, n2, -1)
        return ks, ccs / torch.sqrt(pks1[:, None] * pks2[None, :])
    if n1 != n2:
        raise ValueError(f"get_ccs: {n1} fields against {n2}")
    ccs = _binned(_cross(f1, f2), spatial)[1]
    return ks, ccs / torch.sqrt(pks1 * pks2)
