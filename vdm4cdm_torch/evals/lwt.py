"""LWT, the 2D wavelet scattering transform (order 2) and its reduced (RWST)
summary: counterpart of ``vdm4cdm_tpu/evals/lwt.py``.

The same Morlet-like filter bank (built in float64 numpy, used as complex64
on the fields' device) and the same coefficients, in the JAX module's order:

  order 0: mean and mean power of the field                    (2 coeffs)
  order 1: S1[j, t]        = mean(|x * psi_{j,t}|^2)           (NR*NT)
  order 2: S2[j1,t1,j2,t2] = mean(||x * psi_{j1,t1}| * psi_{j2,t2}|^2),
           j2 > j1, row-major in (i1, i2)                      (C(NR,2)*NT^2)

Order 1 is one batched ``ifft2`` over the (B, NR*NT, N, N) stack, order 2
one over the (B, n_pairs, N, N) stack of every (j1 < j2) pair (96 at NR =
NT = 4: 12.6 MB of complex64 a 128^2 field). ``get_rwst`` is numpy.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _morlet_bank_np(N: int, NR: int, NT: int, sqrt: bool = True) -> np.ndarray:
    """Fourier-domain Morlet-like filters, shape (NR*NT, N, N), float64.

    Scale j has center frequency k_j = 0.4*N / 2^j cycles/box and bandwidth
    sigma_j proportional to k_j; orientation t rotates the center by
    t*pi/NT. Filters are zero-mean by construction (no DC response).
    """
    kx = np.fft.fftfreq(N) * N
    ky = np.fft.fftfreq(N) * N
    KX, KY = np.meshgrid(kx, ky, indexing="ij")
    filters = []
    for j in range(NR):
        k0 = 0.4 * N / (2.0**j)
        sigma = k0 / 2.0
        for t in range(NT):
            theta = np.pi * t / NT
            cx, cy = k0 * np.cos(theta), k0 * np.sin(theta)
            g = np.exp(-((KX - cx) ** 2 + (KY - cy) ** 2) / (2 * sigma**2))
            g[0, 0] = 0.0  # kill DC
            # L2 normalize so each scale contributes comparably
            g = g / np.sqrt((g**2).mean() + 1e-30)
            filters.append(np.sqrt(g) if sqrt else g)
    return np.stack(filters)


def make_wavelets(
    N: int = 128,
    NR: int = 4,
    NT: int = 4,
    twopi: bool = False,
    dtype=np.float64,
    return_bases: bool = False,
    verbose: bool = False,
    sqrt: bool = True,
    device=None,
) -> Tuple[tuple, list]:
    """The JAX module's call surface. Returns (wavelet_mms, wavelet_vals):
    the (N, NR, NT) tuple and the filters as f32 tensors on ``device``
    (default the CPU)."""
    bank = _morlet_bank_np(N, NR, NT, sqrt=sqrt).astype(dtype)
    wavelet_mms = (N, NR, NT)
    wavelet_vals = [torch.as_tensor(np.asarray(b, np.float32), device=device)
                    for b in bank]
    if return_bases:
        return wavelet_mms, wavelet_vals, bank
    return wavelet_mms, wavelet_vals


@functools.lru_cache(maxsize=4)
def _pairs(NR: int, NT: int) -> tuple[tuple, tuple]:
    """Filter indices (i1, i2) of the order-2 coefficients, j2 > j1."""
    nf = NR * NT
    pairs = [(i1, i2) for i1 in range(nf) for i2 in range(nf)
             if i2 // NT > i1 // NT]
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


def WST_abs2(fields, wavelet_mms, wavelet_vals, m: int = 2,
             verbose: bool = False) -> torch.Tensor:
    """fields: (B, N, N) or (N, N) -> (B, 2 + NR*NT + n2) (or one row)
    scattering coefficients, f32, on the fields' device."""
    N, NR, NT = wavelet_mms
    x = torch.as_tensor(fields).float()
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    bank = torch.stack(list(wavelet_vals)).to(x.device, torch.complex64)
    fx = torch.fft.fft2(x)
    u1 = torch.fft.ifft2(fx[:, None] * bank[None]).abs()  # (B, nf, N, N)
    s0 = torch.stack([x.mean(dim=(1, 2)), (x**2).mean(dim=(1, 2))], dim=1)
    coeffs = [s0, (u1**2).mean(dim=(2, 3))]
    if m >= 2:
        i1, i2 = (list(i) for i in _pairs(NR, NT))
        fu1 = torch.fft.fft2(u1)
        u2 = torch.fft.ifft2(fu1[:, i1] * bank[i2][None]).abs()
        coeffs.append((u2**2).mean(dim=(2, 3)))
    out = torch.cat(coeffs, dim=1)
    return out[0] if squeeze else out


def get_rwst(wst: np.ndarray, NR: int = 4, NT: int = 4) -> np.ndarray:
    """Reduce by rotation averaging (reference calc_SS.py:48). wst: (B, D) ->
    (B, 2 + NR + C(NR,2)*NT): order-0 passthrough, S1 averaged over
    orientation, S2 averaged over (t1, t2) pairs with fixed Δt = t2 - t1 mod NT."""
    wst = np.asarray(wst)
    squeeze = wst.ndim == 1
    if squeeze:
        wst = wst[None]
    B = wst.shape[0]
    s0 = wst[:, :2]
    nf = NR * NT
    s1 = wst[:, 2 : 2 + nf].reshape(B, NR, NT).mean(axis=2)

    # rebuild the (j1,t1,j2,t2) index list used by WST_abs2
    pair_index = []
    for i1 in range(nf):
        j1, t1 = divmod(i1, NT)
        for i2 in range(nf):
            j2, t2 = divmod(i2, NT)
            if j2 <= j1:
                continue
            pair_index.append((j1, t1, j2, t2))
    s2_flat = wst[:, 2 + nf :]
    assert s2_flat.shape[1] == len(pair_index)

    jpairs = sorted({(j1, j2) for j1, _, j2, _ in pair_index})
    out2 = np.zeros((B, len(jpairs), NT))
    counts = np.zeros((len(jpairs), NT))
    for col, (j1, t1, j2, t2) in enumerate(pair_index):
        jp = jpairs.index((j1, j2))
        dt = (t2 - t1) % NT
        out2[:, jp, dt] += s2_flat[:, col]
        counts[jp, dt] += 1
    out2 = out2 / np.maximum(counts, 1)
    out = np.concatenate([s0, s1, out2.reshape(B, -1)], axis=1)
    return out[0] if squeeze else out
