"""Synthetic Gaussian-random-field datasets: counterpart of
``vdm4cdm_tpu/data/grf.py`` (this package's own copy; the same seeds give
bit-equal batches).

The end-to-end test/bench substrate (SURVEY.md §4: "end-to-end smoke train on a
synthetic Gaussian-random-field dataset (no CAMELS data needed)"): periodic
boxes with a power-law power spectrum P(k) ~ k^slope, plus a deterministic
nonlinear companion field so conditional models have something real to learn.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


def gaussian_random_field(
    rng: np.random.Generator,
    size: int,
    ndim: int,
    slope: float = -2.0,
    amp: float = 1.0,
) -> np.ndarray:
    """Periodic GRF with P(k) ∝ k^slope, zero mean, ~unit variance, (1, *spatial)."""
    shape = (size,) * ndim
    white = rng.standard_normal(shape).astype(np.float64)
    fw = np.fft.rfftn(white)
    ks = [np.fft.fftfreq(size) * size for _ in range(ndim - 1)] + [
        np.fft.rfftfreq(size) * size
    ]
    kg = np.meshgrid(*ks, indexing="ij")
    k = np.sqrt(sum(x**2 for x in kg))
    k[tuple([0] * ndim)] = 1.0
    fw *= k ** (slope / 2.0)
    fw[tuple([0] * ndim)] = 0.0
    f = np.fft.irfftn(fw, s=shape, axes=tuple(range(ndim)))
    f = f / (f.std() + 1e-12) * amp
    return f[None].astype(np.float32)


@dataclasses.dataclass
class GRFDataModule:
    """Generates batches shaped like the CAMELS datamodules' output
    (channels-last device layout): VDM dicts {"x", "conditioning",
    "conditioning_values"} or SFM dicts {"x0", "x1", "conditioning_values"}.

    The conditioning/x0 field is the GRF; the target x/x1 is a deterministic
    pointwise+smoothing transform of it, so a conditional model can reach
    near-zero conditional entropy — ideal for convergence tests.
    """

    size: int = 32
    ndim: int = 2
    batch_size: int = 4
    n_conditioning_values: int = 6
    mode: str = "vdm"  # "vdm" | "sfm"
    slope: float = -2.0
    seed: int = 0

    def _sample(self, rng: np.random.Generator):
        cond = gaussian_random_field(rng, self.size, self.ndim, self.slope)
        # target: nonlinear function of conditioning + small independent GRF
        extra = gaussian_random_field(rng, self.size, self.ndim, self.slope)
        x = np.tanh(cond) + 0.1 * extra
        x = (x - x.mean()) / (x.std() + 1e-12)
        params = rng.uniform(0.0, 1.0, size=(self.n_conditioning_values,)).astype(
            np.float32
        )
        return cond, x.astype(np.float32), params

    def batches(self, n_batches: Optional[int] = None) -> Iterator[dict]:
        """Yields channels-last numpy batches."""
        rng = np.random.default_rng(self.seed)
        i = 0
        while n_batches is None or i < n_batches:
            conds, xs, ps = [], [], []
            for _ in range(self.batch_size):
                c, x, p = self._sample(rng)
                conds.append(c)
                xs.append(x)
                ps.append(p)
            # (B, C, *sp) -> (B, *sp, C)
            perm = (0,) + tuple(range(2, 2 + self.ndim)) + (1,)
            cond = np.stack(conds).transpose(perm)
            x = np.stack(xs).transpose(perm)
            p = np.stack(ps)
            if self.mode == "vdm":
                yield {
                    "x": x,
                    "conditioning": cond,
                    "conditioning_values": [p] if self.n_conditioning_values else [],
                }
            else:
                yield {
                    "x0": cond,
                    "x1": x,
                    "conditioning_values": [p] if self.n_conditioning_values else [],
                }
            i += 1

    # Trainer-facing API (mirrors CAMELSDataModule)
    def train_batches(self, n_steps: int, start_step: int = 0) -> Iterator[dict]:
        it = self.batches(n_batches=None)
        for _ in range(start_step):
            next(it)
        for _ in range(start_step, n_steps):
            yield next(it)

    def val_dataloader(self) -> Iterator[dict]:
        val = dataclasses.replace(self, seed=self.seed + 777_777)
        return val.batches(n_batches=8)

    def test_dataloader(self) -> Iterator[dict]:
        test = dataclasses.replace(self, seed=self.seed + 555_555)
        return test.batches(n_batches=12)

    # identity normalization (GRF fields are already ~N(0,1)) — keeps the
    # datamodule API surface uniform with CAMELSDataModule
    def norm_func(self, field, i_channel: int):
        return field

    def unnorm_func(self, field, i_channel: int):
        return field
