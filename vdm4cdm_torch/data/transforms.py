"""Invertible per-channel preprocessing + group-symmetry augmentation.

Capability parity with the reference's src/dataset/augmentation.py:
  * LogTransform (log10(x + alpha), reference :8-21) and Normalize
    ((log - mean)/std, :23-41) — combined here into FieldNormalizer with an
    exact inverse (the reference relies on norm∘unnorm == id at
    CAMELS_3D_dataset.py:146-156; we test it);
  * Flip — random per-axis mirror (:43-59);
  * Permutate — random axis permutation (:62-77); together with flips this is
    the full (hyper)octahedral symmetry group of the periodic box;
  * Crop — periodic-wraparound tiling cropper with random anchor shift
    (:80-127): anchors on a crop-size grid, shifted by U[0, crop) per axis when
    augmenting, indices taken mod fullsize.

Counterpart of ``vdm4cdm_tpu/data/transforms.py`` (this package's own copy).
Host-side augmentation is pure numpy (runs in the loader's prefetch threads);
FieldNormalizer also takes torch tensors, so normalization can run on the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FieldNormalizer:
    """y = (log10(x + alpha) - mean) / std, per channel; exact inverse."""

    alphas: Sequence[float]
    means: Sequence[float]
    stds: Sequence[float]

    def normalize(self, x, i_channel: int):
        xp = _xp(x)
        return (
            xp.log10(x + self.alphas[i_channel]) - self.means[i_channel]
        ) / self.stds[i_channel]

    def unnormalize(self, y, i_channel: int):
        return (
            10.0 ** (y * self.stds[i_channel] + self.means[i_channel])
            - self.alphas[i_channel]
        )

    def normalize_stack(self, fields):
        """fields: list of per-channel arrays -> list, normalized."""
        return [self.normalize(f, i) for i, f in enumerate(fields)]


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def crop_anchors(fullsize: int, crop: int, ndim: int) -> np.ndarray:
    """Tiling anchors on a crop-size grid: (ncrops, ndim). Mirrors the
    reference's np.mgrid anchor construction (augmentation.py:97-106)."""
    per_axis = np.arange(0, fullsize, crop)
    grids = np.meshgrid(*([per_axis] * ndim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def periodic_crop(
    field: np.ndarray,
    anchor: Sequence[int],
    crop: int,
    rng: np.random.Generator | None = None,
    aug_shift: bool = False,
) -> np.ndarray:
    """Crop ``crop`` voxels per spatial axis starting at ``anchor``, wrapping
    periodically (reference augmentation.py:108-127). field: (C, *spatial).

    aug_shift adds U[0, crop) to each anchor coordinate (train-time jitter so
    the crop tiling doesn't imprint)."""
    ndim = field.ndim - 1
    anchor = np.asarray(anchor, dtype=np.int64).copy()
    if aug_shift:
        assert rng is not None
        anchor += rng.integers(0, crop, size=ndim)
    out = field
    for d in range(ndim):
        idx = (anchor[d] + np.arange(crop)) % field.shape[1 + d]
        out = np.take(out, idx, axis=1 + d)
    return out


def flip_and_permute(
    fields: Sequence[np.ndarray], rng: np.random.Generator
) -> list[np.ndarray]:
    """Random mirror per axis + random axis permutation, applied identically to
    every field in the sample (reference Flip/Permutate semantics: one random
    draw shared across channels). fields: list of (C, *spatial)."""
    ndim = fields[0].ndim - 1
    flip_axes = tuple(1 + d for d in range(ndim) if rng.integers(2))
    perm = rng.permutation(ndim)
    axes = (0,) + tuple(1 + perm)
    out = []
    for f in fields:
        if flip_axes:
            f = np.flip(f, axis=flip_axes)
        f = np.transpose(f, axes)
        out.append(np.ascontiguousarray(f))
    return out
