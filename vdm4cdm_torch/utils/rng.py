"""Host-side random streams: counterpart of ``vdm4cdm_tpu/utils/rng.py``.

JAX threads explicit keys (``split``, ``fold_in``). Here a key is a 64-bit
host integer: :func:`seeded_generator` folds indices into it with
:func:`~vdm4cdm_torch.ops.kernels.philox.mix_seed` and seeds a
``torch.Generator`` on a device with the result, and :class:`RngStream` hands
out such generators in sequence. Nothing is read back from the device.
"""

from __future__ import annotations

import torch

from ..ops.kernels.philox import mix_seed


def seeded_generator(device, seed: int, *indices: int) -> torch.Generator:
    """A generator on ``device`` seeded on the host from ``seed`` mixed with
    ``indices`` (JAX's ``fold_in``): nothing is read back from the device."""
    for i in indices:
        seed = mix_seed(seed, i)
    return torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))


class RngStream:
    """Sequential generators for host-side call sites (evaluation, sampling
    campaigns): the n-th ``next()`` is seeded from (seed, n)."""

    def __init__(self, seed: int, device="cpu"):
        self.seed = int(seed)
        self.device = device
        self._count = 0

    def next(self, device=None) -> torch.Generator:
        gen = seeded_generator(device or self.device, self.seed, self._count)
        self._count += 1
        return gen
