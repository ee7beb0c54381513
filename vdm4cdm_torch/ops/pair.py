"""A lazy channel concat of two channels-last tensors.

The decoder's skip joins never write the joined tensor: GroupNorm computes
joint group statistics over the two halves, and the convs split their weights
over them (the JAX package's ``PackedPair``, ``vdm4cdm_tpu/ops/packed.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pair(NamedTuple):
    a: torch.Tensor  # (B, *spatial, Ca)
    b: torch.Tensor  # (B, *spatial, Cb)

    @property
    def channels(self) -> int:
        return self.a.shape[-1] + self.b.shape[-1]

    def materialize(self) -> torch.Tensor:
        return torch.cat([self.a, self.b], dim=-1)
