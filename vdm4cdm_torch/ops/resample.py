"""Upsampling for the UNet decoder: counterpart of
``vdm4cdm_tpu/ops/resample.py::upsample_nearest`` (the stride-2 downsample is
a ``Conv`` with ``stride=2``, see ``ops/conv.py``)."""

from __future__ import annotations

import torch


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of a channels-last (B, D, H, W, C) tensor:
    one broadcast and one copy."""
    B, D, H, W, C = x.shape
    v = x[:, :, None, :, None, :, None, :]
    v = v.expand(B, D, factor, H, factor, W, factor, C)
    return v.reshape(B, D * factor, H * factor, W * factor, C).contiguous()
