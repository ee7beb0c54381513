"""Noise schedules gamma(t) for variance-preserving diffusion: counterpart of
``vdm4cdm_tpu/diffusion/schedule.py``.

    sigma^2(t) = sigmoid(gamma(t)),   alpha^2(t) = sigmoid(-gamma(t))

The learned-linear schedule gamma(t) = b + |w| t starts at b = gamma_min,
w = gamma_max - gamma_min and is monotone by construction.
"""

from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device


class NoiseSchedule(nn.Module):
    """``kind`` "learned_linear" (parameters ``b``, ``w``) or
    "fixed_linear" (no parameters)."""

    def __init__(self, kind: str, gamma_min: float, gamma_max: float,
                 device=None):
        super().__init__()
        if kind not in ("learned_linear", "fixed_linear"):
            raise ValueError(f"unknown schedule kind {kind!r}")
        self.kind = kind
        self.gamma_min = float(gamma_min)
        self.gamma_max = float(gamma_max)
        if kind == "learned_linear":
            dev = resolve_device(device)
            self.b = nn.Parameter(torch.tensor(self.gamma_min, device=dev))
            self.w = nn.Parameter(
                torch.tensor(self.gamma_max - self.gamma_min, device=dev))

    def gamma(self, t) -> torch.Tensor:
        if self.kind == "learned_linear":
            t = torch.as_tensor(t, dtype=torch.float32, device=self.b.device)
            return self.b + torch.abs(self.w) * t
        t = torch.as_tensor(t, dtype=torch.float32)
        return self.gamma_min + (self.gamma_max - self.gamma_min) * t

    def gamma_prime(self, t) -> torch.Tensor:
        """d gamma / d t."""
        if self.kind == "learned_linear":
            t = torch.as_tensor(t, dtype=torch.float32, device=self.b.device)
            return torch.abs(self.w) * torch.ones_like(t)
        t = torch.as_tensor(t, dtype=torch.float32)
        return (self.gamma_max - self.gamma_min) * torch.ones_like(t)


def make_schedule(kind: str, gamma_min: float = -13.3,
                  gamma_max: float = 13.3, device=None) -> NoiseSchedule:
    return NoiseSchedule(kind, gamma_min, gamma_max, device=device)


def alpha_sigma(gamma: torch.Tensor):
    """alpha(t), sigma(t) from gamma(t), variance preserving."""
    return torch.sqrt(torch.sigmoid(-gamma)), torch.sqrt(torch.sigmoid(gamma))
