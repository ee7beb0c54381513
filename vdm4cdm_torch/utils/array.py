"""Array helpers: counterpart of ``vdm4cdm_tpu/utils/array.py``.

``to_np`` replaces the reference's ``mltools.ml_utils.to_np``; the layout
adapters move between the reference's channels-first storage convention
(N, C, *spatial) and the port's channels-last compute convention
(N, *spatial, C). They take tensors or numpy arrays and return the same kind.
"""

from __future__ import annotations

import numpy as np
import torch


def to_np(x) -> np.ndarray:
    """Tensor (on any device, any dtype numpy has) or array -> host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _permute(x, perm):
    if isinstance(x, torch.Tensor):
        return x.permute(perm)
    return np.transpose(x, perm)


def nchw_to_nlast(x):
    """(N, C, *spatial) -> (N, *spatial, C). Works for 2D and 3D fields."""
    return _permute(x, (0,) + tuple(range(2, x.ndim)) + (1,))


def nlast_to_nchw(x):
    """(N, *spatial, C) -> (N, C, *spatial)."""
    return _permute(x, (0, x.ndim - 1) + tuple(range(1, x.ndim - 1)))


def count_params(model: torch.nn.Module) -> int:
    return sum(int(p.numel()) for p in model.parameters())
