"""The JAX package's trained checkpoints as checkpoints of this package.

``write_converted`` writes a step of the port's own format
(``train/checkpoint.py``, ``FORMAT`` "vdm4cdm_torch/1") from numpy trees of
a JAX (orbax) step: a params tree and an EMA tree, either of them None, each
renamed by :func:`params_from_jax`; ``opt_state`` is None (a converted
checkpoint samples and warm-starts; it does not resume a run). Reading the
orbax directory itself needs the JAX package, so the caller hands the trees
in: ``tests/test_torch_port_blessed.py``, run as a script, writes
``blessed/VDM_GRF_c_c_32``'s EMA weights (what generation samples) as the
``ema_params`` of the committed copy, with ``params`` None, which keeps the
file at half the size; ``load_params(prefer_ema=False)`` then refuses it
rather than hand out EMA weights as raw ones. Imports no JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from ..train.checkpoint import FORMAT, write_payload
from .from_jax import params_from_jax


def converted_payload(step: int, params: Optional[Mapping[str, Any]],
                      ema_params: Optional[Mapping[str, Any]] = None,
                      model: Optional[torch.nn.Module] = None) -> dict:
    """The checkpoint payload of the JAX trees (names and shapes checked
    against ``model`` when given); at least one tree is given."""
    if params is None and ema_params is None:
        raise ValueError("no params and no EMA to convert")
    return {
        "format": FORMAT,
        "step": int(step),
        "params": (None if params is None
                   else params_from_jax(params, model)),
        "opt_state": None,
        "ema_params": (None if ema_params is None
                       else params_from_jax(ema_params, model)),
    }


def write_converted(directory: str, step: int,
                    params: Optional[Mapping[str, Any]],
                    ema_params: Optional[Mapping[str, Any]] = None,
                    model: Optional[torch.nn.Module] = None) -> str:
    """Write :func:`converted_payload` as ``<directory>/<step>/checkpoint.pt``;
    returns the path."""
    return write_payload(directory,
                         converted_payload(step, params, ema_params, model))
