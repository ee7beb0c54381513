"""A reference torch checkpoint -> the port's VDM state_dict: counterpart of
``vdm4cdm_tpu/interop/torch_convert.py`` (this package's own copy of its
rules).

The reference's trained models are Lightning state_dicts over mltools' torch
CUNet and LightVDM (reference src/utils.py:434-471). The port keeps the JAX
package's parameter names and layouts (``interop/from_jax.py``), so the
mapping is the JAX converter's, read from the port's own parameters:

  * each port parameter names the torch key it comes from: its module path
    in the JAX tree's names (``mid_attn_block`` is the tree's ``mid_attn``;
    the unnamed ``GroupNorm_i`` / ``Conv_i`` submodules are ``_GroupNorm_i``
    / ``_Conv_i``), each part renamed by ``renames`` (default ``mid_attn`` ->
    ``mid_attn_blk``, the torch twin's attribute), then ``.weight`` for a
    ``kernel`` or a ``scale`` and the leaf's own name otherwise;
  * conv weights (O, I, *k) -> (*k, I, O), 2D or 3D;
  * linear weights (out, in) -> (in, out), reshaped to the parameter's
    shape (the attention's qkv (C, 3, heads, hd) and proj (heads, hd, C));
  * GroupNorm weight -> scale, biases reshaped to the parameter's shape;
  * the learned-linear schedule's ``gamma.{b,w}`` (or ``model.gamma.*``) ->
    ``schedule.{b,w}``, else the model's own values.

Validated against a randomly initialized torch twin of the CUNet
(``tools/torch_cunet.py``) in ``tests/test_torch_port_from_torch.py``. The VDM
only, as the JAX function. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

# the JAX tree's module names -> the torch twin's attribute names
_DEFAULT_RENAMES = {"mid_attn": "mid_attn_blk"}
_UNNAMED = re.compile(r"^(GroupNorm|Conv)_\d+$")


def _tree_path(name: str) -> Tuple[str, ...]:
    """A parameter name of the port's CUNet -> its path in the JAX tree."""
    parts = name.split(".")
    out = []
    for i, part in enumerate(parts):
        if i == 0 and part == "mid_attn_block":
            part = "mid_attn"
        elif i < len(parts) - 1 and _UNNAMED.match(part):
            part = "_" + part
        out.append(part)
    return tuple(out)


def torch_key(name: str, renames: Optional[Mapping[str, str]] = None) -> str:
    """The reference state_dict key of the port's CUNet parameter ``name``
    (relative to the CUNet)."""
    renames = {**_DEFAULT_RENAMES, **(renames or {})}
    path = _tree_path(name)
    mod = ".".join(renames.get(p, p) for p in path[:-1])
    leaf = "weight" if path[-1] in ("kernel", "scale") else path[-1]
    return f"{mod}.{leaf}" if mod else leaf


def _tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))


def _convert(w: torch.Tensor, leaf: str, shape: torch.Size) -> torch.Tensor:
    if leaf == "kernel":
        if w.ndim in (4, 5):  # conv (O, I, *k) -> (*k, I, O)
            w = w.permute(*range(2, w.ndim), 1, 0)
        else:  # linear (out, in) -> (in, out), in the parameter's shape
            w = w.t().reshape(shape)
    elif leaf != "scale":
        w = w.reshape(shape)
    return w.contiguous()


def params_from_torch(
    sd: Mapping[str, Any],
    model: torch.nn.Module,
    renames: Optional[Mapping[str, str]] = None,
    strict: bool = True,
) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Map a flat reference state_dict (torch tensors or arrays, keys relative
    to the CUNet: see :func:`strip_and_rename`) onto the port's :class:`VDM`
    ``model``. Returns (state_dict, report): the converted parameters as f32
    CPU tensors, under the model's names (``score_model.*`` and, for a
    learned schedule, ``schedule.*``), and ``{"missing", "unused",
    "gamma_found"}``. A parameter the state_dict lacks raises ``KeyError``
    when ``strict``, else it is left out of the state_dict and listed as
    missing; a converted shape that is not the parameter's raises
    ``ValueError``."""
    if not (hasattr(model, "score_model") and hasattr(model, "schedule")):
        raise TypeError("params_from_torch converts a VDM (score_model and "
                        "schedule)")
    out: Dict[str, torch.Tensor] = {}
    used, missing = set(), []
    for name, p in model.score_model.named_parameters():
        key = torch_key(name, renames)
        if key not in sd:
            missing.append(key)
            continue
        used.add(key)
        w = _convert(_tensor(sd[key]), name.rsplit(".", 1)[1], p.shape)
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(f"{key}: converted shape {tuple(w.shape)} != "
                             f"{tuple(p.shape)}")
        out[f"score_model.{name}"] = w
    if missing and strict:
        raise KeyError(f"{len(missing)} parameters missing from the "
                       f"state_dict, e.g. {missing[:8]}")
    found = False
    for name, p in model.schedule.named_parameters():
        for key in (f"gamma.{name}", f"model.gamma.{name}"):
            if key in sd:
                out[f"schedule.{name}"] = _tensor(sd[key]).reshape(p.shape)
                found = True
                break
        else:
            out[f"schedule.{name}"] = p.detach().to("cpu", torch.float32)
    return out, {"missing": missing, "unused": sorted(set(sd) - used),
                 "gamma_found": found}


def strip_and_rename(sd: Mapping[str, Any],
                     strip_prefix: Optional[str] = None,
                     regex_renames: Iterable[Tuple[str, str]] = ()
                     ) -> Dict[str, Any]:
    """Pre-process raw checkpoint keys: strip a Lightning prefix (found
    automatically as the text up to the first ``score_model.`` when none is
    given) and apply the regex renames in order."""
    if strip_prefix is None:
        for key in sd:
            i = key.find("score_model.")
            if i >= 0:
                strip_prefix = key[: i + len("score_model.")]
                break
    out = {}
    for k, v in sd.items():
        if strip_prefix and k.startswith(strip_prefix):
            k = k[len(strip_prefix):]
        for pat, rep in regex_renames:
            k = re.sub(pat, rep, k)
        out[k] = v
    return out
