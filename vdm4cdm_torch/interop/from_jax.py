"""JAX params tree -> state_dict of the port's :class:`VDM` or :class:`SFM`,
and the JAX package's optimizer state -> the port's.

The JAX package's VDM params are ``{"unet": <CUNet tree>, "gamma": {"b", "w"}}``
with numpy (or array-like) leaves. The port keeps every parameter's JAX name
and layout: conv kernels (k, k, k, Cin, Cout), dense kernels (in, out), the
attention ``qkv`` kernel (C, 3, heads, hd) with bias (3, heads, hd) and its
``proj`` kernel (heads, hd, C). So the mapping is by name alone:

  * ``unet`` -> ``score_model``, ``gamma`` -> ``schedule``; an SFM tree is
    ``{"unet": ...}`` with no ``gamma`` and keeps ``unet`` (the port's SFM
    holds its velocity net under that name);
  * the unnamed flax submodules ``_GroupNorm_i`` / ``_Conv_i`` lose their
    leading underscore;
  * ``mid_attn`` (the attention block) -> ``mid_attn_block``.

An EMA tree has the params' structure and goes through the same function.

The JAX package's optimizer is ``optax.chain(clip_by_global_norm, adamw)``,
whose state is the nested tuple ``(clip state, (ScaleByAdamState(count, mu,
nu), decay state, schedule state))`` with ``mu`` and ``nu`` shaped like the
params. :func:`opt_state_from_jax` finds the Adam state in it and renames its
trees the same way.

Imports neither jax nor the JAX package: it reads plain nested mappings and
(named) tuples with numpy-convertible leaves.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_TOP_VDM = {"unet": "score_model", "gamma": "schedule"}
_TOP_SFM = {"unet": "unet"}


def _rename(path, tops):
    top = tops.get(path[0])
    if top is None:
        raise KeyError(f"unknown top-level key {path[0]!r}: expected "
                       f"{sorted(tops)}")
    out = [top]
    for i, part in enumerate(path[1:]):
        if i == 0 and path[0] == "unet" and part == "mid_attn":
            part = "mid_attn_block"
        out.append(part.lstrip("_"))
    return ".".join(out)


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def params_from_jax(tree: Mapping[str, Any],
                    model: Optional[torch.nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """Map a JAX VDM or SFM params tree (the latter has no ``gamma``) onto
    the port's state_dict names (f32 CPU tensors). With ``model``, every key and shape is checked against
    ``model.state_dict()``: a parameter the tree lacks, or a tree leaf the
    model has no place for, raises ``KeyError``; a shape mismatch raises
    ``ValueError``."""
    tops = _TOP_VDM if "gamma" in tree else _TOP_SFM
    sd = {}
    for path, leaf in _flatten(tree):
        sd[_rename(path, tops)] = torch.from_numpy(
            np.array(leaf, dtype=np.float32, copy=True))
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(sd))
        unused = sorted(set(sd) - set(want))
        if missing or unused:
            raise KeyError(f"params_from_jax: missing {missing[:8]}, "
                           f"unused {unused[:8]}")
        for k, v in sd.items():
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(want[k].shape)}")
    return sd


def _find_adam_state(node):
    """The first node with ``count``, ``mu`` and ``nu`` in a nest of tuples,
    namedtuples and mappings."""
    if isinstance(node, Mapping):
        if {"count", "mu", "nu"} <= set(node):
            return node["count"], node["mu"], node["nu"]
        children = node.values()
    elif isinstance(node, tuple):
        if {"count", "mu", "nu"} <= set(getattr(node, "_fields", ())):
            return node.count, node.mu, node.nu
        children = node
    else:
        return None
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def opt_state_from_jax(opt_state: Any,
                       model: Optional[torch.nn.Module] = None,
                       moment_dtype: Optional[torch.dtype] = None
                       ) -> Dict[str, Any]:
    """The port's optimizer state ``{"count", "mu", "nu"}`` from the JAX
    package's optax state (CPU tensors; ``mu`` in ``moment_dtype``, default
    f32, ``nu`` in f32). With ``model``, names and shapes are checked as in
    :func:`params_from_jax`."""
    found = _find_adam_state(opt_state)
    if found is None:
        raise KeyError("opt_state_from_jax: no (count, mu, nu) Adam state "
                       "in the given optimizer state")
    count, mu, nu = found
    dtype = moment_dtype or torch.float32
    return {
        "count": int(np.asarray(count)),
        "mu": {k: v.to(dtype) for k, v in params_from_jax(mu, model).items()},
        "nu": params_from_jax(nu, model),
    }
