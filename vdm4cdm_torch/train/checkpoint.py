"""Keep-all checkpoints and auto-resume: counterpart of
``vdm4cdm_tpu/train/checkpoint.py`` in a format of this package's own.

Layout: ``<directory>/<step>/checkpoint.pt``, one ``torch.save`` file per
step, holding ``{"format", "step", "params", "opt_state", "ema_params"}``:
the parameters by name, the optimizer's ``{"count", "mu", "nu"}`` (each
moment in the dtype it has in training, so a bf16 first moment stays bf16)
and the EMA (None when disabled), all as CPU tensors. Every checkpoint is
kept (the reference's ``save_top_k=-1``). A file is written under a
temporary name in its step directory and moved into place with
``os.replace``, so a step whose file exists is complete.

Errors say what they are: a missing directory or step is a
``FileNotFoundError``; an unreadable file raises the error that reading it
raised; a directory that holds a JAX (orbax) checkpoint raises
:class:`JaxCheckpointError`.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

from .state import TrainState

FORMAT = "vdm4cdm_torch/1"
FILE_NAME = "checkpoint.pt"
# a file orbax writes into every step directory (and that the JAX package's
# checkpoints in this repository carry); found without importing orbax
ORBAX_MARKER = "_CHECKPOINT_METADATA"


class JaxCheckpointError(ValueError):
    """The directory holds a checkpoint of the JAX package (orbax), which
    this package does not read."""


def _check_not_orbax(directory: str, names: List[str]) -> None:
    for name in names:
        if os.path.exists(os.path.join(directory, name, ORBAX_MARKER)):
            raise JaxCheckpointError(
                f"{directory} holds a JAX (orbax) checkpoint (step {name}); "
                f"load it with the JAX package and convert its params with "
                f"vdm4cdm_torch.params_from_jax")
    if os.path.exists(os.path.join(directory, ORBAX_MARKER)):
        raise JaxCheckpointError(
            f"{directory} is a JAX (orbax) checkpoint step directory")


def all_steps(directory: str) -> List[int]:
    """The steps with a complete checkpoint in ``directory``, ascending;
    [] when there is none or the directory does not exist yet."""
    if not os.path.isdir(directory):
        return []
    names = [n for n in os.listdir(directory) if n.isdigit()]
    _check_not_orbax(directory, names)
    return sorted(int(n) for n in names
                  if os.path.isfile(os.path.join(directory, n, FILE_NAME)))


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}


def read_checkpoint(directory: str, step: Optional[int] = None) -> dict:
    """The payload of ``step`` (None = the latest) in ``directory``."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory at {directory}")
    steps = all_steps(directory)
    if step is None:
        step = steps[-1] if steps else None
    if step is None or step not in steps:
        raise FileNotFoundError(
            f"no checkpoint for step={step} in {directory} "
            f"(available steps: {steps})")
    path = os.path.join(directory, str(step), FILE_NAME)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint")
    return payload


class CheckpointManager:
    """Periodic keep-all saves under ``directory`` and restore of the
    latest. ``every_steps`` is the interval of :meth:`maybe_save`."""

    def __init__(self, directory: str, every_steps: int = 10_000):
        self.directory = os.path.abspath(directory)
        self.every_steps = every_steps
        self.last_save = None  # {"step", "bytes", "seconds"} of the last save

    def all_steps(self) -> List[int]:
        return all_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def maybe_save(self, state: TrainState, force: bool = False) -> bool:
        """Save at every ``every_steps``-th step, or now with ``force``;
        never twice for one step."""
        step = int(state.step)
        due = force or (self.every_steps and step % self.every_steps == 0)
        if not due or step in self.all_steps():
            return False
        self.save(state)
        return True

    def save(self, state: TrainState) -> str:
        """Write ``state`` as its step's checkpoint; returns the path."""
        t0 = time.perf_counter()
        step = int(state.step)
        payload = {
            "format": FORMAT,
            "step": step,
            "params": _cpu(dict(state.model.named_parameters())),
            "opt_state": {"count": int(state.opt_state["count"]),
                          "mu": _cpu(state.opt_state["mu"]),
                          "nu": _cpu(state.opt_state["nu"])},
            "ema_params": (None if state.ema_params is None
                           else _cpu(state.ema_params)),
        }
        step_dir = os.path.join(self.directory, str(step))
        os.makedirs(step_dir, exist_ok=True)
        path = os.path.join(step_dir, FILE_NAME)
        fd, tmp = tempfile.mkstemp(prefix=f".{FILE_NAME}.", dir=step_dir)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(payload, f)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
        self.last_save = {"step": step, "bytes": os.path.getsize(path),
                          "seconds": time.perf_counter() - t0}
        return path

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """Load ``step`` (None = the latest) into ``state`` in place: its
        model's parameters, its optimizer state (each tensor keeps the
        template's dtype and device) and its EMA. None when the directory
        holds no checkpoint. A template with an EMA restored from a
        checkpoint without one gets a copy of the restored parameters (what
        a fresh EMA at that step would be)."""
        if step is None and self.latest_step() is None:
            return None
        payload = read_checkpoint(self.directory, step)
        params = dict(state.model.named_parameters())
        _copy_into(params, payload["params"], "params")
        saved_opt = payload["opt_state"]
        _copy_into(state.opt_state["mu"], saved_opt["mu"], "mu")
        _copy_into(state.opt_state["nu"], saved_opt["nu"], "nu")
        state.opt_state["count"] = int(saved_opt["count"])
        if state.ema_params is not None:
            saved_ema = payload.get("ema_params")
            if saved_ema is None:
                saved_ema = {k: p.detach() for k, p in params.items()}
            _copy_into(state.ema_params, saved_ema, "ema_params")
        state.step = int(payload["step"])
        return state


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               what: str) -> None:
    """Copy every tensor of ``src`` into ``dst``'s tensor of the same name
    (same names and shapes, or ValueError)."""
    if set(dst) != set(src):
        missing, unused = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise ValueError(f"checkpoint {what}: missing {missing[:8]}, "
                         f"unused {unused[:8]}")
    with torch.no_grad():
        for k, t in dst.items():
            if tuple(src[k].shape) != tuple(t.shape):
                raise ValueError(f"checkpoint {what}.{k}: shape "
                                 f"{tuple(src[k].shape)} != {tuple(t.shape)}")
            t.copy_(src[k])


def load_params(directory: str, model: Optional[torch.nn.Module] = None,
                step: Optional[int] = None,
                prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The parameters of ``step`` (None = the latest) in ``directory``, by
    name, as CPU tensors: the EMA when the checkpoint has one and
    ``prefer_ema`` is set (generation samples from it). With ``model`` they
    are also copied into it (same names and shapes, or ValueError)."""
    payload = read_checkpoint(directory, step)
    params = payload["params"]
    if prefer_ema and payload.get("ema_params") is not None:
        params = payload["ema_params"]
    if model is not None:
        _copy_into(dict(model.named_parameters()), params, "params")
    return params
