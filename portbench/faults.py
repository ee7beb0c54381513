"""Faults planted in the timed path, for the output check's own proof: a run
with one of them must come out not correct (``tests/test_portbench_faults.py``
on the CPU; ``calibrate.py --fault`` reads them on the card at a cell's own
size, where a fault sets a number's upper reading).

Train step: ``state_unchanged`` (the optimizer leaves the parameters as they
are), ``half_batch`` (the loss of half the batch, its mean over the rest),
``answer_altered`` (the loss altered where it is produced). Sampler:
``state_unchanged`` (a step returns its input), ``answer_altered`` (a step's
output scaled by 1.01). The exchange between chips has no fault here: every
cell runs on one chip.
"""

from __future__ import annotations

import contextlib

import torch


def _unchanged_update(self, model, grads, state):
    state["count"] += 1
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))


def _half_batch(loss):
    def half(self, batch, *args, **kwargs):
        n = batch["x"].shape[0] // 2
        cut = {"x": batch["x"][:n],
               "conditioning": (None if batch["conditioning"] is None
                                else batch["conditioning"][:n]),
               "conditioning_values": [v[:n] for v in
                                       batch["conditioning_values"]]}
        return loss(self, cut, *args, **kwargs)
    return half


def _altered_loss(loss):
    def altered(self, *args, **kwargs):
        out = loss(self, *args, **kwargs)
        return out._replace(loss=out.loss * 1.1)
    return altered


def _unchanged_step(step):
    def unchanged(self, zt, *args, **kwargs):
        return zt
    return unchanged


def _altered_step(step):
    def altered(self, zt, *args, **kwargs):
        return step(self, zt, *args, **kwargs) * 1.01
    return altered


def _targets():
    from vdm4cdm_torch.diffusion.vdm import VDM
    from vdm4cdm_torch.train.state import Optimizer

    return {
        ("train", "state_unchanged"): (Optimizer, "update",
                                       lambda _: _unchanged_update),
        ("train", "half_batch"): (VDM, "loss", _half_batch),
        ("train", "answer_altered"): (VDM, "loss", _altered_loss),
        ("sample", "state_unchanged"): (VDM, "sample_zs_given_zt",
                                        _unchanged_step),
        ("sample", "answer_altered"): (VDM, "sample_zs_given_zt",
                                       _altered_step),
    }


def names(kind: str):
    return sorted(f for k, f in _targets() if k == kind)


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """The program with ``fault`` planted for the enclosed block."""
    owner, attr, make = _targets()[(kind, fault)]
    original = getattr(owner, attr)
    setattr(owner, attr, make(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)
