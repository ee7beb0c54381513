"""What every kind of traffic shares: seeds, the port's model built from a
configuration file, weights and inputs drawn on the device from the seed,
the measured window, the set-up's phase stamps, and the lookup of a kind by
name.

A kind is ``portbench/kinds/<kind>.py``, named by a traffic file's ``kind``.
It defines ``FAMILIES``, the model families its reference implements,
``NUMBERS``, the numbers its check can compare (a cell's limits file names
those it does), and ``Work(cfg, traffic, seed, device)``, which builds the model and runs its
set-up (warm-up included, ``setup``), runs the measured window
(``run_window``), frees the program's state (``free``) and then checks what
the timed path produced (``numbers``): the same numbers come from the
reference put in the program's place in a lower precision
(``control_numbers``), which is how their limits were set.
"""

from __future__ import annotations

import importlib
import math
import statistics
import time
from typing import Dict, List

import torch

from .reference import cunet as ref_cunet

_MASK63 = (1 << 63) - 1


def sub_seed(seed: int, index: int) -> int:
    """A 63-bit seed for stream ``index`` of a run's ``seed``
    (splitmix64)."""
    z = (seed + 0x9E3779B97F4A7C15 * (index + 1)) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & _MASK63


WEIGHTS, DATA, STEPS, SAMPLES, PICKS = range(5)

# (phase, perf_counter) at the end of each phase of the set-up
STAMPS: List[tuple] = []


def stamp(phase: str) -> None:
    STAMPS.append((phase, time.perf_counter()))


def phases(started: float, until: float) -> Dict[str, float]:
    """Seconds of each stamped phase from ``started`` (the process's start)
    to ``until`` (the window's start); what follows the last stamp is
    ``rest``."""
    out, t = {}, started
    for name, at in STAMPS:
        if started <= at <= until:
            out[name] = out.get(name, 0.0) + at - t
            t = at
    out["rest"] = until - t
    return out


def load_kind(cfg: dict, traffic: dict):
    """The ``Work`` of the traffic's kind, from portbench/kinds/<kind>.py;
    a model family that its reference does not implement is refused."""
    kind = traffic["kind"]
    module = importlib.import_module(f"portbench.kinds.{kind}")
    family = cfg["config"]["model"]["family"]
    if family not in module.FAMILIES:
        raise ValueError(f"the {kind!r} kind checks {sorted(module.FAMILIES)}"
                         f" models against its reference; {cfg['name']!r} "
                         f"is {family!r}")
    return module.Work


def build(cfg: dict, device: torch.device):
    """The port's model for a configuration file, its parameters allocated
    on ``device`` and not yet set. They are allocated one by one, not by
    ``Module.to_empty``, whose ``empty_like`` of meta tensors imports
    sympy, seconds of the set-up that no step needs."""
    import vdm4cdm_torch as vt

    ec = vt.ExperimentConfig.from_dict(cfg["config"])
    with torch.device("meta"):
        model = vt.build_model(ec, device="meta")
    for module in model.modules():
        for name, p in module._parameters.items():
            if p is not None:
                module._parameters[name] = torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device=device),
                    requires_grad=p.requires_grad)
        if any(b is not None for b in module._buffers.values()):
            raise ValueError("the harness sets parameters only; "
                             f"{type(module).__name__} has buffers")
    pad = model.score_model.conv_padding_mode
    if pad != cfg["padding"]:
        raise ValueError(f"the program pads {pad!r}; the configuration "
                         f"states {cfg['padding']!r}")
    return model


def make_weights(model, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Random parameters, by name, from one normal draw on the device:
    kernels N(0, 1 / fan_in), biases N(0, 0.05^2), norm scales 1 + N(0,
    0.1^2), the noise schedule at the configuration's gamma bounds. Every
    kernel is random, also those the program starts at zero, so that every
    path carries signal. Copied into ``model``."""
    named = list(model.named_parameters())
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device)
    m = cfg["config"]["model"]
    out, off = {}, 0
    with torch.no_grad():
        for name, p in named:
            v = flat[off:off + p.numel()].view(p.shape)
            off += p.numel()
            if name == "schedule.b":
                v = torch.full_like(v, m["gamma_min"])
            elif name == "schedule.w":
                v = torch.full_like(v, m["gamma_max"] - m["gamma_min"])
            elif name.endswith(".kernel"):
                fan_in = (p.shape[0] if name.endswith("qkv.kernel")
                          else p.numel() // p.shape[-1])
                v = v * fan_in ** -0.5
            elif name.endswith(".scale"):
                v = 1.0 + 0.1 * v
            else:
                v = 0.05 * v
            out[name] = v.clone()
            p.copy_(v)
    return out


class Inputs:
    """Fields and conditioning values drawn on the device from one
    generator: x, the conditioning field (where the model takes one) and the
    conditioning values, all float32, channels-last."""

    def __init__(self, arch: ref_cunet.Arch, seed: int, device):
        self.arch = arch
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, DATA))

    def field(self, batch: int, channels: int) -> torch.Tensor:
        shape = (batch,) + (self.arch.size,) * self.arch.ndim + (channels,)
        return torch.randn(shape, generator=self.gen, device=self.device)

    def values(self, batch: int) -> List[torch.Tensor]:
        return [torch.rand((batch, d), generator=self.gen, device=self.device)
                for d in self.arch.v_dims]

    def batch(self, batch: int) -> dict:
        out = {"x": self.field(batch, self.arch.in_channels),
               "conditioning": None,
               "conditioning_values": self.values(batch)}
        if self.arch.s_channels:
            out["conditioning"] = self.field(batch, self.arch.s_channels)
        return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_to(batch: dict, device) -> dict:
    return {"x": batch["x"].to(device),
            "conditioning": (None if batch["conditioning"] is None
                             else batch["conditioning"].to(device)),
            "conditioning_values": [v.to(device)
                                    for v in batch["conditioning_values"]]}


def median(values) -> float:
    return statistics.median(values) if values else 0.0


class Window:
    """The measured window: opened and closed on a device synchronize;
    ``tracer`` (or None) profiles its first ``trace_steps`` units."""

    def __init__(self, device, seconds: float, tracer, trace_steps: int):
        self.device, self.seconds = device, seconds
        self.tracer, self.trace_steps = tracer, trace_steps
        self.t0 = self.t1 = None
        self.done = 0        # units completed when the window closed
        self.traced = 0      # units in the traced part
        self.t_traced = None  # when the profiler had stopped
        self.issued: List[float] = []  # when each unit had been issued

    def open(self) -> None:
        if self.tracer is not None:
            self.tracer.begin()
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t0 = time.perf_counter()
        if self.tracer is not None:
            self.tracer.open()

    @property
    def closed(self) -> bool:
        return self.t1 is not None

    def progress(self, done: int) -> None:
        """``done`` units have been issued; closes the traced part or the
        window where due."""
        if not self.closed and done > len(self.issued):
            self.issued += [time.perf_counter()] * (done - len(self.issued))
        if self.tracer is not None and self.tracer.active and \
                done >= self.trace_steps:
            self.tracer.close()
            self.traced = done
            self.t_traced = time.perf_counter()
        if not self.closed and time.perf_counter() - self.t0 >= self.seconds:
            self.close(done)

    def close(self, done: int) -> None:
        if self.tracer is not None and self.tracer.active:
            self.tracer.close()
            self.traced = done
            self.t_traced = time.perf_counter()
        sync(self.device)
        self.t1 = time.perf_counter()
        self.done = done

    @property
    def seconds_measured(self) -> float:
        return self.t1 - self.t0

    def untraced_rest(self) -> tuple:
        """(units, seconds) of the window after the profiler had stopped: it
        starts on the synchronize that closed the traced part and ends on the
        window's own, so neither the profiler's host cost nor its stopping
        is in it."""
        if self.t_traced is None:
            return 0, 0.0
        return self.done - self.traced, self.t1 - self.t_traced

    def halves(self) -> tuple:
        """Units a second issued in the window's first and second half, by
        the host's clock (the device's queue holds the host to within a unit
        of it): a rate that differs between the halves drifts within a run;
        one that differs only between runs does not."""
        n = len(self.issued)
        if n < 4:
            return (math.nan, math.nan)
        mid = self.issued[n // 2 - 1]
        return ((n // 2) / (mid - self.t0),
                (n - n // 2) / (self.issued[-1] - mid))


