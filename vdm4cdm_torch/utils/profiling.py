"""Tracing and profiling helpers: counterpart of
``vdm4cdm_tpu/utils/profiling.py``.

A ``torch.profiler`` trace around a window (written as a Chrome trace), a
rolling step timer, and NaN/Inf checks: ``assert_finite`` over a mapping of
tensors and ``enable_nan_debugging`` through autograd's anomaly mode.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed window (CPU, and CUDA where the card is there)
    and write it as ``<log_dir>/trace.json``, a Chrome trace (open it in
    Perfetto or chrome://tracing)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling wall-clock stats over recent steps (host-side; cheap). The
    first ``tick`` only starts the clock."""

    def __init__(self, window: int = 100):
        self.times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")

    def rate(self, units_per_step: float = 1.0) -> float:
        m = self.mean
        return (units_per_step / m if m and np.isfinite(m) and m > 0
                else float("nan"))


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a nest of mappings, lists and tuples, the paths
    written as JAX's ``keystr`` writes them (``['a']['b']``, ``[0]``)."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_finite(tree, name: str = "tree"):
    """Raise ``AssertionError`` naming every leaf of ``tree`` (a mapping of
    tensors, arrays or numbers, nested mappings and lists) that holds a NaN
    or an Inf. Reads each leaf back from its device."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            finite = bool(torch.isfinite(leaf.detach()).all())
        else:
            finite = bool(np.isfinite(np.asarray(leaf)).all())
        if not finite:
            bad.append(path)
    if bad:  # raised, not asserted: the check holds under ``python -O`` too
        raise AssertionError(f"non-finite values in {name}: {bad}")


def enable_nan_debugging():
    """Turn on autograd's anomaly mode: a backward that makes a NaN raises
    with the traceback of the forward op that led to it."""
    torch.autograd.set_detect_anomaly(True)
