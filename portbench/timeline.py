"""The device timeline of a traced window, read from a ``torch.profiler``
Chrome trace.

The window is the benchmark's own span ``portbench.window``, which opens
after a ``torch.cuda.synchronize()`` and closes after another. Within it:

* device operations are the trace's ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events; ``busy_s`` is the length of their union and the
  idle share is 1 - busy_s / window_s, over the whole window, gaps between
  steps included;
* each kernel is put in one class, by its name or by the host operations
  around its launch (found through the launch's correlation id):
  ``conv`` (the hand conv3d kernels, or any kernel launched inside an aten
  convolution op: cuDNN's, whatever algorithm it picks), ``norm`` (the four
  Triton GroupNorm kernels), ``mm1x1`` (the hand 1x1 kernels),
  ``optimizer`` (the fused ``_foreach_`` kernels of Adam, and of an EMA),
  ``dense`` (a GEMM launched inside an aten matmul op) and ``glue``
  (everything else: copies, pads, casts, elementwise, reductions);
* each idle gap is named by the host operation that was running at its
  middle (the outermost one of its thread; where threads differ, the
  shortest of those), or ``Python`` where none was.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
NORM_KERNELS = {"sums_kernel", "apply_kernel", "bwd_sums_kernel",
                "bwd_apply_kernel"}
CONV_OPS = {"aten::convolution", "aten::_convolution",
            "aten::cudnn_convolution", "aten::convolution_backward",
            "aten::cudnn_convolution_backward", "aten::conv2d",
            "aten::conv3d"}
DENSE_OPS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::matmul",
             "aten::baddbmm", "aten::linear"}
_ENGINE = "autograd::engine::evaluate_function: "


@dataclasses.dataclass
class Timeline:
    window_s: float
    busy_s: float
    # (name, class, seconds, is a kernel) of every device operation in the
    # window (memory copies and sets are glue, and no kernels)
    ops: List[Tuple[str, str, float, bool]]
    # (host operation, seconds) of every idle gap in the window
    gaps: List[Tuple[str, float]]

    def seconds(self, cls: str) -> float:
        return sum(s for _, c, s, _ in self.ops if c == cls)

    def kernels(self) -> int:
        return sum(1 for *_, k in self.ops if k)

    def breakdown(self, top: int = 10) -> dict:
        by_op: Dict[str, float] = collections.defaultdict(float)
        for name, _, s, _ in self.ops:
            by_op[name[:96]] += s
        by_gap: Dict[str, float] = collections.defaultdict(float)
        for name, s in self.gaps:
            by_gap["host_in_" + name[:80]] += s
        return {"device_ops": _top(by_op, top),
                "idle_gaps": _top(by_gap, top)}


def _top(d: Dict[str, float], n: int):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def classify(name: str, launch_ops) -> str:
    if "conv3d_" in name:
        return "conv"
    if name in NORM_KERNELS:
        return "norm"
    if "mm1x1" in name:
        return "mm1x1"
    if "multi_tensor_apply" in name:
        return "optimizer"
    if launch_ops & CONV_OPS:
        return "conv"
    if launch_ops & DENSE_OPS:
        return "dense"
    return "glue"


def _union(intervals: List[Tuple[float, float]]):
    """(total length, merged intervals) of [start, end) intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _launch_stacks(cpu_ops, launches) -> Dict[int, frozenset]:
    """correlation id -> names of the host ops around its launch (same
    thread)."""
    by_tid = collections.defaultdict(list)
    for e in cpu_ops:
        by_tid[e["tid"]].append((e["ts"], 0, e["ts"] + e.get("dur", 0),
                                 e["name"]))
    for e in launches:
        by_tid[e["tid"]].append((e["ts"], 1, e["args"]["correlation"], None))
    out: Dict[int, frozenset] = {}
    for events in by_tid.values():
        # at one start time the outer op (the later end) opens first
        events.sort(key=lambda ev: (ev[0], ev[1], -ev[2] if ev[1] == 0
                                    else 0))
        stack: List[Tuple[float, str]] = []
        for ts, kind, val, name in events:
            while stack and stack[-1][0] < ts:
                stack.pop()
            if kind == 0:
                stack.append((val, name))
            else:
                out[val] = frozenset(n for _, n in stack)
    return out


def _host_names(cpu_ops):
    """Per thread: the sorted outermost host ops (start, end, name)."""
    by_tid = collections.defaultdict(list)
    for e in cpu_ops:
        by_tid[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0),
                                 e["name"]))
    outer = {}
    for tid, ops in by_tid.items():
        ops.sort(key=lambda o: (o[0], -o[1]))
        top: List[Tuple[float, float, str]] = []
        for o in ops:
            if not top or o[0] >= top[-1][1]:
                top.append(o)
        outer[tid] = (top, [o[0] for o in top])
    return outer


def _gap_name(outer, t: float) -> str:
    best = None
    for top, starts in outer.values():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and top[i][1] > t:
            if best is None or top[i][1] - top[i][0] < best[1] - best[0]:
                best = top[i]
    if best is None:
        return "Python"
    name = best[2]
    return name[len(_ENGINE):] if name.startswith(_ENGINE) else name


def read_trace(path: str) -> Timeline:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if len(spans) != 1:
        raise ValueError(f"{path}: {len(spans)} {WINDOW} spans, not one")
    ws = spans[0]["ts"]
    we = ws + spans[0]["dur"]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"
               and e.get("ph") == "X" and e["ts"] < we
               and e["ts"] + e.get("dur", 0) > ws]
    launches = [e for e in events if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})]
    stacks = _launch_stacks(cpu_ops, launches)
    ops, intervals = [], []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a, b = max(e["ts"], ws), min(e["ts"] + e.get("dur", 0), we)
        if b <= a:
            continue
        intervals.append((a, b))
        kernel = e["cat"] == "kernel"
        corr = e.get("args", {}).get("correlation")
        cls = (classify(e["name"], stacks.get(corr, frozenset())) if kernel
               else "glue")
        ops.append((e["name"], cls, (b - a) * 1e-6, kernel))
    busy_us, merged = _union(intervals)
    outer = _host_names([e for e in cpu_ops
                         if not e["name"].startswith("portbench.")])
    gaps, t = [], ws
    for a, b in merged + [[we, we]]:
        if a > t:
            gaps.append((_gap_name(outer, 0.5 * (a + t)), (a - t) * 1e-6))
        t = max(t, b)
    return Timeline((we - ws) * 1e-6, busy_us * 1e-6, ops, gaps)
