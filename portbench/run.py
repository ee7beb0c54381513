"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell ``<config>.<traffic>`` is an entry of ``workloads`` in
``BENCHMARK.json``. Its configuration is ``portbench/configs/<config>.json``,
its traffic ``portbench/traffic/<traffic>.json``, the limits of its output
check ``portbench/limits/<cell>.json``, and each per-layer metric
``portbench/metrics/<metric>.py``: all found by name.

A run builds the model and draws its weights and inputs on the card from the
seed, warms up the cell's own shapes, measures for ``--seconds``, then checks
what the timed path produced against the plain reference
(``portbench/reference/``) and prints one JSON line. Its kind,
``portbench/kinds/<kind>.py``, is named by the traffic file. With
``--trace 1`` the first steps of the window run under ``torch.profiler`` and
the line carries the per-layer metrics; otherwise the end-to-end ones. The
set-up's phases go to standard error and to the line's ``setup_phases``. A
run without a CUDA card, or with fewer cards than the cell asks for, prints
no result and exits with 2.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
OUT = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "vdm4cdm_tpu")


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from
    /proc/self/stat; the module's import time where that is missing)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def cache_dirs() -> None:
    """Every compile cache at a fixed path inside the checkout: the port's
    nvcc builds are under build/kernels already; Triton's, the CUDA
    driver's and Python's bytecode go under build/ too. Python's matters:
    where the installation keeps no bytecode and the environment asks for
    none to be written (PYTHONDONTWRITEBYTECODE), every process compiles
    torch's and sympy's sources anew, seconds of set-up that swing with the
    host. Called before torch is imported."""
    build = ROOT / "build"
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TRITON_HOME"] = str(build / "triton")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton" / "cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def find_cell(name: str, bench_path: pathlib.Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files, found by name."""
    bench = load_json(bench_path)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; have {sorted(by_name)}")
    w = by_name[name]
    return Cell(name, w["chips"],
                load_json(HERE / "configs" / f"{w['config']}.json"),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"),
                _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name))


def load_metric(name: str):
    """The reader ``read(traced) -> float | None`` of per-layer metric
    ``name``, from portbench/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    if not out:
        return {"name": None, "power_limit": None}
    name, _, limit = out[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


class Tracer:
    """``torch.profiler`` (host and device) over the first steps of the
    window, inside the benchmark's own span ``portbench.window``; the trace
    is written to ``path``."""

    def __init__(self, path: pathlib.Path):
        import torch

        self.path = path
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.span = torch.profiler.record_function("portbench.window")
        self.active = False

    def begin(self) -> None:
        self.prof.start()

    def open(self) -> None:
        from vdm4cdm_torch.ops.kernels import reset_launch_counts

        reset_launch_counts()
        self.span.__enter__()
        self.active = True

    def close(self) -> None:
        import torch
        from vdm4cdm_torch.ops.kernels import launch_counts

        torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.launches = launch_counts()
        self.prof.stop()
        self.active = False

    def write(self) -> str:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        return str(self.path)


@dataclasses.dataclass
class Traced:
    """What a per-layer metric reads: the traced window's device timeline,
    the units (train steps or sampler steps) it holds, the units and seconds
    of the rest of the measured window, which runs after the profiler has
    stopped, and the work of one unit counted from the shapes
    (``portbench/flops.py``)."""

    kind: str
    timeline: object
    steps: int
    rest_steps: int
    rest_s: float
    model_flops: float     # per unit: a train step counts three forwards
    conv_least_s: float    # per unit
    norm_least_s: float    # per unit
    peak_flops: float


def traced_work(cell: Cell, kind: str, timeline, steps: int,
                rest_steps: int, rest_s: float) -> Traced:
    from . import flops
    from .reference.cunet import Arch

    arch = Arch.from_config(cell.config)
    m = cell.config["config"]["model"]
    dtype, remat = m["compute_dtype"], m["remat"]
    batch = cell.traffic["batch"]
    train = kind == "train"
    return Traced(kind, timeline, steps, rest_steps, rest_s,
                  flops.model_flops(arch, batch) * (3 if train else 1),
                  flops.conv_least_s(arch, batch, dtype, train, remat),
                  flops.norm_least_s(arch, batch, dtype, train, remat),
                  flops.PEAK_FLOPS[dtype])


def launch_check(cell: Cell, kind: str, counted: dict, steps: int) -> dict:
    """The port's own launch counts of its hand-kernel wrappers over the
    traced steps beside those that the shapes predict (``flops.launches``):
    the work counted from the shapes saw every hand-kernel call."""
    from . import flops
    from .reference.cunet import Arch

    per_step = flops.launches(Arch.from_config(cell.config), kind == "train",
                              cell.config["config"]["model"]["remat"])
    expected = {k: v * steps for k, v in per_step.items()}
    counted = {k: counted.get(k, 0) for k in expected}
    return {"counted": counted, "expected": expected,
            "equal": counted == expected}


def jax_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float) -> dict:
    """One run of ``cell`` on ``device``: returns the result line's dict
    (without the device section)."""
    import torch

    from . import harness

    kind = cell.traffic["kind"]
    work = harness.load_kind(cell.config, cell.traffic)(
        cell.config, cell.traffic, seed, device)
    work.setup()
    tracer = (Tracer(OUT / f"trace-{cell.name}.json") if trace else None)
    window = harness.Window(torch.device(device), seconds, tracer,
                            cell.traffic["trace_steps"])
    done = work.run_window(window)
    setup_s = window.t0 - started
    window_s = window.seconds_measured
    phases = harness.phases(started, window.t0)
    peak = (torch.cuda.max_memory_allocated(window.device)
            if window.device.type == "cuda" else 0)
    out = {"attempted": done["steps"], "failed": 0, "peak_bytes": peak}
    rate = done["samples"] / window_s  # samples, or fields a call draws
    values = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30,
              "train_samples_per_s": rate, "sample_fields_per_s": rate}
    if trace:
        from .timeline import read_trace

        timeline = read_trace(tracer.write())
        traced = traced_work(cell, kind, timeline, done["traced_steps"],
                             *window.untraced_rest())
        metrics = {}
        for m in cell.per_layer:
            v = load_metric(m["name"])(traced)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["trace"] = {"busy_s": timeline.busy_s,
                        "window_s": timeline.window_s,
                        "breakdown": timeline.breakdown(),
                        "launches": launch_check(cell, kind, tracer.launches,
                                                 done["traced_steps"]),
                        "traced_steps": done["traced_steps"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    work.free()
    t_ref = time.perf_counter()
    numbers = work.numbers()
    check_peak = (torch.cuda.max_memory_allocated(window.device) / 2 ** 30
                  if window.device.type == "cuda" else 0.0)
    halves = window.halves()
    print(f"portbench: {cell.name} seed {seed}: setup {setup_s:.3f} s, "
          f"window {window_s:.3f} s, {done['steps']} steps (issued at "
          f"{halves[0]:.4f} and {halves[1]:.4f} units/s in its two halves), "
          f"check {time.perf_counter() - t_ref:.3f} s, peak {check_peak:.2f} "
          "GiB with the check", file=sys.stderr)
    print("portbench: setup phases " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    out["setup_phases"] = phases
    # the numbers the cell's limits file names; any other is not compared
    checks = {k: {"value": numbers.get(k, math.nan), "limit": limit}
              for k, limit in cell.limits.items()}
    out["correct"] = all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    cell = find_cell(args.workload)
    t_main = time.perf_counter()

    import torch

    from . import harness

    harness.STAMPS[:0] = [("python", t_main)]
    harness.stamp("torch_import")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.empty(1, device="cuda")  # the CUDA context
    torch.cuda.synchronize()
    harness.stamp("cuda_context")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   started)
    found = jax_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    info = card()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res["peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device, "card": info}
    line["setup_phases"] = res["setup_phases"]
    if args.trace:
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
        line["breakdown"] = res["trace"]["breakdown"]
        line["launches"] = res["trace"]["launches"]
        line["traced_steps"] = res["trace"]["traced_steps"]
    line["checks"] = res["checks"]
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
