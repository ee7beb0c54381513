"""The readings that a cell's output limits are set from, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 12 --control 3 [--first-seed N] [--fault NAME]

For each of ``--seeds`` seeds it runs the cell's set-up and a short window at
the cell's own sizes (the sampler's window ends once its checked steps have
run), then the check: the program's numbers, every number its kind computes
(a cell's limits file names those it compares). On the first ``--control``
seeds it also reads the control's: the reference put in the program's place
one precision below the configuration's (fp8 for bf16, TF32 for float32 with
TF32 off). With ``--fault`` the program runs with that fault planted
(``faults.py``) and no control is read. One JSON line a seed. The lower end of a limit is the largest
program reading, the upper end the smallest control reading
(``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _loss_gaps(work, side: str):
    """A train cell's loss gap at each step (only the first is compared)."""
    got = getattr(work, side, {}) or {}
    if "losses" not in got:
        return None
    return [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 work.ref["losses"])]


def main(argv=None) -> int:
    from . import run

    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    run.cache_dirs()

    import contextlib

    import torch

    from . import faults, harness

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = run.find_cell(args.workload)
    dtype = cell.config["config"]["model"]["compute_dtype"]
    control = "fp8" if dtype == "bfloat16" else "tf32"
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        work = harness.load_kind(cell.config, cell.traffic)(
            cell.config, cell.traffic, seed, "cuda")
        fault = (faults.planted(cell.traffic["kind"], args.fault)
                 if args.fault else contextlib.nullcontext())
        with fault:
            work.setup()
            work.run_window(harness.Window(torch.device("cuda"), 0.5, None,
                                           1))
        work.free()
        t1 = time.perf_counter()
        line = {"cell": cell.name, "seed": seed, "fault": args.fault,
                "program": work.numbers(),
                "losses": _loss_gaps(work, "readings"),
                "check_s": time.perf_counter() - t1,
                "setup_and_window_s": t1 - t0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        print(json.dumps(line), flush=True)
        if i < args.control and not args.fault:
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            line = {"cell": cell.name, "seed": seed,
                    "control": work.control_numbers(control),
                    "control_precision": control,
                    "losses": _loss_gaps(work, "control"),
                    "control_s": time.perf_counter() - t1,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            print(json.dumps(line), flush=True)
        del work
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
