"""The output check fails what it must, at a tiny size on the CPU: a run with
the timed path broken underneath (the harness's look for a card skipped),
and the control, the reference put in the program's place one precision
down. The limits are the cells' own (``portbench/limits/``)."""

import time

import pytest
import torch

from _portbench_cells import tiny_cell
from portbench import faults, harness, run

SEED = 2 ** 31 + 77
CONTROL = {"vdm3d192": "fp8", "vdm2d256": "tf32"}


def _run(cell):
    return run.run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter())


def _f32(cell):
    """The cell in float32: at this size a bf16 train step's own gaps from
    the reference come near the full-size limits, so a fault would not be
    what fails it."""
    cell.config["config"]["model"]["compute_dtype"] = "float32"
    return cell


@pytest.mark.parametrize("fault", faults.names("train"))
@pytest.mark.parametrize("cell", ["vdm3d192.train_b2", "vdm2d256.train_b12"])
def test_a_broken_train_step_is_not_correct(cell, fault):
    with faults.planted("train", fault):
        assert _run(_f32(tiny_cell(cell)))["correct"] is False


@pytest.mark.parametrize("fault", faults.names("sample"))
def test_a_broken_sampler_step_is_not_correct(fault):
    with faults.planted("sample", fault):
        assert _run(tiny_cell("vdm3d192.sample_b2"))["correct"] is False


@pytest.mark.parametrize("name", ["vdm3d192.train_b2", "vdm2d256.train_b12",
                                  "vdm3d192.sample_b2"])
def test_the_sound_program_is_correct(name):
    cell = tiny_cell(name)
    res = _run(_f32(cell) if cell.traffic["kind"] == "train" else cell)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("name", ["vdm3d192.train_b2", "vdm2d256.train_b12",
                                  "vdm3d192.sample_b2"])
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    work = harness.load_kind(cell.config, cell.traffic)(
        cell.config, cell.traffic, SEED, "cpu")
    work.setup()
    window = harness.Window(torch.device("cpu"), 0.5, None, 1)
    work.run_window(window)
    work.free()
    work.numbers()
    numbers = work.control_numbers(CONTROL[cell.config["name"]])
    assert any(numbers[k] > limit for k, limit in cell.limits.items()), \
        numbers


def test_a_run_without_a_card_prints_nothing(capsys, monkeypatch):
    import sys

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the run points Python's bytecode into the checkout: undone after
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)
    monkeypatch.setattr(sys, "dont_write_bytecode", sys.dont_write_bytecode)
    rc = run.main(["--workload", "vdm3d192.train_b2", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


@pytest.mark.card
@pytest.mark.parametrize("name", ["vdm3d192.train_b2", "vdm2d256.train_b12",
                                  "vdm3d192.sample_b2"])
def test_a_short_run_on_the_card_is_correct(name):
    import json
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]

