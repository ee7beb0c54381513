"""The per-layer readers and the window they read, on the CPU with a stand-in
profiler and timeline: the step's share of the peak reads the part of the
window after the profiler has stopped."""

import time
import types

import pytest
import torch

from portbench import harness, run


class _Profiler:
    active = False

    def begin(self):
        pass

    def open(self):
        self.active = True

    def close(self):
        time.sleep(0.05)  # the profiler's stopping, inside the window
        self.active = False


def _traced(kind, rest_steps, rest_s):
    timeline = types.SimpleNamespace(window_s=2.0, busy_s=1.5,
                                     seconds=lambda cls: 0.5)
    return run.Traced(kind, timeline, 5, rest_steps, rest_s, 1e12, 1e-3,
                      1e-3, 1e14)


@pytest.mark.parametrize("kind", ["train", "sample"])
def test_mfu_reads_the_untraced_rest_of_the_window(kind):
    read = run.load_metric(f"mfu.{kind}")
    assert read(_traced(kind, 10, 5.0)) == pytest.approx(2.0)
    assert read(_traced(kind, 0, 0.0)) is None
    other = "sample" if kind == "train" else "train"
    assert read(_traced(other, 10, 5.0)) is None


@pytest.mark.parametrize("kind", ["train", "sample"])
def test_idle_reads_the_whole_traced_window(kind):
    read = run.load_metric(f"idle_pct.{kind}")
    assert read(_traced(kind, 10, 5.0)) == pytest.approx(25.0)


def test_the_window_times_its_rest_after_the_profiler_stops():
    window = harness.Window(torch.device("cpu"), 0.3, _Profiler(), 2)
    window.open()
    done = 0
    while not window.closed:
        done += 1
        time.sleep(0.01)
        window.progress(done)
    steps, seconds = window.untraced_rest()
    assert window.traced == 2 and steps == window.done - 2 > 0
    assert 0 < seconds < window.seconds_measured - 0.05
    assert window.halves()[0] > 0


def test_a_window_without_a_profiler_has_no_untraced_rest():
    window = harness.Window(torch.device("cpu"), 0.05, None, 2)
    window.open()
    window.close(3)
    assert window.untraced_rest() == (0, 0.0)
