"""The device's idle share of the whole traced window (the benchmark's span
from a synchronize to a synchronize, gaps between steps included): 1 minus
the union of the device operations' intervals over the window."""


def read(t):
    if t.kind != "train" or t.timeline.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.timeline.busy_s / t.timeline.window_s)
