"""The whole sampler step's share of the card's peak: model FLOPs
(conv, 1x1, dense, attention; a train step three forwards, no recompute) of
the steps of the measured window that run after the profiler has stopped,
over their seconds and the dtype's peak. The profiled start of the window,
and the profiler's stopping, are left out: they run at the tracer's pace,
not the program's."""


def read(t):
    if t.kind != "sample" or not t.rest_steps or t.rest_s <= 0:
        return None
    return 100.0 * t.model_flops * t.rest_steps / t.rest_s / t.peak_flops
