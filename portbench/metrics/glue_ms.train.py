"""Device ms a train step in kernels that are no conv (hand or library), no
GroupNorm or 1x1 kernel, no dense GEMM and no optimizer kernel: copies, pads,
casts, elementwise, reductions."""


def read(t):
    if t.kind != "train" or not t.steps:
        return None
    return t.timeline.seconds("glue") / t.steps * 1e3
