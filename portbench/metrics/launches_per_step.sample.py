"""Device kernels launched a sampler step in the traced window."""


def read(t):
    if t.kind != "sample" or not t.steps:
        return None
    return t.timeline.kernels() / t.steps
