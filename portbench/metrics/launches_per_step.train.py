"""Device kernels launched a train step in the traced window."""


def read(t):
    if t.kind != "train" or not t.steps:
        return None
    return t.timeline.kernels() / t.steps
