"""Roofline share of the k3 conv work of a sampler step: the least
time of every conv call (the larger of its FLOPs over the dtype's peak and
its bytes over HBM bandwidth, ``portbench/flops.py``) over the device time
of every kernel that implements a conv, hand or cuDNN's."""


def read(t):
    busy = t.timeline.seconds("conv")
    if t.kind != "sample" or not t.steps or busy <= 0:
        return None
    return 100.0 * t.conv_least_s * t.steps / busy
