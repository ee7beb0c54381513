"""Byte-roofline share of the four GroupNorm kernels of a train step
(gn_sums, gn_apply, gn_bwd_sums, gn_bwd_apply): their bytes over HBM
bandwidth (``portbench/flops.py``) over their device time."""


def read(t):
    busy = t.timeline.seconds("norm")
    if t.kind != "train" or not t.steps or busy <= 0:
        return None
    return 100.0 * t.norm_least_s * t.steps / busy
