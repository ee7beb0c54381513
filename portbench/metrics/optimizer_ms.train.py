"""Device ms a train step in the fused ``_foreach_`` kernels of Adam and the
EMA (``vdm4cdm_torch/train/state.py``, ``train/step.py``)."""


def read(t):
    if t.kind != "train" or not t.steps:
        return None
    return t.timeline.seconds("optimizer") / t.steps * 1e3
