"""Optional TensorBoard logger (scalars and figures): counterpart of
``vdm4cdm_tpu/train/tb_logger.py``, written with
``torch.utils.tensorboard``, which needs the ``tensorboard`` package. It is
imported when the logger is constructed, never with this module; construct
it explicitly and pass it to ``Trainer(loggers=...)``.
"""

from __future__ import annotations

from typing import Dict

from .loggers import Logger


class TensorBoardLogger(Logger):
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir=log_dir)

    def log_scalars(self, step: int, scalars: Dict[str, float]):
        for k, v in scalars.items():
            self._writer.add_scalar(k, float(v), global_step=step)
        self._writer.flush()

    def log_figure(self, step: int, name: str, fig):
        self._writer.add_figure(name, fig, global_step=step, close=False)
        self._writer.flush()

    def close(self):
        self._writer.close()
