"""Pluggable experiment logging: counterpart of
``vdm4cdm_tpu/train/loggers.py`` (this package's own copy).

Replaces the reference's Comet ML stack (reference
train_uc_uc_from_field_name.py:30-35: CometLogger + LearningRateMonitor +
validation figures pushed as images) with local-first equivalents: CSV scalars,
PNG figures, and optional TensorBoard — same scalar set (loss terms, lr,
gamma endpoints) and the same 2x3 validation figure (evals/figures.py).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional


class Logger:
    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None: ...
    def log_figure(self, step: int, name: str, fig) -> None: ...
    def close(self) -> None: ...


class CSVLogger(Logger):
    """Scalars CSV + figures as PNG files under ``save_dir``. Rows are
    appended; when a row brings a new column (validation or checkpoint
    scalars after the first train rows) the file is rewritten once under the
    wider header."""

    def __init__(self, save_dir: str, experiment_name: str = "run"):
        self.dir = os.path.join(save_dir, experiment_name)
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(os.path.join(self.dir, "figures"), exist_ok=True)
        self._csv_path = os.path.join(self.dir, "metrics.csv")
        self._fields: Optional[list] = None
        self._t0 = time.time()

    def log_scalars(self, step, scalars):
        row = {"step": step, "wall_time": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in scalars.items()})
        new_fields = list(row.keys())
        write_header = False
        if self._fields is None:
            if os.path.exists(self._csv_path):
                with open(self._csv_path) as f:
                    reader = csv.reader(f)
                    self._fields = next(reader, None)
            if self._fields is None:
                self._fields = new_fields
                write_header = True
        grown = [k for k in new_fields if k not in self._fields]
        if grown and not write_header:
            self._rewrite(self._fields + grown)
        self._fields += grown
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)

    def _rewrite(self, fields):
        """The schema grew (validation or checkpoint columns after the first
        rows): rewrite the file under the wider header, so that every row
        stays under its own column names."""
        with open(self._csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        tmp = self._csv_path + ".tmp"
        with open(tmp, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            w.writeheader()
            w.writerows(rows)
        os.replace(tmp, self._csv_path)

    def log_figure(self, step, name, fig):
        path = os.path.join(self.dir, "figures", f"{name}_{step:08d}.png")
        fig.savefig(path, dpi=80, bbox_inches="tight")

    def close(self):
        pass


class ConsoleLogger(Logger):
    def __init__(self, every: int = 100):
        self.every = every
        self._t_last = time.time()
        self._step_last = None

    def log_scalars(self, step, scalars):
        if step % self.every:
            return
        now = time.time()
        rate = ""
        if (self._step_last is not None and step > self._step_last
                and now > self._t_last):
            sps = (step - self._step_last) / (now - self._t_last)
            rate = f" | {sps:.2f} it/s"
        self._t_last, self._step_last = now, step
        msg = " ".join(f"{k}={float(v):.4g}" for k, v in scalars.items())
        print(f"[step {step}] {msg}{rate}", flush=True)

    def log_figure(self, step, name, fig):
        pass


class CometLogger(Logger):
    """Remote experiment tracking — the 1:1 equivalent of the reference's
    CometLogger stack (reference train_uc_uc_from_field_name.py:30-35:
    project/experiment naming, per-step scalars, validation figures pushed
    as images). Activates only when the ``comet_ml`` package is importable
    and an API key is configured (COMET_API_KEY env or ~/.comet.config);
    :func:`available` lets callers gate cleanly; the local CSV/TensorBoard
    loggers remain the default.
    """

    def __init__(self, project_name: str, experiment_name: str,
                 workspace: Optional[str] = None, comet_module=None):
        import importlib

        comet = comet_module or importlib.import_module("comet_ml")
        self._exp = comet.Experiment(
            project_name=project_name,
            workspace=workspace or os.environ.get("COMET_WORKSPACE"),
        )
        self._exp.set_name(experiment_name)

    @staticmethod
    def available() -> bool:
        try:
            import comet_ml  # noqa: F401
        except ImportError:
            return False
        return bool(os.environ.get("COMET_API_KEY")
                    or os.path.exists(os.path.expanduser("~/.comet.config")))

    def log_scalars(self, step, scalars):
        self._exp.log_metrics({k: float(v) for k, v in scalars.items()},
                              step=step)

    def log_figure(self, step, name, fig):
        self._exp.log_figure(figure_name=f"{name}_{step:08d}", figure=fig,
                             step=step)

    def close(self):
        self._exp.end()


class MultiLogger(Logger):
    def __init__(self, *loggers: Logger):
        self.loggers = loggers

    def log_scalars(self, step, scalars):
        for lg in self.loggers:
            lg.log_scalars(step, scalars)

    def log_figure(self, step, name, fig):
        for lg in self.loggers:
            lg.log_figure(step, name, fig)

    def close(self):
        for lg in self.loggers:
            lg.close()
