"""Step-based training loop: counterpart of ``vdm4cdm_tpu/train/loop.py``.

Replaces the reference's Lightning Trainer stack (max_steps, validation every
N steps, grad clip 0.5, LR monitor, checkpoint every 10k keep-all; reference
train_uc_uc_from_field_name.py:36-47) with a plain loop: the train step of
``step.py``, a background device feed, periodic validation, keep-all
checkpoints and auto-resume.

Determinism: step k's batch is the data module's k-th
(``train_batches(max_steps, start_step)``) and its randomness (t, eps and the
dropout masks) comes from a generator seeded on the host from
(``seed + 1``, k). A run killed and resumed from a checkpoint therefore
replays the uninterrupted run: bit for bit on the CPU; on the card to f32
rounding, since ``conv3d_k3s1_dw`` sums with atomics in run-dependent order.

Nothing is read back from the device except at log steps and the last step
(the metrics), at validation and at checkpoints. The logged ``step_s`` and
``feed_wait_s`` are the wall seconds per step since the previous log step,
and the part of them the loop spent waiting for the feed; validation and
checkpoint time is left out of both. ``ckpt_save_s`` and ``ckpt_bytes`` are
logged at each save.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..parallel.shard import process_rank
from ..utils.rng import seeded_generator
from .checkpoint import CheckpointManager
from .loggers import ConsoleLogger, CSVLogger, Logger, MultiLogger
from .state import TrainState, init_ema, make_optimizer
from .step import make_eval_step, make_train_step


@dataclasses.dataclass
class TrainConfig:
    max_steps: int = 1_000_000
    val_check_interval: int = 5000
    n_val_batches: int = 8
    ckpt_every_steps: int = 10_000
    log_every_steps: int = 50
    learning_rate: float = 3.0e-4
    grad_clip: float = 0.5
    weight_decay: float = 0.0
    warmup_steps: int = 0
    seed: int = 42
    out_dir: str = "./runs/run"
    experiment_name: str = "run"
    resume: bool = True
    ema_decay: float = 0.0  # >0 enables an EMA shadow of params (e.g. 0.9999)


def _map_batch(fn, batch: dict) -> dict:
    """Apply ``fn`` to every array of a batch dict (values are arrays, lists
    of arrays, or None)."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
        elif isinstance(v, (list, tuple)):
            out[k] = [fn(a) for a in v]
        else:
            out[k] = fn(v)
    return out


def _tensors(batch: dict):
    for v in batch.values():
        if isinstance(v, (list, tuple)):
            yield from v
        elif v is not None:
            yield v


class _DeviceFeeder:
    """Moves host (numpy) batches to ``device``. ``prefetch`` runs a host
    iterator in a background thread ``depth`` batches ahead: on the card each
    batch is copied into fresh pinned host memory and sent with
    ``non_blocking=True`` on a copy stream of the thread's own, with an event
    recorded after its copies, so the H2D transfer overlaps the previous
    step. The consumer's stream waits on that event before the batch is
    used. A pinned buffer is not reused before its copy has finished:
    PyTorch's pinned-memory allocator records the copy's stream on it."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.device = torch.device(device)
        self.depth = depth
        self.cuda = self.device.type == "cuda"

    def _to_device(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not self.cuda:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def put(self, batch: dict) -> dict:
        """One batch on the device, ready on the current stream."""
        return _map_batch(self._to_device, batch)

    def prefetch(self, host_iter: Iterator[dict]
                 ) -> Iterator[Tuple[dict, float]]:
        """Yields (device batch, seconds the caller waited for it)."""
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        stream = torch.cuda.Stream(self.device) if self.cuda else None

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in host_iter:
                    if not self.cuda:
                        item = (self.put(batch), None)
                    else:
                        with torch.cuda.device(self.device), \
                                torch.cuda.stream(stream):
                            dev = self.put(batch)
                            ready = torch.cuda.Event()
                            ready.record(stream)
                        item = (dev, ready)
                    if not offer(item):
                        return
                offer(None)
            except BaseException as e:  # surface loader errors to the consumer
                offer(e)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="vdm4cdm-feed")
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                waited = time.perf_counter() - t0
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, ready = item
                if ready is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(ready)
                    for t in _tensors(batch):
                        t.record_stream(current)
                yield batch, waited
        finally:
            stop.set()
            thread.join(timeout=60.0)


class Trainer:
    """Trains ``model`` (a VDM or an SFM, its parameters on its device) in
    place. ``draw_figure(params, batch, generator) -> figure or None`` is an
    optional validation-figure hook, called after each validation with the
    EMA parameters when tracked (else the model's) and the first validation
    batch."""

    def __init__(
        self,
        model,
        config: TrainConfig,
        loggers: Optional[Logger] = None,
        draw_figure: Optional[Callable] = None,
    ):
        self.model = model
        self.config = config
        self.device = model.device
        self.optimizer = make_optimizer(
            config.learning_rate, config.grad_clip, config.weight_decay,
            config.warmup_steps,
        )
        if loggers is not None:
            self.loggers = loggers
        elif process_rank()[0] == 0:
            lgs = [
                CSVLogger(config.out_dir, config.experiment_name),
                ConsoleLogger(every=config.log_every_steps),
            ]
            # remote tracking (the reference's Comet stack) rides along when
            # comet_ml + an API key are configured; local-first otherwise
            from .loggers import CometLogger

            if CometLogger.available():
                lgs.append(CometLogger(
                    project_name=os.environ.get("COMET_PROJECT", "vdm4cdm"),
                    experiment_name=config.experiment_name))
            self.loggers = MultiLogger(*lgs)
        else:  # other ranks stay silent (their metrics are the mesh means)
            self.loggers = MultiLogger()
        self.draw_figure = draw_figure
        self.ckpt = CheckpointManager(
            os.path.join(config.out_dir, config.experiment_name, "checkpoints"),
            every_steps=config.ckpt_every_steps,
        )
        self._feeder = _DeviceFeeder(self.device)

    def init_state(self) -> TrainState:
        """Step 0 with the model's current parameters; the EMA (when
        enabled) is a copy of them."""
        ema = init_ema(self.model) if self.config.ema_decay > 0 else None
        return TrainState(0, self.model, self.optimizer.init(self.model), ema)

    def step_generator(self, step: int) -> torch.Generator:
        """The generator of train step ``step``: seeded on the host from
        (seed + 1, step), the counterpart of JAX's ``fold_in(base, step)``."""
        return seeded_generator(self.device, self.config.seed + 1, step)

    def fit(self, datamodule, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.config
        max_steps = max_steps or cfg.max_steps
        state = self.init_state()
        if cfg.resume:
            restored = self.ckpt.restore(state)
            if restored is not None:
                state = restored
                print(f"[trainer] resumed from step {state.step}", flush=True)

        train_step = make_train_step(self.model, self.optimizer,
                                     ema_decay=cfg.ema_decay)
        eval_step = make_eval_step(self.model)
        start_step = state.step
        t_start = time.perf_counter()
        mark, waited, since = t_start, 0.0, 0  # timing since the last log

        host_iter = datamodule.train_batches(max_steps, start_step=start_step)
        for batch, wait in self._feeder.prefetch(host_iter):
            # state.step is a host int (the step's mirror): no device sync
            state, metrics = train_step(state, batch,
                                        self.step_generator(state.step))
            step = state.step
            waited += wait
            since += 1

            # Only materialize metrics on log steps: reading them every step
            # would force a device sync per step and serialize the pipeline.
            if step % cfg.log_every_steps == 0 or step == max_steps:
                values = torch.stack([v.detach().float().reshape(())
                                      for v in metrics.values()]).tolist()
                scalars = dict(zip(metrics, values))
                now = time.perf_counter()
                scalars["lr"] = float(self.optimizer.lr(step))
                scalars["step_s"] = (now - mark) / since
                scalars["feed_wait_s"] = waited / since
                self.loggers.log_scalars(step, scalars)
                mark, waited, since = now, 0.0, 0

            side_work = False
            if cfg.val_check_interval and step % cfg.val_check_interval == 0:
                self._validate(state, datamodule, eval_step, step)
                side_work = True
            side_work |= self._save(state)
            if side_work:  # keep validation and checkpoints out of step_s
                mark, waited, since = time.perf_counter(), 0.0, 0

        self._save(state, force=True)
        dt = time.perf_counter() - t_start
        n = state.step - start_step
        if n > 0:
            print(f"[trainer] {n} steps in {dt:.1f}s ({n / dt:.3f} it/s)",
                  flush=True)
        return state

    def _save(self, state: TrainState, force: bool = False) -> bool:
        if not self.ckpt.maybe_save(state, force=force):
            return False
        info = self.ckpt.last_save
        self.loggers.log_scalars(state.step, {
            "ckpt_save_s": info["seconds"], "ckpt_bytes": info["bytes"]})
        return True

    def _validate(self, state, datamodule, eval_step, step):
        agg: dict = {}
        first = None
        for i, batch in enumerate(datamodule.val_dataloader()):
            if i >= self.config.n_val_batches:
                break
            dev_batch = self._feeder.put(batch)
            if first is None:
                first = dev_batch
            metrics = eval_step(dev_batch,
                                seeded_generator(self.device, self.config.seed,
                                                 step, i))
            for k, v in metrics.items():
                agg.setdefault(f"val_{k}", []).append(float(v))
        if agg:
            self.loggers.log_scalars(
                step, {k: float(np.mean(v)) for k, v in agg.items()})
        if self.draw_figure is not None and first is not None:
            # sample with the EMA weights when tracked: generation prefers
            # them (checkpoint.load_params prefer_ema)
            params = (state.ema_params if state.ema_params is not None
                      else dict(self.model.named_parameters()))
            fig = self.draw_figure(
                params, first,
                seeded_generator(self.device, self.config.seed, step))
            if fig is not None:
                self.loggers.log_figure(step, "validation", fig)
