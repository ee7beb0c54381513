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

Sharded (the model's UNet holds a ``ctx`` over more than one rank of a
``torch.distributed`` job, one process a rank), each rank feeds the slab of
the global batch that its ``ctx`` selects (``local_slab``: its data index's
rows, its ``sp`` index's planes; a data module that serves its process's
rows already, CAMELS under ``data_process``, gives the planes only), and
only the slab goes to the device. Rank 0 alone logs and writes checkpoints;
at each checkpoint the ranks' parameter digests are compared first (a
mismatch raises) and every rank waits on a barrier after the write; a
resume restores, on every rank, the step that rank 0 finds.

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

from ..parallel.halo import NO_SHARD, ShardCtx
from ..parallel.shard import gather_rows, local_slab, process_rank
from ..utils.rng import seeded_generator
from .checkpoint import CheckpointManager, params_digest
from .loggers import ConsoleLogger, CSVLogger, Logger, MultiLogger
from .state import TrainState, init_ema, make_optimizer
from .step import make_eval_step, make_train_step, model_ctx


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
    """Moves host (numpy) batches to ``device``: under a sharded ``ctx``
    this rank's slab of each array alone (``rows_local``: the host batch
    holds this data rank's rows already, so only the planes are taken).
    ``prefetch`` runs a host iterator in a background thread ``depth``
    batches ahead: on the card each batch is copied into fresh pinned host
    memory and sent with ``non_blocking=True`` on a copy stream of the
    thread's own, with an event recorded after its copies, so the H2D
    transfer overlaps the previous step. The consumer's stream waits on that
    event before the batch is used. A pinned buffer is not reused before its
    copy has finished: PyTorch's pinned-memory allocator records the copy's
    stream on it."""

    def __init__(self, device: torch.device, depth: int = 2,
                 ctx: ShardCtx = NO_SHARD):
        self.device = torch.device(device)
        self.depth = depth
        self.cuda = self.device.type == "cuda"
        self.ctx = ctx

    def _to_device(self, a, slab: bool = False,
                   rows_local: bool = False) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if slab and self.ctx.world_size > 1:
            t = local_slab(t, self.ctx, rows=not rows_local)
        if not self.cuda:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def put(self, batch: dict, rows_local: bool = False) -> dict:
        """This rank's batch on the device, ready on the current stream."""
        return _map_batch(
            lambda a: self._to_device(a, True, rows_local), batch)

    def put_global(self, batch: dict, rows_local: bool = False) -> dict:
        """The global batch on the device on every rank: the host batch
        whole, its rows gathered over the data ranks where each holds its
        own (the sharded samplers take the global conditioning)."""
        dev = _map_batch(self._to_device, batch)
        if not (rows_local and self.ctx.data_size > 1):
            return dev
        return _map_batch(lambda t: gather_rows(t, self.ctx), dev)

    def prefetch(self, host_iter: Iterator[dict], rows_local: bool = False
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
                        item = (self.put(batch, rows_local), None)
                    else:
                        with torch.cuda.device(self.device), \
                                torch.cuda.stream(stream):
                            dev = self.put(batch, rows_local)
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
    """Trains ``model`` (a VDM or an SFM, its parameters on its device, its
    UNet holding this rank's ``ctx`` in a sharded run) in place.
    ``draw_figure(params, batch, generator) -> figure or None`` is an
    optional validation-figure hook, called after each validation with the
    EMA parameters when tracked (else the model's) and the first validation
    batch (the global batch, on every rank, in a sharded run)."""

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
        self.ctx = model_ctx(model)
        self.rank = process_rank()[0]
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
        self._feeder = _DeviceFeeder(self.device, ctx=self.ctx)

    def init_state(self) -> TrainState:
        """Step 0 with the model's current parameters; the EMA (when
        enabled) is a copy of them."""
        ema = init_ema(self.model) if self.config.ema_decay > 0 else None
        return TrainState(0, self.model, self.optimizer.init(self.model), ema)

    def step_generator(self, step: int) -> torch.Generator:
        """The generator of train step ``step``: seeded on the host from
        (seed + 1, step), the counterpart of JAX's ``fold_in(base, step)``."""
        return seeded_generator(self.device, self.config.seed + 1, step)

    @property
    def sharded(self) -> bool:
        return self.ctx.world_size > 1

    def _from_rank0(self, value):
        """``value`` as rank 0 has it, on every rank (a sharded run's ranks
        act on one decision: a step to resume, whether to save)."""
        if not self.sharded:
            return value
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def fit(self, datamodule, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.config
        max_steps = max_steps or cfg.max_steps
        rows_local = getattr(datamodule, "process_count", 1) > 1
        state = self.init_state()
        if cfg.resume:
            step = self._from_rank0(self.ckpt.latest_step()
                                    if self.rank == 0 else None)
            if step is not None:
                state = self.ckpt.restore(state, step)
                if self.rank == 0:
                    print(f"[trainer] resumed from step {state.step}",
                          flush=True)

        train_step = make_train_step(self.model, self.optimizer,
                                     ema_decay=cfg.ema_decay)
        eval_step = make_eval_step(self.model)
        start_step = state.step
        t_start = time.perf_counter()
        mark, waited, since = t_start, 0.0, 0  # timing since the last log

        host_iter = datamodule.train_batches(max_steps, start_step=start_step)
        for batch, wait in self._feeder.prefetch(host_iter, rows_local):
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
                self._validate(state, datamodule, eval_step, step,
                               rows_local)
                side_work = True
            side_work |= self._save(state)
            if side_work:  # keep validation and checkpoints out of step_s
                mark, waited, since = time.perf_counter(), 0.0, 0

        self._save(state, force=True)
        dt = time.perf_counter() - t_start
        n = state.step - start_step
        if n > 0 and self.rank == 0:
            print(f"[trainer] {n} steps in {dt:.1f}s ({n / dt:.3f} it/s)",
                  flush=True)
        return state

    def _save(self, state: TrainState, force: bool = False) -> bool:
        if not self.sharded:
            if not self.ckpt.maybe_save(state, force=force):
                return False
        else:
            import torch.distributed as dist

            if not self.ckpt.due(state.step, force):
                return False
            if not self._from_rank0(self.rank == 0 and state.step not in
                                    self.ckpt.all_steps()):
                return False
            digests = [None] * dist.get_world_size()
            dist.all_gather_object(digests, params_digest(state))
            if len(set(digests)) > 1:
                raise RuntimeError(
                    f"the ranks' parameters differ at step {state.step}: "
                    f"digests {digests}")
            if self.rank == 0:
                print(f"[trainer] step {state.step}: the {len(digests)} "
                      f"ranks' parameters are equal (sha256 {digests[0]})",
                      flush=True)
                self.ckpt.save(state)
            dist.barrier()
            if self.rank != 0:
                return True
        info = self.ckpt.last_save
        self.loggers.log_scalars(state.step, {
            "ckpt_save_s": info["seconds"], "ckpt_bytes": info["bytes"]})
        return True

    def _validate(self, state, datamodule, eval_step, step,
                  rows_local=False):
        agg: dict = {}
        first = None
        for i, batch in enumerate(datamodule.val_dataloader()):
            if i >= self.config.n_val_batches:
                break
            dev_batch = self._feeder.put(batch, rows_local)
            if first is None:
                first = (self._feeder.put_global(batch, rows_local)
                         if self.sharded and self.draw_figure is not None
                         else dev_batch)
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
