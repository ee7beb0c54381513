"""The port's training loop (``vdm4cdm_torch/train/loop.py``) on the CPU at a
small size (8^3, chs (4, 8), dropout 0.1, EMA on, GRF data).

``Trainer.fit`` over N steps equals N direct ``make_train_step`` calls fed
the data module's batches and the generators seeded from (seed + 1, step),
bit for bit; a run fitted to k steps and resumed to N equals the run fitted
to N without a stop, bit for bit (parameters, both Adam moments, the count
and the EMA). Also: the feed thread surfaces loader errors and stops when
the loop does; the metrics CSV carries the step timings, the validation
means and the checkpoint saves; the loggers."""

import csv
import sys
import threading

import numpy as np
import pytest
import torch

import vdm4cdm_torch as vt
from vdm4cdm_torch.train.loggers import Logger, MultiLogger
from vdm4cdm_torch.train.loop import _DeviceFeeder
from vdm4cdm_torch.utils.rng import seeded_generator

SEED = 3
SMALL = {"data.kind": "grf", "data.cropsize": 8, "data.batch_size": 2,
         "model.chs": (4, 8), "model.norm_groups": 2,
         "model.compute_dtype": "float32", "model.remat": False,
         "run.seed": SEED}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work is tiny; one thread keeps it off the cores
    that the other test workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(name, out_dir, **over):
    return vt.preset(name, **{**SMALL, "run.out_dir": str(out_dir), **over})


def _model(cfg, init_seed=0):
    return vt.build_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(init_seed))


def _trainer(cfg, model, loggers=None, **over):
    r = cfg.run
    tc = vt.TrainConfig(
        max_steps=r.max_steps, val_check_interval=r.val_check_interval,
        n_val_batches=1, ckpt_every_steps=r.ckpt_every_steps,
        log_every_steps=r.log_every_steps, learning_rate=1e-3, seed=r.seed,
        out_dir=r.out_dir, experiment_name=r.experiment_name,
        ema_decay=0.9, **over)
    return vt.Trainer(model, tc, loggers=loggers)


def _flat(state):
    out = {f"p.{k}": p.detach() for k, p in state.model.named_parameters()}
    for part in ("mu", "nu"):
        out.update({f"{part}.{k}": t for k, t in state.opt_state[part].items()})
    out.update({f"ema.{k}": t for k, t in state.ema_params.items()})
    return out


def _assert_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]


class _Recorder(Logger):
    def __init__(self):
        self.rows, self.figures = [], []

    def log_scalars(self, step, scalars):
        self.rows.append((step, dict(scalars)))

    def log_figure(self, step, name, fig):
        self.figures.append((step, name, fig))


@pytest.mark.parametrize("name", ["trainSFM3D128_c_c", "trainVDM3D128_c_c"])
def test_fit_equals_direct_train_steps(tmp_path, name):
    n = 3
    cfg = _cfg(name, tmp_path, **{"run.max_steps": n,
                                  "run.val_check_interval": 0,
                                  "run.ckpt_every_steps": 100,
                                  "run.log_every_steps": 2})
    rec = _Recorder()
    trainer = _trainer(cfg, _model(cfg), loggers=rec)
    fitted = trainer.fit(vt.build_datamodule(cfg))
    assert fitted.step == n and trainer.ckpt.all_steps() == [n]

    model = _model(cfg)
    opt = vt.make_optimizer(learning_rate=1e-3)
    state = vt.TrainState(0, model, opt.init(model), vt.init_ema(model))
    step = vt.make_train_step(model, opt, ema_decay=0.9)
    for k, batch in enumerate(vt.build_datamodule(cfg).train_batches(n)):
        batch = {key: (None if v is None else
                       [torch.from_numpy(a) for a in v]
                       if isinstance(v, list) else torch.from_numpy(v))
                 for key, v in batch.items()}
        state, metrics = step(state, batch, seeded_generator("cpu", SEED + 1, k))
    _assert_bit_equal(fitted, state)
    # steps 2 and 3 (the last), then the save
    assert [step for step, _ in rec.rows] == [2, 3, 3]
    assert rec.rows[1][1]["loss"] == float(metrics["loss"])
    assert {"lr", "step_s", "feed_wait_s"} <= set(rec.rows[0][1])
    assert rec.rows[-1][1].keys() == {"ckpt_save_s", "ckpt_bytes"}


def test_resume_replays_the_uninterrupted_run(tmp_path, capsys):
    over = {"run.val_check_interval": 2, "run.ckpt_every_steps": 2,
            "run.log_every_steps": 1}
    whole_cfg = _cfg("trainSFM3D128_c_c", tmp_path / "whole",
                     **{"run.max_steps": 5, **over})
    whole = _trainer(whole_cfg, _model(whole_cfg)).fit(
        vt.build_datamodule(whole_cfg))

    cfg = _cfg("trainSFM3D128_c_c", tmp_path / "split",
               **{"run.max_steps": 3, **over})
    first = _trainer(cfg, _model(cfg)).fit(vt.build_datamodule(cfg))
    assert first.step == 3
    cfg.run.max_steps = 5
    # another initialization: everything must come from the checkpoint
    resumed = _trainer(cfg, _model(cfg, init_seed=1)).fit(
        vt.build_datamodule(cfg))
    assert "[trainer] resumed from step 3" in capsys.readouterr().out
    _assert_bit_equal(resumed, whole)

    # the resumed run's CSV continues the first one's, validation and
    # checkpoint rows under their own columns
    with open(tmp_path / "split" / "trainSFM3D128_c_c" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    train_steps = [int(r["step"]) for r in rows if r["loss"]]
    assert train_steps == [1, 2, 3, 4, 5]
    assert [int(r["step"]) for r in rows if r["val_loss"]] == [2, 4]
    assert [int(r["step"]) for r in rows if r["ckpt_bytes"]] == [2, 3, 4, 5]
    assert all(float(r["step_s"]) > 0 and float(r["feed_wait_s"]) >= 0
               for r in rows if r["loss"])
    with open(tmp_path / "whole" / "trainSFM3D128_c_c" / "metrics.csv") as f:
        whole_rows = list(csv.DictReader(f))
    val = {r["step"]: r["val_loss"] for r in rows if r["val_loss"]}
    assert val == {r["step"]: r["val_loss"] for r in whole_rows
                   if r["val_loss"]}


def test_figure_hook_gets_the_ema_and_a_validation_batch(tmp_path):
    cfg = _cfg("trainSFM3D128_c_c", tmp_path,
               **{"run.max_steps": 2, "run.val_check_interval": 2,
                  "run.ckpt_every_steps": 100})
    seen = []

    def draw(params, batch, generator):
        seen.append((params, batch, generator))
        return "figure"

    rec = _Recorder()
    trainer = _trainer(cfg, _model(cfg), loggers=rec)
    trainer.draw_figure = draw
    state = trainer.fit(vt.build_datamodule(cfg))
    assert rec.figures == [(2, "validation", "figure")]
    params, batch, gen = seen[0]
    assert params is state.ema_params
    assert batch["x0"].shape == (2, 8, 8, 8, 1)
    assert isinstance(gen, torch.Generator)


def test_feeder_surfaces_errors_and_stops_with_the_loop():
    feeder = _DeviceFeeder(torch.device("cpu"))

    def failing():
        yield {"x": np.zeros((1, 2), np.float32), "c": None,
               "v": [np.ones((1, 3), np.float32)]}
        raise OSError("disk gone")

    it = feeder.prefetch(failing())
    batch, waited = next(it)
    assert isinstance(batch["x"], torch.Tensor) and batch["c"] is None
    assert torch.equal(batch["v"][0], torch.ones(1, 3)) and waited >= 0
    with pytest.raises(OSError, match="disk gone"):
        next(it)

    def endless():
        while True:
            yield {"x": np.zeros((1, 2), np.float32)}

    before = threading.active_count()
    it = feeder.prefetch(endless())
    next(it)
    it.close()  # the loop stopped early: the producer must not linger
    assert threading.active_count() == before


def test_loggers_fan_out_and_tensorboard(tmp_path, monkeypatch):
    a, b = _Recorder(), _Recorder()
    multi = MultiLogger(a, b)
    multi.log_scalars(1, {"loss": 0.5})
    multi.log_figure(1, "f", None)
    assert a.rows == b.rows == [(1, {"loss": 0.5})] and len(b.figures) == 1
    pytest.importorskip("tensorboard")
    # as on the card, without tensorflow (torch.utils.tensorboard imports it
    # when it is there, which takes seconds)
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from vdm4cdm_torch.train.tb_logger import TensorBoardLogger

    tb = TensorBoardLogger(str(tmp_path / "tb"))
    tb.log_scalars(3, {"loss": 0.25})
    tb.close()
    assert any((tmp_path / "tb").glob("events.out.tfevents.*"))
