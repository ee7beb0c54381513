"""The trained-model chain of the port (``python -m
vdm4cdm_torch.cli.blessed_chain``: train -> bless -> generate -> calc_ss ->
gate), its ``bless`` tool and ``utils/profiling.py``, in-process on the CPU
at a small size (8^3, chs (4, 8), 4 steps, a checkpoint every 2, 2 sampler
steps).

``StepTimer`` and ``assert_finite`` are held against the JAX package's
``utils/profiling.py``: the same ``time.perf_counter`` readings give the
same mean, median and rate, and the same non-finite leaves are named.
``bless`` copies the latest step by default, bit for bit, refuses a missing
step (listing the steps there are) and an orbax directory, and its EMA-only
copy is refused by ``load_params(prefer_ema=False)``. The chain runs the
entry points, writes ``summary.pkl`` with the JAX CLI's keys, resumes
instead of retraining, stops and resumes at ``--until`` bit for bit, and
its gate on the untrained model exits 1 naming the failing statistics. The
GRF stream resumed at a step equals the JAX package's from there.
"""

import ast
import contextlib
import io
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from vdm4cdm_tpu.cli import calc_ss as jcalc_ss
from vdm4cdm_tpu.data import grf as jgrf
from vdm4cdm_tpu.utils import profiling as jprofiling

from vdm4cdm_torch.cli import bless, blessed_chain
from vdm4cdm_torch.data import grf as tgrf
from vdm4cdm_torch.evals import acceptance
from vdm4cdm_torch.train.checkpoint import (ORBAX_MARKER, JaxCheckpointError,
                                            load_params, read_checkpoint)
from vdm4cdm_torch.utils import profiling

NAME = blessed_chain.NAME
SMALL = ["data.cropsize=8", "model.chs=(4,8)", "model.norm_groups=2",
         "run.max_steps=4", "run.ckpt_every_steps=2", "run.log_every_steps=1"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work is tiny; one thread keeps it off the cores
    that the other test workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chain(out, *extra, overrides=SMALL):
    """``blessed_chain.main`` on the CPU; (exit code, printed text, the
    JSON stage lines by stage)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = blessed_chain.main(["--out", str(out), "--device", "cpu",
                                 "--n-sampling-steps", "2", *extra,
                                 "--set", *overrides])
    text = buf.getvalue()
    lines = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith('{"chain"')]
    return rc, text, {ln["chain"]: ln for ln in lines}


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    out = tmp_path_factory.mktemp("chain")
    rc, text, by_stage = _chain(out, "--stages",
                                "train,bless,generate,calc_ss")
    assert rc == 0, text
    return out, by_stage


def _ckpts(out):
    return out / "runs" / NAME / "checkpoints"


# ----------------------------------------------------------- profiling

def _ticks(monkeypatch, timer_module, readings, n_ticks, window):
    it = iter(readings)
    monkeypatch.setattr(timer_module.time, "perf_counter", lambda: next(it))
    timer = timer_module.StepTimer(window=window)
    dts = [timer.tick() for _ in range(n_ticks)]
    return dts, timer.mean, timer.p50, timer.rate(8.0)


@pytest.mark.parametrize("n_ticks,window", [(0, 4), (1, 4), (2, 4), (7, 4),
                                            (9, 100)])
def test_step_timer_equals_jax(monkeypatch, n_ticks, window):
    readings = list(np.cumsum(np.random.default_rng(n_ticks)
                              .uniform(0.01, 0.5, size=n_ticks)))
    got = _ticks(monkeypatch, profiling, readings, n_ticks, window)
    want = _ticks(monkeypatch, jprofiling, readings, n_ticks, window)
    np.testing.assert_equal(got, want)
    if n_ticks < 2:  # nothing timed yet: nan, and the first tick is None
        assert np.isnan(got[1]) and np.isnan(got[2]) and np.isnan(got[3])
        assert got[0] == [None] * n_ticks


def _named(assert_finite, tree):
    with pytest.raises(AssertionError) as info:
        assert_finite(tree, "state")
    msg = str(info.value)
    assert msg.startswith("non-finite values in state: ")
    return set(ast.literal_eval(msg.split(": ", 1)[1]))


def test_assert_finite_names_the_leaves_jax_names():
    rng = np.random.default_rng(3)
    tree = {"params": {"conv": rng.standard_normal((3, 4)).astype(np.float32),
                       "norm": {"scale": np.ones(4, np.float32),
                                "bias": np.zeros(4, np.float32)}},
            "ema": [np.ones(2, np.float32), np.ones(3, np.float32)],
            "loss": np.float32(1.5)}
    jprofiling.assert_finite(tree)
    profiling.assert_finite(tree)
    tree["params"]["conv"][1, 2] = np.nan
    tree["params"]["norm"]["bias"][0] = np.inf
    tree["ema"][1][2] = -np.inf
    tree["loss"] = np.float32(np.nan)
    want = _named(jprofiling.assert_finite, tree)
    assert want == {"['params']['conv']", "['params']['norm']['bias']",
                    "['ema'][1]", "['loss']"}
    as_tensors = {"params": {"conv": torch.from_numpy(tree["params"]["conv"]),
                             "norm": {k: torch.from_numpy(v) for k, v in
                                      tree["params"]["norm"].items()}},
                  "ema": [torch.from_numpy(a) for a in tree["ema"]],
                  "loss": float("nan")}
    assert _named(profiling.assert_finite, tree) == want
    assert _named(profiling.assert_finite, as_tensors) == want


def test_nan_debugging_and_trace(tmp_path):
    before = torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)
    with profiling.trace(str(tmp_path / "tr")) as d:
        (torch.ones(8) * 2).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert d == str(tmp_path / "tr") and events["traceEvents"]


# ---------------------------------------------------------------- bless

def test_bless_copies_the_latest_step_bit_for_bit(chain, tmp_path, capsys):
    out, _ = chain
    dst = tmp_path / "blessed"
    assert bless.main([NAME, "--run-dir", str(_ckpts(out)), "--out",
                       str(dst), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert f"[bless] {NAME} step 4: {_ckpts(out)} -> " in printed
    assert " MB)" in printed
    run, got = read_checkpoint(str(_ckpts(out)), 4), read_checkpoint(
        str(dst), 4)
    assert got["opt_state"] is None and run["opt_state"] is not None
    for tree in ("params", "ema_params"):
        assert set(got[tree]) == set(run[tree])
        for k, t in run[tree].items():
            assert torch.equal(got[tree][k], t), (tree, k)
    # the EMA differs from the params after 4 steps: both were copied
    assert any(not torch.equal(run["params"][k], run["ema_params"][k])
               for k in run["params"])


def test_bless_ema_only_and_an_earlier_step(chain, tmp_path):
    out, _ = chain
    dst = tmp_path / "ema"
    bless.bless(str(_ckpts(out)), str(dst), step=2, ema_only=True)
    got, run = read_checkpoint(str(dst), 2), read_checkpoint(
        str(_ckpts(out)), 2)
    assert got["params"] is None and got["opt_state"] is None
    ema = load_params(str(dst))
    assert all(torch.equal(ema[k], t) for k, t in run["ema_params"].items())
    with pytest.raises(ValueError, match="holds the EMA weights alone"):
        load_params(str(dst), prefer_ema=False)


def test_bless_refuses_a_missing_step_and_an_orbax_directory(chain,
                                                             tmp_path):
    out, _ = chain
    with pytest.raises(FileNotFoundError,
                       match=r"step=3 .*available steps: \[2, 4\]"):
        bless.main([NAME, "--run-dir", str(_ckpts(out)), "--step", "3",
                    "--out", str(tmp_path / "b"), "--device", "cpu"])
    orbax = tmp_path / "orbax"
    (orbax / "8000").mkdir(parents=True)
    (orbax / "8000" / ORBAX_MARKER).write_text("{}")
    with pytest.raises(JaxCheckpointError, match="orbax"):
        bless.main([NAME, "--run-dir", str(orbax), "--out",
                    str(tmp_path / "b"), "--device", "cpu"])
    assert not (tmp_path / "b").exists()


def test_bless_and_the_chain_need_a_card_or_device_cpu(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bless.main([NAME, "--run-dir", str(tmp_path), "--out",
                    str(tmp_path / "b")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blessed_chain.main(["--out", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()


# ---------------------------------------------------------------- chain

def test_the_chain_runs_every_entry_point(chain, tmp_path):
    out, by_stage = chain
    assert list(by_stage) == ["train", "bless", "generate", "calc_ss"]
    assert all(ln["seconds"] > 0 for ln in by_stage.values())
    train = by_stage["train"]
    assert (train["from_step"], train["step"]) == (0, 4)
    assert train["step_s"] > 0 and train["feed_wait_s"] >= 0
    assert by_stage["bless"]["step"] == 4
    assert (out / "blessed" / NAME / "4" / "checkpoint.pt").is_file()
    registry = (out / "models.yaml").read_text()
    assert f"ckpt_dir: {out / 'blessed' / NAME}" in registry
    files = sorted(os.listdir(out / "CV_12_12"))
    assert files == sorted(f"gen_{i}.npy" for i in range(12))
    for name in files:
        a = np.load(out / "CV_12_12" / name)
        assert a.shape == (12, 1, 8, 8, 8) and np.isfinite(a).all()

    # summary.pkl has the keys the JAX CLI writes for the same campaign,
    # read off the JAX CLI's summary of its first rep of each box
    with open(out / "summary.pkl", "rb") as fh:
        got = pickle.load(fh)["CV_12_12"]
    (tmp_path / "CV_12_12").mkdir()
    for name in files:
        np.save(tmp_path / "CV_12_12" / name,
                np.load(out / "CV_12_12" / name)[:1])
    assert jcalc_ss.main([NAME, "--data-dir", str(tmp_path), "--platform",
                          "cpu", "--set", "data.cropsize=8"]) == 0
    with open(tmp_path / "summary.pkl", "rb") as fh:
        want = pickle.load(fh)
    assert list(want) == ["CV_12_12"] and set(got) == set(want["CV_12_12"])

    def first_rep(name):  # Mcdm_3_7 -> Mcdm_3_0; ground truth unchanged
        head, _, rep = name.rpartition("_")
        return name if "_GT_" in name else f"{head}_0"

    for part in ("stats", "images"):
        want_part = want["CV_12_12"][part]
        assert {first_rep(n) for n in got[part]} == set(want_part)
        assert len(got[part]) == len(want_part) + 12 * 11 * (
            1 if part == "stats" else 2)
    for name, stats in got["stats"].items():
        assert set(stats) == set(want["CV_12_12"]["stats"][first_rep(name)])


def test_fields_from_the_blessed_copy_equal_the_run_s(chain):
    """On the CPU the sampler repeats bit for bit, so the blessed copy's
    fields are the run directory's (on the card, where the conv forward's
    GroupNorm sums add with atomics, chip_smoke's chain phase holds them to
    1e-5 of max |field|)."""
    out, _ = chain
    import vdm4cdm_torch as vt

    cfg = blessed_chain.Chain(str(out), SMALL, "cpu", 2).cfg
    model = vt.build_model(cfg, device="cpu").eval()
    box = acceptance.gate_boxes(cfg, 1)[0]
    s = torch.from_numpy(np.repeat(box["conditioning"], 2, axis=0))
    v = torch.from_numpy(np.repeat(box["conditioning_values"][0], 2, axis=0))
    fields = []
    for d in (out / "blessed" / NAME, _ckpts(out)):
        load_params(str(d), model, step=4)
        fields.append(model.draw_samples(
            torch.Generator().manual_seed(71), batch_size=2,
            n_sampling_steps=2, s_conditioning=s, v_conditionings=[v]))
    assert torch.equal(*fields) and bool(torch.isfinite(fields[0]).all())


def test_a_second_call_resumes_and_does_not_retrain(chain):
    out, _ = chain
    metrics = (out / "runs" / NAME / "metrics.csv").read_bytes()
    rc, text, by_stage = _chain(out, "--stages", "train")
    assert rc == 0 and "[trainer] resumed from step 4" in text
    assert (by_stage["train"]["from_step"], by_stage["train"]["step"]) == (
        4, 4)
    assert (out / "runs" / NAME / "metrics.csv").read_bytes() == metrics
    assert sorted(os.listdir(_ckpts(out))) == ["2", "4"]


def test_until_stops_the_run_and_the_next_call_finishes_it(chain, tmp_path):
    out, _ = chain
    rc, text, by_stage = _chain(tmp_path, "--stages", "train",
                                "--until", "3")
    assert rc == 0 and by_stage["train"]["step"] == 3
    assert sorted(os.listdir(_ckpts(tmp_path))) == ["2", "3"]
    rc, text, by_stage = _chain(tmp_path, "--stages", "train")
    assert rc == 0 and "[trainer] resumed from step 3" in text
    assert by_stage["train"]["from_step"] == 3
    split, whole = (read_checkpoint(str(_ckpts(d)), 4)
                    for d in (tmp_path, out))
    for tree in ("params", "ema_params"):
        for k, t in whole[tree].items():
            assert torch.equal(split[tree][k], t), (tree, k)


def test_the_gate_fails_the_untrained_model_by_name(chain, monkeypatch):
    """The fail path, at fewer sampler steps than the gate's (the verdicts
    of an untrained model do not depend on them)."""
    out, _ = chain
    monkeypatch.setattr(acceptance, "GATE_STEPS", 10)
    monkeypatch.setattr(acceptance, "DDNM_STEPS", 10)
    rc, text, by_stage = _chain(out, "--stages", "gate")
    assert rc == 1
    gate = by_stage["gate"]
    failed = [k for k, row in gate["gate"].items() if not row["pass"]]
    assert failed and gate["failed"] == failed and not gate["passed"]
    assert f"[chain] the gate failed: {', '.join(failed)}" in text
    assert set(gate["gate"]) == set(acceptance.THRESHOLDS)
    for k, row in gate["gate"].items():
        assert row["threshold"] == json.loads(
            json.dumps(acceptance.THRESHOLDS[k]))
        assert row["jax_recorded"] == acceptance.GATE_JAX_RECORDED[k]
        assert row["converted_card"] == acceptance.GATE_CONVERTED_CARD[k]
    assert len(gate["gate"]["low_k_r"]["measured"]) == (
        acceptance.GATE_BOXES * acceptance.GATE_REPS)
    assert gate["sample_s"] > 0 and gate["ddnm_s"] > 0


def test_run_gate_on_given_samples_is_gate_statistics_of_them(monkeypatch):
    cfg = blessed_chain.Chain("unused", SMALL, "cpu", 2).cfg
    import vdm4cdm_torch as vt

    model = vt.build_model(cfg, device="cpu").eval()
    boxes = acceptance.gate_boxes(cfg)
    gt = np.concatenate([np.moveaxis(b["x"], -1, 1) for b in boxes])
    rng = np.random.default_rng(5)
    samples = (np.repeat(gt, acceptance.GATE_REPS, axis=0)
               + 0.3 * rng.standard_normal((len(gt) * acceptance.GATE_REPS,)
                                           + gt.shape[1:])).astype(np.float32)
    monkeypatch.setattr(acceptance, "DDNM_STEPS", 2)
    monkeypatch.setattr(acceptance, "DDNM_L", 1)
    result = acceptance.run_gate(model, cfg, samples=torch.from_numpy(samples))
    want = acceptance.gate_statistics(torch.from_numpy(samples),
                                      torch.from_numpy(gt.astype(np.float32)),
                                      acceptance.GATE_REPS)
    assert result.sample_s == 0.0
    assert result.stats["pk_ratio"] == [float(want["pk_ratio"].min()),
                                        float(want["pk_ratio"].max())]
    assert result.stats["low_k_r"] == [float(r) for r in want["low_k_r"]]
    assert result.stats["overlap"] == want["overlap"]
    assert result.passes["low_k_r"] and result.passes["pk_ratio"]


# ------------------------------------------------------------------ data

def test_grf_stream_resumed_at_a_step_equals_jax():
    """A resumed run's batches (``train_batches(n, start_step)``) skip the
    FFTs of the batches before; they are the uninterrupted stream's, and
    the JAX package's."""
    kw = dict(size=8, ndim=3, batch_size=3, seed=4)
    port, jax_dm = tgrf.GRFDataModule(**kw), jgrf.GRFDataModule(**kw)
    whole = list(port.train_batches(7))
    for got, want, ref in zip(port.train_batches(7, start_step=5),
                              jax_dm.train_batches(7, start_step=5),
                              whole[5:]):
        for k in ("x", "conditioning"):
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(got["conditioning_values"][0],
                                      want["conditioning_values"][0])
    assert len(list(port.train_batches(7, start_step=5))) == 2
