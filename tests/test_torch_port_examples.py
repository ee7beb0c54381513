"""The port's user examples (``vdm4cdm_torch/examples/``) at a toy size on
the CPU.

  * ``smoke_test``: trains ``smoke_vdm_2d`` cut to 16^2, chs (8, 8, 8, 8),
    for 2 steps, samples 2 fields and writes the validation panel: a PNG
    with matplotlib, and without it (the card's host) the panel's arrays
    and the line that says so, exit 0 either way;
  * ``ddnm_inpainting``: a fresh model's completion consistent with the
    observed half (``|A(x̂) - y|`` printed), both ways;
  * ``check_cc``: r(k) of two stacks equal to the JAX package's ``get_ccs``
    on the same normalized arrays within 1e-5, and its command line;
  * ``make_generation_jobs``: every job it writes is one ``python -m
    vdm4cdm_torch.cli.generate`` line that the port's generate parser reads
    back to the model, campaign, checkpoint and seed.
"""

import importlib.util
import re
import shlex

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from vdm4cdm_tpu.evals import get_ccs as jget_ccs

from vdm4cdm_torch.cli import generate
from vdm4cdm_torch.examples import (check_cc, ddnm_inpainting,
                                    make_generation_jobs, smoke_test)

TOY = ["--set", "data.cropsize=16", "model.chs=(8,8,8,8)",
       "model.norm_groups=4"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The examples' torch work is tiny; more threads only slow it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _no_matplotlib(monkeypatch):
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else find(name, *a))


@pytest.mark.parametrize("matplotlib", [True, False],
                         ids=["matplotlib", "no_matplotlib"])
def test_smoke_test_trains_samples_and_writes_the_panel(tmp_path, capsys,
                                                        monkeypatch,
                                                        matplotlib):
    if not matplotlib:
        _no_matplotlib(monkeypatch)
    out = tmp_path / "smoke"
    assert smoke_test.main(["--steps", "2", "--device", "cpu", "--out",
                            str(out), *TOY]) == 0
    printed = capsys.readouterr().out
    assert "trained 2 steps" in printed
    assert re.search(r"samples: \(2, 16, 16, 1\) std: [0-9.]+", printed)
    assert "cross-correlation r(k):" in printed
    if matplotlib:
        assert (out / "smoke_panel.png").stat().st_size > 0
    else:
        assert "matplotlib is not installed" in printed
        panel = np.load(out / "smoke_panel.npz")
        assert panel["image_Sampled_Target"].shape == (16, 16)
        assert panel["hist_0"].sum() > 0


@pytest.mark.parametrize("matplotlib", [True, False],
                         ids=["matplotlib", "no_matplotlib"])
def test_ddnm_inpainting_is_consistent_with_the_observation(
        tmp_path, capsys, monkeypatch, matplotlib):
    if not matplotlib:
        _no_matplotlib(monkeypatch)
    out = tmp_path / "ddnm.png"
    assert ddnm_inpainting.main(["--steps", "3", "--travel", "1",
                                 "--device", "cpu", "--out", str(out),
                                 *TOY]) == 0
    printed = capsys.readouterr().out
    err = float(re.search(r"\|A\(x̂\)-y\|∞ = (\S+)", printed).group(1))
    assert err < 1e-5
    if matplotlib:
        assert out.stat().st_size > 0
    else:
        assert "matplotlib is not installed" in printed
        arrays = np.load(tmp_path / "ddnm.npz")
        assert arrays["DDNM"].shape == (16, 16)


def test_check_cc_matches_jax_get_ccs(tmp_path, capsys):
    rng = np.random.default_rng(5)
    a = np.exp(rng.standard_normal((3, 16, 16))).astype(np.float32)
    b = (a + 0.5 * np.exp(rng.standard_normal(a.shape))).astype(np.float32)
    ks, ccs = check_cc.cross_correlation(a, b, "cpu")
    na = a[:, None] / a.sum(axis=(1, 2))[:, None, None, None]
    nb = b[:, None] / b.sum(axis=(1, 2))[:, None, None, None]
    jks, jccs = jget_ccs(jnp.asarray(na), jnp.asarray(nb))
    np.testing.assert_allclose(ks, np.asarray(jks[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ccs, np.asarray(jccs), rtol=0, atol=1e-5)
    assert ccs.shape == (3, len(ks)) and ccs.mean() > 0.3
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    assert check_cc.main([f"Mstar={tmp_path / 'a.npy'}",
                          f"Mcdm={tmp_path / 'b.npy'}", "--n", "2",
                          "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "r(k) of Mstar x Mcdm over 2 sims" in printed
    mean = [float(v) for v in printed.rsplit("mean r(k):", 1)[1].split()]
    np.testing.assert_allclose(mean, np.asarray(jccs)[:2].mean(0), atol=1e-3)


def test_generation_jobs_parse_with_the_generate_cli(tmp_path):
    out = tmp_path / "jobs"
    assert make_generation_jobs.main([
        "VDM_GRF_c_c_32", "--ckpt-dir", "runs/my run/checkpoints", "--out",
        str(out), "--n-shards", "2", "--runtypes", "CV_12_12", "1P_24"]) == 0
    scripts = sorted(out.iterdir())
    assert [p.name for p in scripts] == [
        f"VDM_GRF_c_c_32_{rt}_{s}.sh" for rt in ("1P_24", "CV_12_12")
        for s in (0, 1)]
    for path in scripts:
        lines = path.read_text().splitlines()
        assert lines[:2] == ["#!/bin/bash", "set -e"] and len(lines) == 3
        argv = shlex.split(lines[2])
        assert argv[:3] == ["python", "-m", "vdm4cdm_torch.cli.generate"]
        args = generate.build_parser().parse_args(argv[3:])
        stem, shard = path.stem.rsplit("_", 1)
        rt = stem[len("VDM_GRF_c_c_32_"):]
        assert (args.model_name, args.runtype, args.seed) == (
            "VDM_GRF_c_c_32", rt, int(shard))
        assert args.ckpt_dir == "runs/my run/checkpoints"
        assert args.device is None  # the card, as the JAX jobs' default
        assert args.save_path.endswith(f"VDM_GRF_c_c_32/{rt}/shard{shard}")
