"""The port's ``cli.calc_ss`` and ``cli.prepare_data`` against the JAX
package's on the CPU, and the validation-figure hook in a real training run.

``calc_ss`` of both packages reads the same tiny CV_12_12 and 1P_24
campaigns of the 32^3 GRF preset ``VDM_GRF_c_c_32`` (arrays made from a
seed) and must write the same ``summary.pkl`` keys, each value within 1e-4
of its own scale, max |JAX value| of that key (f32 FFTs and sums of two
libraries), and each log-PDF with at most max(1, 1e-4 n) of its n values
one bin over; a CV_1_128
campaign at 128^3 takes the scattering-transform branch. The GRF data
module's unnormalization is the identity and its fields have zero mean, so
P(k) of a field over its sum would be a ratio to round-off: both packages'
GRF modules get a positive unnormalization here, 10^(0.3 y + 11), which
puts the fields and their projections inside the log-PDF bins, as CAMELS
fields are. ``prepare_data downsample`` is within 1e-5 of
``jax.image.resize`` (relative to the field's max); ``project`` and
``normalize`` are the same numpy and write equal files.
"""

import json
import pickle
import shutil

import numpy as np
import pytest
import torch

from vdm4cdm_tpu.cli import calc_ss as jcalc_ss
from vdm4cdm_tpu.cli import prepare_data as jprepare
from vdm4cdm_tpu.data import grf as jgrf

from vdm4cdm_torch.cli import calc_ss, prepare_data, train
from vdm4cdm_torch.data import grf as tgrf

NAME = "VDM_GRF_c_c_32"
ONE_P_NAMES = ["fid", "Om_m2", "Om_p2", "ASN1_m3", "ASN1_p3"]
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def positive_grf(monkeypatch):
    def unnorm(field, i_channel):
        return 10.0 ** (field * 0.3 + 11.0)

    for mod in (jgrf, tgrf):
        monkeypatch.setattr(mod.GRFDataModule, "unnorm_func",
                            staticmethod(unnorm))


def _summaries(data_dir, extra=()):
    """summary.pkl of the JAX CLI, then of the port's, on ``data_dir``."""
    out = []
    for main, dev in ((jcalc_ss.main, ["--platform", "cpu"]),
                      (calc_ss.main, ["--device", "cpu"])):
        assert main([NAME, "--data-dir", str(data_dir), *dev, *extra]) == 0
        with open(data_dir / "summary.pkl", "rb") as f:
            out.append(pickle.load(f))
        (data_dir / "summary.pkl").unlink()
    return out


def _rel_errs(got, want, path="", errs=None):
    """{path: |got - want| max / |want| max} over every non-log-PDF value of
    the two summaries (same keys and shapes, or AssertionError); each
    log-PDF is checked here for its count of values moved."""
    errs = {} if errs is None else errs
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for k in want:
            _rel_errs(got[k], want[k], f"{path}/{k}", errs)
        return errs
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if path.endswith("logpdf"):
        # counts: a value within an ulp of a bin edge (after f32 sums and
        # unnormalization of two libraries, and XLA's f32 log10) can land
        # one bin over; at most max(1, 1e-4 n) of the n values may move
        moved = np.abs(g - w).sum() / 2
        assert moved <= max(1.0, TOL * w.sum()), f"{path}: {moved} moved"
        return errs
    scale = np.abs(w).max()
    assert scale > 0, f"{path}: the JAX value is all zeros"
    errs[path] = float(np.abs(g - w).max() / scale)
    return errs


def _assert_same(got, want):
    errs = _rel_errs(got, want)
    worst = max(errs, key=errs.get)
    print(f"worst relative error {errs[worst]:.3g} at {worst}")
    assert errs[worst] <= TOL, f"{worst}: {errs[worst]:.3g} > {TOL}"


def _campaign(root, key, files, reps, size, seed):
    rng = np.random.default_rng(seed)
    d = root / key
    d.mkdir(parents=True)
    for name in files:
        a = rng.standard_normal((reps, 1, size, size, size))
        np.save(d / name, a.astype(np.float32))


def test_calc_ss_matches_jax_on_cv_12_12_and_1p_24(tmp_path, positive_grf):
    _campaign(tmp_path, "CV_12_12", [f"gen_{i}.npy" for i in range(12)],
              2, 32, 21)
    _campaign(tmp_path, "1P_24", [f"{n}_24.npy" for n in ONE_P_NAMES],
              2, 32, 22)
    want, got = _summaries(tmp_path)
    assert set(want) == {"CV_12_12", "1P_24"}
    stats = want["CV_12_12"]["stats"]
    assert len(stats) == 12 + 12 * 2 and "Mcdm_GT_11" in stats
    assert set(stats["Mcdm_3_1"]) == {
        "3d_mean", "3d_std", "3d_pk", "3d_logpdf",
        *(f"2d_{p}_{s}" for p in ("half", "quarter")
          for s in ("mean", "std", "pk", "logpdf"))}
    assert "Mcdm_ASN1_p3_1" in want["1P_24"]["stats"]
    assert stats["Mcdm_3_1"]["3d_logpdf"].sum() > 0.9 * 32**3
    assert stats["Mcdm_3_1"]["2d_half_logpdf"].sum() > 0.9 * 32**2
    _assert_same(got, want)


def test_calc_ss_cv_1_128_with_rwst_matches_jax(tmp_path, positive_grf):
    """128^3: the projections are 128 wide, so each sample also gets its
    reduced scattering transform; CV_1_128 adds the posterior moments."""
    _campaign(tmp_path, "CV_1_128", ["gen_0.npy"], 2, 128, 23)
    want, got = _summaries(tmp_path, ["--set", "data.cropsize=128"])
    stats = want["CV_1_128"]["stats"]
    assert set(stats) == {"Mcdm_GT_0", "Mcdm_0_0", "Mcdm_0_1"}
    assert stats["Mcdm_0_0"]["2d_half_rwst"].shape == (1, 4 + 6 * 4)
    assert want["CV_1_128"]["post_means"].shape == (1, 1, 128, 128, 128)
    _assert_same(got, want)


@pytest.mark.parametrize("conserve", [False, True], ids=["plain", "mass"])
@pytest.mark.parametrize("sizes", [(16, 8), (24, 16), (32, 24)],
                         ids=lambda s: f"{s[0]}to{s[1]}")
def test_downsample_matches_jax_image_resize(tmp_path, sizes, conserve):
    n_in, n_out = sizes
    rng = np.random.default_rng(n_in)
    data = np.exp(rng.normal(0.0, 1.5, (2, n_in, n_in, n_in)))
    src = tmp_path / "in.npy"
    np.save(src, data.astype(np.float32))
    flag = ["--conserve-mass"] if conserve else []
    jprepare.main(["downsample", str(src), str(tmp_path / "j.npy"),
                   "--size", str(n_out), *flag])
    prepare_data.main(["downsample", str(src), str(tmp_path / "t.npy"),
                       "--size", str(n_out), "--device", "cpu", *flag])
    want, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.shape == want.shape == (2, n_out, n_out, n_out)
    assert got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_resize_weights_rows_and_upsampling():
    w = prepare_data.resize_weights(32, 16)
    np.testing.assert_allclose(w.sum(axis=0), 1.0, rtol=1e-12)
    taps = (w > 0).sum(axis=0)  # antialiased: twice as wide, the edge
    assert taps[0] == taps[-1] == 3 and (taps[1:-1] == 4).all()  # cut off
    up = prepare_data.resize_weights(8, 16)
    assert (up > 0).sum(axis=0).max() == 2  # plain linear interpolation


def test_project_and_normalize_equal_jax(tmp_path):
    rng = np.random.default_rng(31)
    vol = (10.0 ** rng.normal(3.0, 0.5, (2, 16, 16, 16))).astype(np.float32)
    np.save(tmp_path / "v.npy", vol)
    for taper in ("0", "3"):
        for mod, name in ((jprepare, "j"), (prepare_data, "t")):
            mod.main(["project", str(tmp_path / "v.npy"),
                      str(tmp_path / f"p{name}.npy"), "--depth", "8",
                      "--taper", taper])
        np.testing.assert_array_equal(np.load(tmp_path / "pt.npy"),
                                      np.load(tmp_path / "pj.npy"))
    json.dump({"F": 0.5}, open(tmp_path / "alphas.json", "w"))
    for mod, name in ((jprepare, "j"), (prepare_data, "t")):
        out = tmp_path / f"n{name}.json"
        json.dump({"G_m": 1.0}, open(out, "w"))
        mod.main(["normalize", f"F={tmp_path / 'v.npy'}", "--output",
                  str(out), "--alphas", str(tmp_path / "alphas.json"),
                  "--merge"])
    assert (json.load(open(tmp_path / "nt.json"))
            == json.load(open(tmp_path / "nj.json")))


def test_downsample_needs_a_device_or_cpu(tmp_path):
    np.save(tmp_path / "v.npy", np.ones((1, 8, 8, 8), np.float32))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_data.main(["downsample", str(tmp_path / "v.npy"),
                           str(tmp_path / "o.npy"), "--size", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calc_ss.main([NAME, "--data-dir", str(tmp_path)])


@pytest.mark.parametrize("family", ["vdm", "sfm"])
def test_figure_hook_in_a_training_run(tmp_path, family, capsys):
    """``cli.train`` hands the hook to the Trainer: two steps with a
    validation at step 2 sample the model (2 steps) and write the figure."""
    pytest.importorskip("matplotlib")
    preset = "trainSFM3D128_c_c" if family == "sfm" else "trainVDM3D128_c_c"
    sets = ["data.kind=grf", "data.cropsize=8", "data.batch_size=2",
            "model.chs=(4,8)", "model.norm_groups=2", "model.remat=False",
            "model.compute_dtype=float32", f"run.out_dir={tmp_path}",
            "run.max_steps=2", "run.val_check_interval=2",
            "run.n_val_batches=1", "run.ckpt_every_steps=100",
            "run.n_figure_sampling_steps=2"]
    assert train.main(["--preset", preset, "--device", "cpu",
                       "--set", *sets]) == 0
    figs = sorted((tmp_path / preset / "figures").iterdir())
    assert [p.name for p in figs] == ["validation_00000002.png"]
    assert figs[0].stat().st_size > 10_000
    assert "validation figures are off" not in capsys.readouterr().out
    shutil.rmtree(tmp_path / preset)


def test_training_without_matplotlib_says_so_and_draws_nothing(
        tmp_path, monkeypatch, capsys):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    preset = "trainVDM3D128_c_c"
    assert train.main([
        "--preset", preset, "--device", "cpu", "--set", "data.kind=grf",
        "data.cropsize=8", "data.batch_size=2", "model.chs=(4,8)",
        "model.norm_groups=2", "model.remat=False",
        "model.compute_dtype=float32", f"run.out_dir={tmp_path}",
        "run.max_steps=2", "run.val_check_interval=2",
        "run.n_val_batches=1", "run.ckpt_every_steps=100"]) == 0
    out = capsys.readouterr().out
    assert out.count("[train] validation figures are off: matplotlib is "
                     "not installed") == 1
    assert not list((tmp_path / preset / "figures").iterdir())
