"""The port's entry points (``python -m vdm4cdm_torch.cli.train`` and
``.generate``), in-process on the CPU at a small size.

``parse_overrides`` equals the JAX package's. Train, resume and generate
with ``--device cpu`` write ``metrics.csv``, the checkpoints and the campaign
files with the JAX CLI's names, shapes and layout ((B, C, *spatial) f32).
Without ``--device`` and without a card the CLI raises; a 2D config under
``sp`` sharding (not ported yet) raises ``NotImplementedError``. And the slice against JAX: the SFM preset
``trainSFM3D128_c_c`` at 16^3, chs (8, 16), f32, ``sfm_sigma`` 0, with the
same seeded parameters on both sides, saved as a port checkpoint: the port's
``cli.generate`` (Heun, 2 steps, CV_12_12) writes what the JAX package's
``SFM.draw_samples`` gives on the same x0 from the GRF test loader, within
1e-4 of max(1, max |ref|) (f32 sums in another order, 8 UNet passes).
"""

import hashlib
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from _torch_port_util import randomize_tree
from vdm4cdm_tpu import config as jconfig
from vdm4cdm_tpu import presets as jpresets
from vdm4cdm_tpu.cli.train import parse_overrides as jparse_overrides

import vdm4cdm_torch as vt
from vdm4cdm_torch.cli import generate, train
from vdm4cdm_torch.train.checkpoint import CheckpointManager, JaxCheckpointError

ROOT = pathlib.Path(__file__).resolve().parents[1]
VDM = "trainVDM3D128_c_c"
SMALL = ["data.kind=grf", "data.cropsize=8", "data.batch_size=2",
         "model.chs=(4,8)", "model.norm_groups=2", "model.remat=False",
         "model.compute_dtype=float32"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work is tiny; one thread keeps it off the cores
    that the other test workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_parse_overrides_equals_jax():
    pairs = ["run.max_steps=6", "model.chs=(32, 64)", "data.kind=grf",
             "run.learning_rate=3e-4", "data.in_field=None",
             "run.resume=False", "run.out_dir=/tmp/a=b", "x.y=[1, 'a']",
             "data.name=CMD_128", "empty="]
    assert train.parse_overrides(pairs) == jparse_overrides(pairs)
    assert train.parse_overrides(None) == jparse_overrides(None) == {}


@pytest.fixture(scope="module")
def vdm_run(tmp_path_factory):
    """A VDM trained 2 steps, then resumed to 3, through the CLI."""
    out = tmp_path_factory.mktemp("runs")
    args = ["--preset", VDM, "--device", "cpu", "--set", *SMALL,
            f"run.out_dir={out}", "run.ckpt_every_steps=2",
            "run.val_check_interval=2", "run.n_val_batches=1",
            "run.log_every_steps=1"]
    assert train.main(args + ["run.max_steps=2"]) == 0
    assert train.main(args + ["run.max_steps=3"]) == 0
    return out / VDM


def test_train_then_resume_writes_metrics_and_checkpoints(vdm_run, capsys):
    assert CheckpointManager(str(vdm_run / "checkpoints")).all_steps() == [2, 3]
    lines = (vdm_run / "metrics.csv").read_text().splitlines()
    header = lines[0].split(",")
    for col in ("step", "loss", "diffusion", "grad_norm", "lr", "step_s",
                "feed_wait_s", "val_loss", "ckpt_save_s", "ckpt_bytes"):
        assert col in header
    steps = [int(line.split(",")[0]) for line in lines[1:]
             if line.split(",")[header.index("loss")]]
    assert steps == [1, 2, 3]


@pytest.mark.parametrize("runtype,names,reps", [
    ("CV_12_12", [f"gen_{i}.npy" for i in range(12)], 12),
    ("1P_24", ["fid_24.npy", "Om_m2_24.npy", "Om_p2_24.npy"], 24)])
def test_generate_campaign_files(vdm_run, tmp_path, runtype, names, reps):
    out = tmp_path / runtype
    assert generate.main([VDM, str(out), runtype, "--ckpt-dir",
                          str(vdm_run / "checkpoints"), "--device", "cpu",
                          "--n-sampling-steps", "2", "--reps-per-batch",
                          str(reps), "--set", *SMALL]) == 0
    assert sorted(os.listdir(out)) == sorted(names)
    for name in names:
        a = np.load(out / name)
        assert a.shape == (reps, 1, 8, 8, 8) and a.dtype == np.float32
        assert np.isfinite(a).all() and a.flags["C_CONTIGUOUS"]
        assert float(a.std()) > 0


def test_warm_start_and_yaml_config(vdm_run, tmp_path, capsys):
    cfg = vt.preset(VDM)
    for k, v in train.parse_overrides(SMALL).items():
        section, _, field = k.partition(".")
        setattr(getattr(cfg, section), field, v)
    cfg.run.out_dir = str(tmp_path)
    cfg.run.max_steps = 1
    cfg.run.warm_start_ckpt = str(vdm_run / "checkpoints")
    path = tmp_path / "cfg.yaml"
    cfg.save(str(path))
    assert train.main(["--config", str(path), "--device", "cpu"]) == 0
    assert "[train] warm-started params from" in capsys.readouterr().out


def test_the_cli_needs_a_card_or_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--preset", VDM, "--set", *SMALL,
                    f"run.out_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main([VDM, str(tmp_path / "g"), "CV_12_12", "--ckpt-dir",
                       str(tmp_path), "--set", *SMALL])
    # a 2D model under sp runs (``test_torch_port_sharded_cli.py``): one
    # process is one rank short of its mesh
    with pytest.raises(ValueError, match=r"1 rank\(s\) but parallel.n_data"):
        train.main(["--preset", "smoke_vdm_2d", "--device", "cpu", "--set",
                    "parallel.n_sp=2", f"run.out_dir={tmp_path}"])


def test_registry_lookup_reads_models_yaml_and_refuses_orbax(monkeypatch,
                                                             tmp_path):
    registry = ROOT / "configs" / "models.yaml"
    before = hashlib.sha256(registry.read_bytes()).hexdigest()
    monkeypatch.chdir(ROOT)  # the registry's ckpt_dir is relative to it
    with pytest.raises(JaxCheckpointError, match="JAX"):
        generate.main(["VDM_GRF_c_c_32", str(tmp_path / "g"), "CV_12_12",
                       "--model-registry", str(registry),
                       "--device", "cpu", "--n-sampling-steps", "1"])
    assert hashlib.sha256(registry.read_bytes()).hexdigest() == before


def test_sfm_campaign_matches_jax_draw_samples(tmp_path):
    over = ["data.kind=grf", "data.cropsize=16", "model.chs=(8,16)",
            "model.norm_groups=4", "model.compute_dtype=float32",
            "model.remat=False"]
    name = "trainSFM3D128_c_c"
    jcfg = jpresets.preset(name, **train.parse_overrides(over))
    jmodel = jconfig.build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    tree = randomize_tree(jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, np.float32), shapes), 41)

    model = vt.build_model(vt.preset(name, **train.parse_overrides(over)),
                           device="cpu")
    model.load_state_dict(vt.params_from_jax(tree, model))
    ckpt = tmp_path / "checkpoints"
    CheckpointManager(str(ckpt)).save(vt.TrainState(
        0, model, vt.make_optimizer().init(model), None))
    out = tmp_path / "gen"
    assert generate.main([name, str(out), "CV_12_12", "--ckpt-dir", str(ckpt),
                          "--device", "cpu", "--sfm-method", "heun",
                          "--n-sampling-steps", "2", "--set", *over]) == 0

    jcfg.data.set_name, jcfg.data.batch_size = "CV", 1
    batches = list(jconfig.build_datamodule(jcfg, stage="test")
                   .test_dataloader())[:12]
    x0 = np.concatenate([b["x0"] for b in batches])
    v = np.concatenate([b["conditioning_values"][0] for b in batches])
    want = np.asarray(jmodel.draw_samples(
        jax.tree_util.tree_map(np.asarray, tree), x0, n_sampling_steps=2,
        v_conditionings=[v], method="heun"))
    want = np.moveaxis(want, -1, 1)  # (12, 1, 16, 16, 16)
    scale = max(1.0, float(np.abs(want).max()))
    for i in range(12):
        got = np.load(out / f"gen_{i}.npy")
        assert got.shape == (12, 1, 16, 16, 16) and got.dtype == np.float32
        assert (got == got[:1]).all()  # a deterministic SFM: equal reps
        assert float(np.abs(got[0] - want[i]).max()) <= 1e-4 * scale
    assert float(np.abs(want).std()) > 0.1  # the samples carry signal
