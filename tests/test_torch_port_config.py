"""The port's ``config`` and ``presets`` against the JAX package's: every
preset and registry alias gives the same dict, and ``build_model`` gives a
model whose ``state_dict`` shapes are those of the JAX ``init_params`` tree
(through ``params_from_jax``, which checks every name and shape)."""

import jax
import numpy as np
import pytest
import torch

from vdm4cdm_tpu import presets as jpresets
from vdm4cdm_tpu.config import build_model as jbuild_model

import vdm4cdm_torch as vt
from vdm4cdm_torch import config as tconfig
from vdm4cdm_torch import presets as tpresets


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One thread for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


NAMES = sorted(jpresets.PRESETS) + sorted(jpresets._REGISTRY_ALIASES) + [
    "VDM_Go7_Mcdm_c_c_128", "VDM_Go8_Mcdm_c_c_128", "VDM_Go9_Mcdm_c_c_128"]
PRESETS_3D = sorted(k for k, c in jpresets.PRESETS.items()
                    if c.model.ndim == 3)
PRESETS_2D = sorted(k for k, c in jpresets.PRESETS.items()
                    if c.model.ndim == 2)


def test_the_port_has_the_same_presets_and_aliases():
    assert sorted(tpresets.PRESETS) == sorted(jpresets.PRESETS)
    assert tpresets._REGISTRY_ALIASES == jpresets._REGISTRY_ALIASES
    assert len(PRESETS_3D) + len(PRESETS_2D) == len(jpresets.PRESETS)
    with pytest.raises(KeyError, match="unknown preset"):
        tpresets.preset("no_such_preset")


@pytest.mark.parametrize("name", NAMES)
def test_preset_dict_equals_jax(name):
    got, want = tpresets.preset(name), jpresets.preset(name)
    assert got.to_dict() == want.to_dict()
    assert got.conditioning_tag == want.conditioning_tag
    assert got.run.experiment_name == name
    assert got.parallel.needs_mesh == want.parallel.needs_mesh


def test_go_rule_override_and_deep_copy():
    cfg = tpresets.preset("VDM_Go8_Mcdm_c_c_128")
    assert cfg.data.in_field == "Go8" and cfg.data.cropsize == 128
    over = {"data.cropsize": 64, "model.remat": False, "run.seed": 7}
    got = tpresets.preset("trainSFM3D128_c_c", **over)
    assert got.to_dict() == jpresets.preset("trainSFM3D128_c_c",
                                            **over).to_dict()
    assert (got.data.cropsize, got.model.remat, got.run.seed) == (64, False, 7)
    assert got.model.family == "sfm" and got.data.batch_size == 4
    # overrides do not leak into the registry
    assert tpresets.preset("trainSFM3D128_c_c").data.cropsize == 128


def test_yaml_round_trip_and_cross_loading(tmp_path):
    from vdm4cdm_tpu.config import ExperimentConfig as JExperimentConfig

    cfg = tpresets.preset("trainSFM3D128_c_c", **{"model.sfm_sigma": 0.5})
    path = tmp_path / "cfg.yaml"
    cfg.save(str(path))
    back = tconfig.ExperimentConfig.load(str(path))
    assert back.to_dict() == cfg.to_dict()
    assert JExperimentConfig.load(str(path)).to_dict() == cfg.to_dict()
    assert tconfig.ExperimentConfig.from_dict({}).to_dict() == \
        JExperimentConfig().to_dict()


@pytest.mark.parametrize("name", PRESETS_3D)
def test_build_model_shapes_equal_jax_init_params(name):
    _build_model_shapes_equal_jax(name)


def _build_model_shapes_equal_jax(name):
    over = {"data.cropsize": 8}
    cfg = tpresets.preset(name, **over)
    jmodel = jbuild_model(jpresets.preset(name, **over))
    # shapes only: trace the JAX init, do not run it
    tree = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, np.float32),
        jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)))
    model = tconfig.build_model(cfg, device="cpu")
    family = {"vdm": vt.VDM, "sfm": vt.SFM}[cfg.model.family]
    assert type(model) is family
    sd = vt.params_from_jax(tree, model)  # raises on any name or shape
    assert set(sd) == set(model.state_dict())
    net = model.unet if family is vt.SFM else model.score_model
    assert net.conv_padding_mode == jmodel_net(jmodel).conv_padding_mode
    assert net.compute_dtype == (torch.bfloat16
                                 if cfg.model.compute_dtype == "bfloat16"
                                 else torch.float32)
    assert net.remat == cfg.model.remat
    assert net.s_conditioning_channels == (1 if cfg.data.in_field else 0)
    assert net.v_conditioning_dims == (
        (cfg.data.conditioning_values,) if cfg.data.conditioning_values
        else ())
    assert net.shape == (1,) + (8,) * cfg.model.ndim


def jmodel_net(jmodel):
    return getattr(jmodel, "score_model", None) or jmodel.velocity_model


@pytest.mark.parametrize("name", PRESETS_2D)
def test_2d_presets_are_not_ported_yet(name):
    """The 2D presets are ported (they raised before the 2D slice): their
    models have the JAX init tree's names and shapes, as the 3D ones."""
    _build_model_shapes_equal_jax(name)


def test_build_model_padding_rule_sigma_and_family_check():
    full = tconfig.build_model(tpresets.preset(
        "trainSFM3D_c_c_256", **{"model.chs": (8, 16),
                                 "model.sfm_sigma": 0.25}), device="cpu")
    assert full.unet.conv_padding_mode == "circular" and full.sigma == 0.25
    crop = tconfig.build_model(tpresets.preset(
        "trainVDM3D128_c_c", **{"data.cropsize": 16}), device="cpu")
    assert crop.score_model.conv_padding_mode == "zeros"
    grf = tconfig.build_model(tpresets.preset("smoke_sfm_3d"), device="cpu")
    assert grf.unet.conv_padding_mode == "circular"
    bad = tpresets.preset("smoke_sfm_3d", **{"model.family": "gan"})
    with pytest.raises(ValueError, match="unknown model family"):
        tconfig.build_model(bad, device="cpu")


def test_build_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconfig.build_model(tpresets.preset("smoke_sfm_3d"))
