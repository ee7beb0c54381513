"""Reference-equivalent experiment presets: counterpart of
``vdm4cdm_tpu/presets.py`` (this package's own copy; every preset's dict
equals the JAX package's).

Each entry reproduces one of the reference's 17 train scripts (SURVEY.md §2a
train-script rows) as an ExperimentConfig — same model family, dimensionality,
conditioning, channel widths, crop size, batch size, gamma bounds, and
validation cadence. Resolution variants that the reference expresses as
separate scripts + pre-downsampled datasets (trainVDM3D{128,160,192,224}_...)
are here a single preset parameterized by cropsize/dataset_name.

Names follow the reference scripts; `preset(name)` also accepts the
configs.yaml model-registry names (VDM_Mstar_Mcdm_c_c_128 etc.).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .config import DataConfig, ExperimentConfig, ModelConfig, RunConfig

_CHS_2D = (48, 96, 192, 384)       # reference train_uc_uc_from_field_name.py:60
_CHS_3D_MID = (32, 64, 128, 256)   # reference configs.yaml:115-119 (<=192^3)
_CHS_3D_THIN = (16, 32, 64, 128)   # reference trainVDM3D_c_c...:60 (224^3/256^3)


def _vdm2d(in_field: Optional[str], cond_values: int, out_field="Mcdm") -> ExperimentConfig:
    return ExperimentConfig(
        model=ModelConfig(family="vdm", ndim=2, chs=_CHS_2D),
        data=DataConfig(
            kind="camels", in_field=in_field, out_field=out_field, cropsize=256,
            batch_size=12, conditioning_values=cond_values, suite_name="Astrid",
        ),
        run=RunConfig(val_check_interval=1000),
    )


def _vdm3d(cropsize: int, chs, dataset_name: str, in_field="Mstar",
           cond_values: int = 6, batch_size: int = 2) -> ExperimentConfig:
    return ExperimentConfig(
        # defaults for 3D volumes: bf16 activations (f32 params and loss
        # unaffected) and ResBlock remat, which trades a recomputed forward
        # for activation memory; override ``model.remat`` where the step fits
        model=ModelConfig(family="vdm", ndim=3, chs=chs,
                          compute_dtype="bfloat16", remat=True),
        data=DataConfig(
            kind="camels", dataset_name=dataset_name, in_field=in_field,
            out_field="Mcdm", cropsize=cropsize, batch_size=batch_size,
            conditioning_values=cond_values,
        ),
        run=RunConfig(val_check_interval=5000),
    )


def _sfm3d(cropsize: int, chs, dataset_name: str, in_field="Mstar",
           cond_values: int = 6, batch_size: int = 2) -> ExperimentConfig:
    cfg = _vdm3d(cropsize, chs, dataset_name, in_field, cond_values, batch_size)
    cfg.model = dataclasses.replace(cfg.model, family="sfm")
    cfg.run = dataclasses.replace(cfg.run, val_check_interval=1000)
    return cfg


PRESETS: dict[str, ExperimentConfig] = {
    # ---- 2D (256^2 maps; reference train_uc_uc / train_uc_c / trainSFM_c_uc)
    "train_uc_uc": _vdm2d(in_field=None, cond_values=0),
    "train_uc_c": _vdm2d(in_field=None, cond_values=6),
    "trainSFM_c_uc": dataclasses.replace(
        _vdm2d(in_field="Mstar", cond_values=0),
        model=ModelConfig(family="sfm", ndim=2, chs=_CHS_2D, mid_attn=True),
    ),
    # ---- 3D VDM, early pair (crop 128/160 of 256^3 grids, wide channels)
    "train3D_c_c": _vdm3d(128, _CHS_2D, "CMD"),
    "train3D_c_c_160": _vdm3d(160, _CHS_2D, "CMD"),
    # ---- 3D VDM thick_lowbatch family (native-resolution grids)
    "trainVDM3D_c_c_256": _vdm3d(256, _CHS_3D_THIN, "CMD"),
    "trainVDM3D_c_uc_256": _vdm3d(256, _CHS_3D_THIN, "CMD", cond_values=0),
    "trainVDM3D128_c_c": _vdm3d(128, _CHS_3D_MID, "CMD_128"),
    "trainVDM3D160_c_c": _vdm3d(160, _CHS_3D_MID, "CMD_160"),
    "trainVDM3D192_c_c": _vdm3d(192, _CHS_3D_MID, "CMD_192"),
    "trainVDM3D224_c_c": _vdm3d(224, _CHS_3D_THIN, "CMD_224"),
    # ---- 3D SFM family (batch 4 at <=160^3, reference trainSFM3D128...:68)
    "trainSFM3D_c_c_256": _sfm3d(256, _CHS_3D_THIN, "CMD"),
    "trainSFM3D_c_uc_256": _sfm3d(256, _CHS_3D_THIN, "CMD", cond_values=0),
    "trainSFM3D_c_uc_thick": _sfm3d(256, _CHS_3D_MID, "CMD", cond_values=0),
    "trainSFM3D128_c_c": _sfm3d(128, _CHS_3D_MID, "CMD_128", batch_size=4),
    "trainSFM3D160_c_c": _sfm3d(160, _CHS_3D_MID, "CMD_160", batch_size=4),
    "trainSFM3D192_c_c": _sfm3d(192, _CHS_3D_MID, "CMD_192"),
    # ---- synthetic smoke configs (no CAMELS data needed)
    "smoke_vdm_2d": ExperimentConfig(
        model=ModelConfig(family="vdm", ndim=2, chs=(16, 32, 48, 64)),
        data=DataConfig(kind="grf", cropsize=32, batch_size=8),
        run=RunConfig(max_steps=300, val_check_interval=150, ckpt_every_steps=100,
                      learning_rate=2e-3),
    ),
    "smoke_sfm_3d": ExperimentConfig(
        model=ModelConfig(family="sfm", ndim=3, chs=(8, 16, 24, 32)),
        data=DataConfig(kind="grf", cropsize=16, batch_size=4),
        run=RunConfig(max_steps=100, val_check_interval=50, ckpt_every_steps=100,
                      learning_rate=2e-3),
    ),
    # ---- blessed in-repo run: the registry-chain proof. Trained with the
    # JAX package on the synthetic GRF substrate (no CAMELS data exists in
    # this repository); its orbax checkpoint is registered in
    # configs/models.yaml. This package reads the converted copy registered
    # in configs/models_torch.yaml (blessed/VDM_GRF_c_c_32/torch, written by
    # interop/blessed.py), so `python -m vdm4cdm_torch.cli.generate` and
    # `.calc_ss` run it from the name alone, the role the reference's
    # configs.yaml entries (configs.yaml:3) play with CAMELS checkpoints.
    # 3D so the calc_ss statistics (depth projections, 3D P(k)) carry their
    # reference semantics. tests/test_torch_port_blessed.py gates sample
    # quality (P(k) band, log-PDF overlap, r(k) floor, spread, DDNM) on it.
    "VDM_GRF_c_c_32": ExperimentConfig(
        model=ModelConfig(family="vdm", ndim=3, chs=(16, 32, 48, 64)),
        data=DataConfig(kind="grf", cropsize=32, batch_size=8),
        # lr 2e-4: on this exact config 1e-3 NaN'd at ~step 1500 (round-4
        # log) and 3e-4 NaN'd at ~step 4225 (round-5 log; the round-5 blessed
        # artifact is 0-4000 @ 3e-4 + auto-resume 4000-8000 @ 1.5e-4).
        # Retraining via tools/blessed_chain.sh reproduces an equivalent-
        # quality checkpoint, not a bit-equal one.
        # 20k steps + EMA(0.999): at 8k/no-EMA the sampler chain amplified
        # the residual eps error to ~5.9x amplitude (round-5 calibration);
        # the reverse chain's alpha_0/alpha_1 ~ 670x expansion makes sample
        # amplitude exponentially sensitive to eps_hat convergence
        run=RunConfig(max_steps=20000, val_check_interval=2000,
                      ckpt_every_steps=2000, learning_rate=2e-4,
                      ema_decay=0.999),
    ),
}

# configs.yaml model-registry aliases (reference configs.yaml:1-217)
_REGISTRY_ALIASES = {
    "VDM_Mstar_Mcdm_c_c_128": "trainVDM3D128_c_c",
    "VDM_Mstar_Mcdm_c_c_160": "trainVDM3D160_c_c",
    "VDM_Mstar_Mcdm_c_c_192": "trainVDM3D192_c_c",
    "VDM_Mstar_Mcdm_c_c_224": "trainVDM3D224_c_c",
    "VDM_Mstar_Mcdm_c_c_256": "trainVDM3D_c_c_256",
    "VDM_Mstar_Mcdm_c_uc_256": "trainVDM3D_c_uc_256",
    "SFM_Mstar_Mcdm_c_c_128": "trainSFM3D128_c_c",
    "SFM_Mstar_Mcdm_c_c_256": "trainSFM3D_c_c_256",
}


def preset(name: str, **overrides) -> ExperimentConfig:
    """Fetch a preset by script name or configs.yaml model name. Go7/Go8/Go9
    variants (galaxy-count conditioning) select the in_field dynamically."""
    if name.startswith("VDM_Go") and name.endswith("_Mcdm_c_c_128"):
        go = name.split("_")[1]  # Go7 | Go8 | Go9
        cfg = _vdm3d(128, _CHS_3D_MID, "CMD_128", in_field=go)
    else:
        key = _REGISTRY_ALIASES.get(name, name)
        if key not in PRESETS:
            raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
        cfg = PRESETS[key]
    cfg = ExperimentConfig.from_dict(cfg.to_dict())  # deep copy
    cfg.run.experiment_name = name
    for k, v in overrides.items():
        section, _, field = k.partition(".")
        setattr(getattr(cfg, section), field, v)
    return cfg
