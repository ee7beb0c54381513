"""One experiment config for every model family, dimension, conditioning and
resolution: counterpart of ``vdm4cdm_tpu/config.py`` (this package's own copy;
fields and defaults are the JAX package's, so a YAML file written by either
loads in both).

Conditioning nomenclature follows the reference script names ``{s}_{v}``:
  s in {uc, c}: spatial conditioning field absent/present
  v in {uc, c}: cosmological parameter vector absent/present
e.g. "c_c" = field-conditioned + parameter-conditioned (the flagship 3D task).

``build_model`` makes the port's :class:`VDM` or :class:`SFM` from a config.
The data side (``build_datamodule``) comes with the data modules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class ModelConfig:
    family: str = "vdm"  # "vdm" | "sfm"
    ndim: int = 3
    input_channels: int = 1
    chs: Sequence[int] = (32, 64, 128, 256)
    norm_groups: int = 8
    mid_attn: bool = False
    n_attention_heads: int = 4
    dropout_prob: float = 0.1
    num_res_blocks: int = 2
    # vdm
    noise_schedule: str = "learned_linear"
    gamma_min: float = -13.3
    gamma_max: float = 13.3
    # sfm
    sfm_sigma: float = 0.0
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    remat: bool = False  # rematerialize ResBlocks
    # Block-granular remat (overrides nothing; adds to `remat`): names of
    # specific ResBlocks to rematerialize, e.g. ("down_0_0", "down_0_1",
    # "up_0_1", "up_0_2"): the cheapest memory/recompute tradeoff when a
    # step misses the device memory by little
    remat_blocks: tuple = ()


@dataclasses.dataclass
class DataConfig:
    kind: str = "camels"  # "camels" | "grf"
    registry_dir: str = "configs/registries"
    data_root: Optional[str] = None
    dataset_name: str = "CMD"
    suite_name: str = "Astrid"
    set_name: str = "LH"
    z_name: str = "z_0.0"
    in_field: Optional[str] = "Mstar"  # None => unconditional in s
    out_field: str = "Mcdm"
    cropsize: int = 256
    batch_size: int = 2
    conditioning_values: int = 6  # 0 => no v conditioning
    num_workers: int = 8
    mmap: bool = True
    # grf-only
    grf_slope: float = -2.0


@dataclasses.dataclass
class ParallelConfig:
    n_data: int = 1
    n_sp: int = 1

    @property
    def needs_mesh(self) -> bool:
        return self.n_data * self.n_sp > 1


@dataclasses.dataclass
class RunConfig:
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
    out_dir: str = "./runs"
    experiment_name: str = "run"
    resume: bool = True
    warm_start_ckpt: Optional[str] = None  # load params from another run
    # Sampling steps for validation figures. None = auto: 100 (a cost choice:
    # the reference's notebook validation draws use 250, but a 250-step draw
    # per validation pass dominates training wall time at 3D scale). An
    # explicit value is honored exactly.
    n_figure_sampling_steps: Optional[int] = None
    ema_decay: float = 0.0  # >0 tracks an EMA of params; sampling prefers it


@dataclasses.dataclass
class ExperimentConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)

    @property
    def conditioning_tag(self) -> str:
        s = "c" if self.data.in_field else "uc"
        v = "c" if self.data.conditioning_values else "uc"
        return f"{s}_{v}"

    # -------------------------------------------------------------- (de)serialize
    def to_dict(self) -> dict:
        import json

        # json round-trip normalizes tuples to lists so to_dict(load(save(x)))
        # == to_dict(x)
        return json.loads(json.dumps(dataclasses.asdict(self)))

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        return cls(
            model=ModelConfig(**d.get("model", {})),
            data=DataConfig(**d.get("data", {})),
            parallel=ParallelConfig(**d.get("parallel", {})),
            run=RunConfig(**d.get("run", {})),
        )

    def save(self, path: str):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))


def build_model(cfg: ExperimentConfig, device=None):
    """ExperimentConfig -> VDM or SFM with freshly initialized parameters on
    ``device`` (None = the CUDA card)."""
    import torch

    from .diffusion import VDM, make_schedule
    from .flows import SFM
    from .models import CUNet

    m, d = cfg.model, cfg.data
    if m.family not in ("vdm", "sfm"):
        raise ValueError(f"unknown model family {m.family!r}")
    shape = (m.input_channels,) + (d.cropsize,) * m.ndim
    bf16 = m.compute_dtype == "bfloat16"
    net = CUNet(
        shape=shape,
        chs=tuple(m.chs),
        s_conditioning_channels=1 if d.in_field else 0,
        v_conditioning_dims=((d.conditioning_values,)
                             if d.conditioning_values else ()),
        t_conditioning=True,
        norm_groups=m.norm_groups,
        mid_attn=m.mid_attn,
        n_attention_heads=m.n_attention_heads,
        dropout_prob=m.dropout_prob,
        num_res_blocks=m.num_res_blocks,
        remat=m.remat,
        remat_blocks=tuple(m.remat_blocks),
        # periodic boxes train full-size with circular padding; crops use
        # zeros (circular iff cropsize == 256)
        conv_padding_mode=("circular" if d.cropsize == 256 or d.kind == "grf"
                           else "zeros"),
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        device=device,
    )
    if m.family == "vdm":
        return VDM(net, make_schedule(m.noise_schedule, m.gamma_min,
                                      m.gamma_max, device=device))
    return SFM(net, sigma=m.sfm_sigma)
