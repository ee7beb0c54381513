"""One experiment config for every model family, dimension, conditioning and
resolution: counterpart of ``vdm4cdm_tpu/config.py`` (this package's own copy;
fields and defaults are the JAX package's, so a YAML file written by either
loads in both).

Conditioning nomenclature follows the reference script names ``{s}_{v}``:
  s in {uc, c}: spatial conditioning field absent/present
  v in {uc, c}: cosmological parameter vector absent/present
e.g. "c_c" = field-conditioned + parameter-conditioned (the flagship 3D task).

``build_model`` makes the port's :class:`VDM` or :class:`SFM` from a config;
``build_datamodule`` its GRF or CAMELS data module.
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


def build_model(cfg: ExperimentConfig, device=None, ctx=None,
                generator=None):
    """ExperimentConfig -> VDM or SFM with freshly initialized parameters on
    ``device`` (None = the CUDA card), drawn from ``generator`` (a CPU
    ``torch.Generator``; None = torch's global one). ``ctx`` (a
    :class:`~vdm4cdm_torch.parallel.halo.ShardCtx` of this rank, None =
    unsharded) splits the UNet over ``cfg.parallel``'s mesh, whose sizes it
    must match; the model then works on this rank's slab."""
    import torch

    from .diffusion import VDM, make_schedule
    from .flows import SFM
    from .models import CUNet
    from .parallel.halo import NO_SHARD

    ctx = NO_SHARD if ctx is None else ctx
    par = cfg.parallel
    if (ctx.data_size, ctx.size) != (par.n_data, par.n_sp):
        raise ValueError(f"ctx mesh {ctx.data_size} x {ctx.size} is not "
                         f"cfg.parallel's {par.n_data} x {par.n_sp}")
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
        generator=generator,
        ctx=ctx,
    )
    if m.family == "vdm":
        return VDM(net, make_schedule(m.noise_schedule, m.gamma_min,
                                      m.gamma_max, device=device))
    return SFM(net, sigma=m.sfm_sigma)


def build_datamodule(cfg: ExperimentConfig, stage: str = "fit"):
    """The config's data module: GRF (synthetic) or CAMELS from the
    registry, for ``stage`` "fit" or "test". Under ``torch.distributed`` a
    CAMELS "fit" module serves the rows of each global batch that this
    process's data index selects (``cfg.parallel``'s mesh: rank = data
    index * n_sp + sp index), and the trainer's feed takes its ``sp``
    index's planes of them; a "test" module, and GRF at every stage, serve
    the whole batch on every rank (the GRF stream is one sequence: each rank
    draws all of it and the feed keeps its slab)."""
    d, m = cfg.data, cfg.model
    if d.kind == "grf":
        from .data.grf import GRFDataModule

        return GRFDataModule(
            size=d.cropsize,
            ndim=m.ndim,
            batch_size=d.batch_size,
            n_conditioning_values=d.conditioning_values,
            mode=m.family,
            slope=d.grf_slope,
            seed=cfg.run.seed,
        )
    from .data.camels import get_dataset, sfm_return_func, vdm_cc_return_func

    if d.in_field:
        channel_names = [d.in_field, d.out_field]
        return_func = sfm_return_func if m.family == "sfm" else vdm_cc_return_func
    else:
        channel_names = [d.out_field]
        return_func = None  # default: unconditional x
    from .parallel.shard import data_process

    index, count = (data_process(cfg.parallel.n_sp) if stage == "fit"
                    else (0, 1))
    return get_dataset(
        registry_dir=d.registry_dir,
        dataset_name=d.dataset_name,
        suite_name=d.suite_name,
        set_name=d.set_name,
        z_name=d.z_name,
        channel_names=channel_names,
        return_func=return_func,
        stage=stage,
        batch_size=d.batch_size,
        cropsize=d.cropsize,
        ndim=m.ndim,
        num_workers=d.num_workers,
        mmap=d.mmap,
        data_root=d.data_root,
        seed=cfg.run.seed,
        process_index=index,
        process_count=count,
    )
