"""Shared CLI plumbing: counterpart of ``vdm4cdm_tpu/cli/_common.py``.

The device (``--device``; the CUDA card unless the caller names another, and
an error without one), the ``torch.distributed`` job of a sharded run and its
(data, sp) mesh, the config overrides, the model registry and the
validation-figure hook.

A sharded run (``parallel.n_data * parallel.n_sp`` > 1) is one process a rank,
started by ``torchrun`` (its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``) or by hand with the JAX CLI's three flags
(``--coordinator HOST:PORT --num-processes N --process-id R``), or inside a
job that already has its group (``parallel.launch.spawn_ranks``). Each rank
runs on ``cuda:LOCAL_RANK`` unless ``--device`` names its device. The backend
is ``--dist-backend``: NCCL by default on the card, gloo on the CPU; ranks
that share one card need gloo (NCCL refuses them), and the caller names it.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import os
from typing import Tuple

import torch


def add_device_arg(parser) -> None:
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device to run on (default: the CUDA card, and an error "
             "without one; 'cpu' runs the kernels' plain versions; a rank of "
             "a sharded run takes cuda:LOCAL_RANK)")


def add_dist_args(parser) -> None:
    """The flags of a sharded run's process (the JAX CLI's three, and the
    backend)."""
    parser.add_argument(
        "--coordinator", type=str, default=None, metavar="HOST:PORT",
        help="sharded run started by hand: rank 0's address, with "
             "--num-processes and --process-id (torchrun sets its own "
             "environment instead)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="sharded run started by hand: the ranks")
    parser.add_argument("--process-id", type=int, default=None,
                        help="sharded run started by hand: this rank")
    parser.add_argument(
        "--dist-backend", type=str, default=None, choices=["nccl", "gloo"],
        help="torch.distributed backend (default: nccl on the card, gloo on "
             "the CPU; ranks sharing one card need gloo)")


def init_distributed(args: argparse.Namespace
                     ) -> Tuple[torch.device, bool]:
    """This process's device, and whether it joined a ``torch.distributed``
    group here (the caller destroys that group at the end). The group comes
    from one of: a group this process already has (kept as it is; a
    ``--dist-backend`` that differs from its backend raises), the three
    flags (``tcp://HOST:PORT``), torchrun's environment (``env://``); with
    none of them the run has one process. A rank's device is ``--device``,
    else ``cuda:LOCAL_RANK`` (0 without the variable); nothing falls back to
    the CPU."""
    import torch.distributed as dist

    from .._device import resolve_device

    flags = (args.coordinator, args.num_processes, args.process_id)
    by_flags = any(f is not None for f in flags)
    if by_flags and any(f is None for f in flags):
        raise ValueError("a sharded run started by hand needs --coordinator, "
                         "--num-processes and --process-id together")
    by_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    joined = dist.is_available() and dist.is_initialized()
    if not (joined or by_flags or by_env):
        return resolve_device(args.device), False
    if args.device is not None:
        device = torch.device(args.device)
    else:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = args.dist_backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
    if joined:
        if args.dist_backend and dist.get_backend() != args.dist_backend:
            raise ValueError(f"--dist-backend {args.dist_backend}: this "
                             f"process's group runs {dist.get_backend()}")
        return device, False
    if by_flags:
        dist.init_process_group(
            backend, init_method=f"tcp://{args.coordinator}",
            rank=args.process_id, world_size=args.num_processes)
    else:
        dist.init_process_group(backend, init_method="env://")
    return device, True


def make_mesh_from_config(cfg):
    """The (data, sp) mesh of ``cfg.parallel`` over this job's ranks, or
    None for an unsharded run of one process. The job's world size must be
    ``n_data * n_sp``."""
    from ..parallel.shard import make_mesh, process_rank

    par = cfg.parallel
    world = process_rank()[1]
    if world != par.n_data * par.n_sp:
        raise ValueError(
            f"the job has {world} rank(s) but parallel.n_data * "
            f"parallel.n_sp = {par.n_data} * {par.n_sp} = "
            f"{par.n_data * par.n_sp}: start one process per rank of the "
            f"mesh (torchrun --nproc-per-node, or --num-processes)")
    if not par.needs_mesh:
        return None
    return make_mesh(n_data=par.n_data, n_sp=par.n_sp)


def parse_overrides(pairs):
    """``["sec.key=val", ...]`` -> {"sec.key": val}, each value read as a
    Python literal where it is one, else kept as a string."""
    out = {}
    for pair in pairs or []:
        key, _, val = pair.partition("=")
        try:
            out[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[key] = val
    return out


def apply_overrides(cfg, overrides: dict) -> None:
    for k, v in overrides.items():
        section, _, field = k.partition(".")
        setattr(getattr(cfg, section), field, v)


def read_registry(path: str) -> dict:
    """A model registry (``configs/models_torch.yaml``, or the JAX package's
    ``configs/models.yaml``): ``{name: {key: scalar}}``. Reads the block-YAML
    subset these files use (comments, a top-level key per model, indented
    ``key: value`` pairs, scalars read as Python literals, ``null`` /
    ``true`` / ``false``) without PyYAML, which the card's host lacks; a
    line outside that subset raises ``ValueError``."""
    words = {"null": None, "~": None, "true": True, "false": False}
    out: dict = {}
    entry = None
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            key, sep, val = line.strip().partition(":")
            val = val.strip()
            if not sep or not key:
                raise ValueError(f"{path}:{lineno}: not a 'key: value' line")
            if not line[0].isspace():
                if val:
                    raise ValueError(f"{path}:{lineno}: a model name takes "
                                     "an indented block")
                entry = out[key] = {}
            elif entry is None or not val:
                raise ValueError(f"{path}:{lineno}: nested blocks are not "
                                 "read here")
            elif val in words:
                entry[key] = words[val]
            else:
                try:
                    entry[key] = ast.literal_eval(val)
                except (ValueError, SyntaxError):
                    entry[key] = val
    return out


@contextlib.contextmanager
def swapped_params(model, params):
    """``model`` with the tensors of ``params`` (by parameter name, e.g. the
    EMA) as its parameters inside the block, its own after it."""
    named = dict(model.named_parameters())
    saved = {k: p.data for k, p in named.items()}
    try:
        for k, p in named.items():
            p.data = params[k]
        yield model
    finally:
        for k, p in named.items():
            p.data = saved[k]


def make_validation_figure_fn(cfg, model, dm):
    """The ``Trainer(draw_figure=...)`` hook: sample from the model with the
    given parameters and render the 2x3 validation panel (reference
    trainVDM3D_c_c...:91-112 wiring). ``draw.panel_data(params, batch,
    generator)`` computes the panel's arrays on the device without
    rendering (the card's host has no matplotlib). The sampling steps are
    ``cfg.run.n_figure_sampling_steps``, 100 when unset.

    Under ``cfg.parallel``'s mesh (the model built with this rank's
    ``ctx``, a 3D box or a 2D map split along its first spatial dim) it
    samples through the sharded samplers, as the JAX hook's mesh branch
    does: the batch is the global one, every rank enters the
    sampler (its collectives need them all), ``max(2, n_data)`` fields so
    that they split over the data ranks, and the gathered samples are
    rendered on rank 0 alone (the other ranks return None)."""
    from ..evals import figures, spectra
    from ..parallel import (make_sharded_sfm_sampler,
                            make_sharded_vdm_sampler, process_rank)

    ndim = cfg.model.ndim
    is_sfm = cfg.model.family == "sfm"
    sharded = cfg.parallel.needs_mesh
    n_fig = max(2, cfg.parallel.n_data)
    n_steps = cfg.run.n_figure_sampling_steps or 100
    unnorm = getattr(dm, "unnorm_func", None)

    def x_to_im(field):  # (C, *spatial) -> 2D image
        f = field[0]
        if ndim == 3:
            f = f[:, :, :32].sum(-1)
        return f

    def normed(field, i_channel):
        if unnorm is not None:
            field = unnorm(field, i_channel)
        return field / (field.sum() + 1e-12)

    def pk_plot(field, i_channel):
        ks, pks, _ = spectra.power(normed(field, i_channel)[None, None])
        return ks, pks

    def cc_plot(f1, f2, i_channel):
        ks, ccs = spectra.get_ccs(normed(f1, i_channel)[None, None],
                                  normed(f2, i_channel)[None, None])
        return ks[0], ccs[0]

    hooks = dict(x_to_im=x_to_im, conditioning_to_im=x_to_im,
                 conditioning_values_to_str=str, pk_func=pk_plot,
                 cc_func=cc_plot)

    def panel_data(params, batch, generator):
        n = min(n_fig, (batch["x1"] if is_sfm else batch["x"]).shape[0])
        batch_n = {k: (None if v is None else
                       [a[:n] for a in v] if isinstance(v, (list, tuple))
                       else v[:n]) for k, v in batch.items()}
        v_conds = batch_n.get("conditioning_values") or []
        with swapped_params(model, params):
            if is_sfm and sharded:
                samples = make_sharded_sfm_sampler(model, n_steps)(
                    batch_n["x0"], v_conds)
            elif is_sfm:
                samples = model.draw_samples(
                    batch_n["x0"], n_sampling_steps=n_steps,
                    v_conditionings=v_conds)
            elif sharded:
                samples = make_sharded_vdm_sampler(model, n, n_steps)(
                    generator, batch_n.get("conditioning"), v_conds)
            else:
                samples = model.draw_samples(
                    generator, batch_size=n, n_sampling_steps=n_steps,
                    s_conditioning=batch_n.get("conditioning"),
                    v_conditionings=v_conds)
        if sharded and process_rank()[0] != 0:
            return None
        return figures.panel_data(batch_n, samples, sfm=is_sfm, **hooks)

    def draw(params, batch, generator):
        data = panel_data(params, batch, generator)
        return None if data is None else figures.render(data)

    draw.panel_data = panel_data
    return draw
