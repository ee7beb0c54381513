"""Shared CLI plumbing: counterpart of ``vdm4cdm_tpu/cli/_common.py``.

The device (``--device``; the CUDA card unless the caller names another, and
an error without one), the config overrides, and the guard that keeps the
sharded path out of the CLI until it is ported. There is no
validation-figure hook yet: it needs the evaluation modules (``evals/``).
"""

from __future__ import annotations

import ast


def add_device_arg(parser) -> None:
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device to run on (default: the CUDA card, and an error "
             "without one; 'cpu' runs the kernels' plain versions)")


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


def require_unsharded(cfg) -> None:
    """The sharded CLI (``parallel.n_data`` / ``n_sp`` > 1) is not ported
    yet; the sharded train step and samplers are, in
    ``vdm4cdm_torch.parallel``."""
    if cfg.parallel.needs_mesh:
        raise NotImplementedError(
            f"parallel.n_data={cfg.parallel.n_data} n_sp={cfg.parallel.n_sp}: "
            "the sharded CLI is not ported yet (ROADMAP.md, queue 1); run "
            "vdm4cdm_torch.parallel's sharded step under torch.distributed "
            "instead")
