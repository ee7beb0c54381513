"""Shared CLI plumbing: counterpart of ``vdm4cdm_tpu/cli/_common.py``.

The device (``--device``; the CUDA card unless the caller names another, and
an error without one), the config overrides, the model registry, the guard
that keeps the sharded path out of the CLI until it is ported, and the
validation-figure hook (the JAX function's unsharded branch).
"""

from __future__ import annotations

import ast
import contextlib


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
    ``cfg.run.n_figure_sampling_steps``, 100 when unset."""
    from ..evals import figures, spectra

    ndim = cfg.model.ndim
    is_sfm = cfg.model.family == "sfm"
    n_fig = 2
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
            if is_sfm:
                samples = model.draw_samples(
                    batch_n["x0"], n_sampling_steps=n_steps,
                    v_conditionings=v_conds)
            else:
                samples = model.draw_samples(
                    generator, batch_size=n, n_sampling_steps=n_steps,
                    s_conditioning=batch_n.get("conditioning"),
                    v_conditionings=v_conds)
        return figures.panel_data(batch_n, samples, sfm=is_sfm, **hooks)

    def draw(params, batch, generator):
        return figures.render(panel_data(params, batch, generator))

    draw.panel_data = panel_data
    return draw
