"""The blessed model (``VDM_GRF_c_c_32``, step 20000) in the port.

The repository's one trained model is an orbax directory of the JAX package
(``configs/models.yaml``). ``vdm4cdm_torch/interop/blessed.py`` converts it
into a checkpoint of the port's own format, which is committed at
``blessed/VDM_GRF_c_c_32/torch/20000/checkpoint.pt`` and registered in
``configs/models_torch.yaml``. Run this file as a script to rewrite it:

    python tests/test_torch_port_blessed.py

It reads the orbax step with the JAX package's ``load_params`` (the port
cannot read orbax) and writes its EMA weights, the ones generation samples
(``load_params(prefer_ema=True)`` in both packages), as the checkpoint's
``ema_params``; its ``params`` are None (the raw weights are left out, which
keeps the committed file at 14 MB), so ``load_params(prefer_ema=False)``
refuses the file instead of handing out EMA weights as raw ones.

Tier-1 checks: every tensor of the committed file is bit-equal to a fresh
conversion (the test fails, not skips, when the orbax step exists but will
not convert or differs); both registries read as PyYAML reads them; the
converted model's ``eps_hat`` equals the JAX package's on the blessed EMA
weights within 1e-4 of max(1, max |ref|) (f32 sums in another order); three
ancestral steps with the same injected noise within 1e-3 relative + 1e-3
absolute (x0t divides by alpha_1, which amplifies the f32 difference); and
``cli.generate VDM_GRF_c_c_32`` finds the checkpoint from the name alone.

The sampling gate (slow, as ``tests/test_acceptance.py``'s): 2 boxes x 4
reps, 100 steps, through the port's sampler and
``vdm4cdm_torch/evals/acceptance.py``, with the JAX gate's constants: mean P(k) ratio in [0.5, 2.0] at every k, log-PDF overlap >= 0.25,
low-k r(k) >= 0.7, posterior spread > 5% of the field std, and DDNM (50
steps, l = 3) consistency < 1e-4 with r > 0.5 in the hole.
"""

import os
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # as a script: the repository's packages
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from vdm4cdm_tpu import config as jconfig  # noqa: E402
from vdm4cdm_tpu import presets as jpresets  # noqa: E402
from vdm4cdm_tpu.diffusion.schedule import alpha_sigma as jalpha_sigma  # noqa: E402
from vdm4cdm_tpu.train.checkpoint import load_params as jload_params  # noqa: E402

import vdm4cdm_torch as vt  # noqa: E402
from vdm4cdm_torch.cli import generate  # noqa: E402
from vdm4cdm_torch.cli._common import read_registry  # noqa: E402
from vdm4cdm_torch.evals.acceptance import (ddnm_statistics,  # noqa: E402
                                             gate_passes, gate_statistics)
from vdm4cdm_torch.interop.blessed import (converted_payload,  # noqa: E402
                                           write_converted)
from vdm4cdm_torch.train.checkpoint import (CheckpointManager,  # noqa: E402
                                            load_params, read_checkpoint)

NAME = "VDM_GRF_c_c_32"
JAX_REGISTRY = ROOT / "configs" / "models.yaml"
TORCH_REGISTRY = ROOT / "configs" / "models_torch.yaml"
N_BOXES, N_REPS, N_SAMPLING_STEPS = 2, 4, 100


def _entry(registry):
    return read_registry(str(registry))[NAME]


def orbax_trees():
    """(step, params, ema_params) of the blessed orbax step, numpy trees
    (JAX package); None when the step is not in this checkout."""
    entry = _entry(JAX_REGISTRY)
    step = entry["ckpt_step"]
    directory = ROOT / entry["ckpt_dir"]
    if not (directory / str(step)).is_dir():
        return None
    trees = [jax.tree_util.tree_map(
        np.asarray, jload_params(str(directory), None, step=step,
                                 prefer_ema=ema)) for ema in (False, True)]
    return (step, *trees)


def _model(size=32):
    cfg = vt.preset(NAME, **{"data.cropsize": size})
    return vt.build_model(cfg, device="cpu")


def write():
    """Rewrite the committed checkpoint from the orbax step."""
    found = orbax_trees()
    if found is None:
        sys.exit("the blessed orbax step is not in this checkout")
    step, _, ema = found
    directory = ROOT / _entry(TORCH_REGISTRY)["ckpt_dir"]
    path = write_converted(str(directory), step, None, ema, _model())
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trees():
    found = orbax_trees()
    if found is None:
        pytest.skip(f"{NAME}'s orbax step is not in this checkout")
    return found


@pytest.fixture(scope="module")
def blessed(trees):
    """(port model on the CPU with the committed EMA weights, JAX model,
    JAX EMA tree)."""
    entry = _entry(TORCH_REGISTRY)
    model = _model()
    load_params(str(ROOT / entry["ckpt_dir"]), model,
                step=entry["ckpt_step"])
    model.eval()
    jmodel = jconfig.build_model(jpresets.preset(NAME))
    return model, jmodel, trees[2]


def test_committed_checkpoint_is_bit_equal_to_a_fresh_conversion(trees):
    step, params, ema = trees
    entry = _entry(TORCH_REGISTRY)
    assert entry["ckpt_step"] == step == 20000
    got = read_checkpoint(str(ROOT / entry["ckpt_dir"]), step)
    want = converted_payload(step, None, ema, _model())
    assert got["format"] == want["format"] and got["step"] == step
    assert got["opt_state"] is None and got["params"] is None
    assert set(got["ema_params"]) == set(want["ema_params"])
    for name, t in want["ema_params"].items():
        g = got["ema_params"][name]
        assert g.dtype == t.dtype == torch.float32, name
        assert torch.equal(g, t), f"ema_params.{name} differs"
    # they are the EMA weights, not the raw parameters
    raw = converted_payload(step, params)["params"]
    assert not all(torch.equal(got["ema_params"][k], raw[k]) for k in raw)


def test_the_ema_only_checkpoint_is_not_read_as_raw_params():
    entry = _entry(TORCH_REGISTRY)
    directory = str(ROOT / entry["ckpt_dir"])
    assert set(load_params(directory)) == set(dict(_model().named_parameters()))
    with pytest.raises(ValueError, match="EMA weights alone"):
        load_params(directory, prefer_ema=False)
    with pytest.raises(ValueError, match="does not resume a run"):
        CheckpointManager(directory).restore(None)


def test_registries_read_as_yaml_reads_them():
    for path in (JAX_REGISTRY, TORCH_REGISTRY):
        with open(path) as f:
            assert read_registry(str(path)) == yaml.safe_load(f)
    assert _entry(TORCH_REGISTRY) == {
        "preset": NAME, "ckpt_dir": "blessed/VDM_GRF_c_c_32/torch",
        "ckpt_step": 20000}


def test_registry_reader_rejects_what_it_does_not_read(tmp_path):
    bad = tmp_path / "r.yaml"
    bad.write_text("m:\n  overrides:\n    data.cropsize: 8\n")
    with pytest.raises(ValueError, match="nested"):
        read_registry(str(bad))
    bad.write_text("m: 3\n")
    with pytest.raises(ValueError, match="indented block"):
        read_registry(str(bad))


def _inputs(size, batch, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((batch, size, size, size, 1)).astype(np.float32)
    s = rng.standard_normal(z.shape).astype(np.float32)
    v = rng.standard_normal((batch, 6)).astype(np.float32)
    return z, s, v


def test_eps_hat_matches_jax_on_the_blessed_weights(blessed):
    model, jmodel, ema = blessed
    z, s, v = _inputs(32, 2, 51)
    t = np.array([0.3, 0.8], np.float32)
    want = np.asarray(jax.jit(
        lambda p, z, t, s, v: jmodel.eps_hat(p, z, t, s, [v]))(
            ema, z, t, s, v))
    with torch.no_grad():
        got = model.eps_hat(torch.from_numpy(z), torch.from_numpy(t),
                            torch.from_numpy(s), [torch.from_numpy(v)])
    err = np.abs(got.numpy() - want).max() / max(1.0, np.abs(want).max())
    assert err <= 1e-4, err


def test_three_sampler_steps_match_jax(blessed):
    """Three ancestral steps from the same z_init and per-step eps: the
    port's draw_samples against a loop over the JAX package's
    ddnm_coeffs (the body of its sampler's scan)."""
    model, jmodel, ema = blessed
    n = 3
    z0, s, v = _inputs(32, 1, 52)
    eps = np.random.default_rng(53).standard_normal((n,) + z0.shape)
    eps = eps.astype(np.float32)
    coeffs = jax.jit(lambda p, z, t, u, s, v: jmodel.ddnm_coeffs(
        p, z, t, u, s, [v]))
    steps = np.linspace(1.0, 0.0, n + 1).astype(np.float32)
    z = jnp.asarray(z0)
    for i in range(n):
        w_z, w_x0t, x0t, scale = coeffs(ema, z, steps[i], steps[i + 1], s, v)
        z = w_z * z + w_x0t * x0t + scale * eps[i]
    a0, _ = jalpha_sigma(jmodel.gamma(ema, jnp.float32(0.0)))
    want = np.asarray(z / a0)
    got = model.draw_samples(
        batch_size=1, n_sampling_steps=n, s_conditioning=torch.from_numpy(s),
        v_conditionings=[torch.from_numpy(v)],
        noise=(torch.from_numpy(z0), torch.from_numpy(eps)))
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_generate_finds_the_blessed_model_by_name(blessed, tmp_path,
                                                  monkeypatch):
    """``cli.generate VDM_GRF_c_c_32`` with no --ckpt-dir: the port's
    registry gives the checkpoint (at an 8^3 crop here, to keep it cheap:
    the convolutions do not depend on the crop)."""
    monkeypatch.chdir(ROOT)  # the registry's ckpt_dir is relative to it
    out = tmp_path / "g"
    assert generate.main([NAME, str(out), "CV_12_12", "--device", "cpu",
                          "--n-sampling-steps", "2", "--reps-per-batch", "12",
                          "--set", "data.cropsize=8"]) == 0
    files = sorted(p.name for p in out.iterdir())
    assert files == sorted(f"gen_{i}.npy" for i in range(12))
    a = np.load(out / "gen_0.npy")
    assert a.shape == (12, 1, 8, 8, 8) and np.isfinite(a).all()


# ------------------------------------------------- the sampling gate (slow)

def test_gate_statistics_match_the_jax_gate_arithmetic():
    """``evals/acceptance.py`` against ``tests/test_acceptance.py``'s
    formulas over the JAX package's spectra, on seeded 16^3 fields: 2 boxes
    x 3 reps, samples = box + noise (r(k) near 1 at low k)."""
    from vdm4cdm_tpu.evals import spectra as jspectra

    rng = np.random.default_rng(71)
    gt = rng.standard_normal((2, 1, 16, 16, 16)).astype(np.float32)
    gen = (np.repeat(gt, 3, axis=0) + 0.5 * rng.standard_normal(
        (6, 1, 16, 16, 16))).astype(np.float32)
    got = gate_statistics(torch.from_numpy(gen), torch.from_numpy(gt), 3)
    _, pk_gen, _ = jspectra.power(jnp.asarray(gen))
    _, pk_gt, _ = jspectra.power(jnp.asarray(gt))
    np.testing.assert_allclose(got["pk_ratio"], np.asarray(pk_gen / pk_gt),
                               rtol=1e-5)
    bins = np.linspace(-4.0, 4.0, 51)
    h_gen, _ = np.histogram(gen, bins=bins, density=True)
    h_gt, _ = np.histogram(gt, bins=bins, density=True)
    overlap = 1.0 - 0.5 * np.abs(h_gen - h_gt).sum() * (bins[1] - bins[0])
    assert got["overlap"] == pytest.approx(overlap, rel=1e-12)
    _, ccs = jspectra.get_ccs(jnp.asarray(gen),
                              jnp.asarray(np.repeat(gt, 3, axis=0)))
    ccs = np.asarray(ccs)
    np.testing.assert_allclose(
        got["low_k_r"], ccs[:, :max(1, ccs.shape[-1] // 4)].mean(axis=1),
        rtol=1e-5)
    g = gen.reshape(2, 3, *gen.shape[1:])
    assert got["spread_over_std"] == pytest.approx(
        g.std(axis=1).mean() / gen.std(), rel=1e-6)
    assert gate_passes(got) == {"pk_ratio": True, "overlap": True,
                                "low_k_r": True, "spread_over_std": True}
    assert gate_passes({"pk_ratio": np.array([0.4, 1.0]),
                        "ddnm_consistency": 2e-4}) == {
        "pk_ratio": False, "ddnm_consistency": False}


@pytest.fixture(scope="module")
def gate_samples(blessed):
    model = blessed[0]
    dm = vt.build_datamodule(vt.preset(NAME), stage="test")
    gens, gts = [], []
    for i, batch in enumerate(dm.test_dataloader()):
        if i >= N_BOXES:
            break
        cond = torch.from_numpy(batch["conditioning"][:1])
        v = [torch.from_numpy(a[:1]).expand(N_REPS, -1)
             for a in batch["conditioning_values"]]
        gen = model.draw_samples(
            torch.Generator().manual_seed(1000 + i), batch_size=N_REPS,
            n_sampling_steps=N_SAMPLING_STEPS,
            s_conditioning=cond.expand(N_REPS, -1, -1, -1, -1),
            v_conditionings=v)
        gens.append(np.moveaxis(gen.numpy(), -1, 1))
        gts.append(np.moveaxis(batch["x"][:1], -1, 1))
    return (np.concatenate(gens).astype(np.float32),
            np.concatenate(gts).astype(np.float32), dm)


@pytest.mark.slow
def test_sampling_gate(gate_samples):
    gen, gt, _ = gate_samples
    st = gate_statistics(torch.from_numpy(gen), torch.from_numpy(gt), N_REPS)
    assert gate_passes(st) == dict.fromkeys(st, True), st


@pytest.mark.slow
def test_ddnm_gate(blessed, gate_samples):
    model = blessed[0]
    dm = gate_samples[2]
    batch = next(iter(dm.test_dataloader()))
    x = torch.from_numpy(batch["x"][:1])
    mask = torch.zeros_like(x)
    mask[:, : x.shape[1] // 2] = 1.0

    def A(z):
        return z * mask

    y = A(x)
    x_hat = vt.ddnm_sample(
        model, y, A, A, n_sampling_steps=50, l=3,
        s_conditioning=torch.from_numpy(batch["conditioning"][:1]),
        v_conditionings=[torch.from_numpy(a[:1])
                         for a in batch["conditioning_values"]],
        generator=torch.Generator().manual_seed(123))
    st = ddnm_statistics(x_hat, x, mask)
    assert gate_passes(st) == dict.fromkeys(st, True), st


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write()
