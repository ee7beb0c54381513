"""The port's schedule and ancestral sampler against the JAX package on the
CPU, f32. The sampler's noise is injected from seeded numpy on both sides
(threefry streams cannot be reproduced in torch). Tolerances: schedule 1e-6
relative; ddnm coefficients and x0t 1e-5 relative + 1e-4 absolute; four
sampler steps 1e-3 relative + 1e-3 absolute: after only four steps from t=1
the fields are O(1e3), because x0t divides by alpha_1 ~ 1.3e-3, which also
amplifies the f32 eps_hat difference (~1e-6) by the same factor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import seeded_tree
from vdm4cdm_tpu.diffusion import VDM as JVDM
from vdm4cdm_tpu.diffusion import make_schedule as jmake_schedule
from vdm4cdm_tpu.diffusion.schedule import alpha_sigma as jalpha_sigma
from vdm4cdm_tpu.models import CUNet as JCUNet

import vdm4cdm_torch as vt
from vdm4cdm_torch.diffusion import alpha_sigma


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two threads for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


KW = dict(shape=(1, 8, 8, 8), chs=(8, 16, 16, 16), s_conditioning_channels=1,
          v_conditioning_dims=(6,), norm_groups=4, mid_attn=False,
          dropout_prob=0.0, conv_padding_mode="circular")


@pytest.fixture(scope="module")
def models():
    jv = JVDM(JCUNet(**KW), jmake_schedule("learned_linear", -13.3, 13.3))
    tree = seeded_tree(jv, 11)
    tv = vt.VDM(vt.CUNet(**KW, device="cpu"),
                vt.make_schedule("learned_linear", device="cpu"))
    tv.load_state_dict(vt.params_from_jax(tree, tv))
    rng = np.random.default_rng(12)
    s = rng.standard_normal((1, 8, 8, 8, 1)).astype(np.float32)
    v = rng.standard_normal((1, 6)).astype(np.float32)
    return jv, tree, tv, s, v


def test_schedule_matches_jax(models):
    jv, tree, tv, _, _ = models
    t = np.array([0.0, 0.1, 0.5, 0.97, 1.0], np.float32)
    g_want = np.asarray(jv.gamma(tree, jnp.asarray(t)))
    with torch.no_grad():
        g_got = tv.gamma(torch.from_numpy(t))
        a_got, s_got = alpha_sigma(g_got)
        gp_got = tv.schedule.gamma_prime(torch.from_numpy(t))
    a_want, s_want = jalpha_sigma(jnp.asarray(g_want))
    gp_want = jv.schedule.gamma_prime(tree["gamma"], jnp.asarray(t))
    np.testing.assert_allclose(g_got.numpy(), g_want, rtol=1e-6)
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_want), rtol=1e-6)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), rtol=1e-6)
    np.testing.assert_allclose(gp_got.numpy(), np.asarray(gp_want), rtol=1e-6)
    fixed = vt.make_schedule("fixed_linear", -5.0, 7.0)
    assert not list(fixed.parameters())
    np.testing.assert_allclose(fixed.gamma(0.25).item(), -2.0, rtol=1e-6)


def test_ddnm_coeffs_match_jax(models):
    jv, tree, tv, s, v = models
    zt = np.random.default_rng(13).standard_normal((1, 8, 8, 8, 1))
    zt = zt.astype(np.float32)
    want = jv.ddnm_coeffs(tree, jnp.asarray(zt), jnp.float32(0.6),
                          jnp.float32(0.55), jnp.asarray(s), [jnp.asarray(v)])
    with torch.no_grad():
        got = tv.ddnm_coeffs(torch.from_numpy(zt), 0.6, 0.55,
                             torch.from_numpy(s), [torch.from_numpy(v)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def test_sample_zt_given_zs_with_injected_eps(models):
    jv, tree, tv, _, _ = models
    rng = np.random.default_rng(14)
    zs = rng.standard_normal((1, 8, 8, 8, 1)).astype(np.float32)
    eps = rng.standard_normal(zs.shape).astype(np.float32)
    g_t = jv.gamma(tree, jnp.float32(0.7))
    g_s = jv.gamma(tree, jnp.float32(0.4))
    a_t, _ = jalpha_sigma(g_t)
    a_s, _ = jalpha_sigma(g_s)
    c = -jnp.expm1(g_s - g_t)
    want = (a_t / a_s) * zs + jnp.sqrt(jax.nn.sigmoid(g_t) * c) * eps
    with torch.no_grad():
        got = tv.sample_zt_given_zs(torch.from_numpy(zs), 0.7, 0.4,
                                    eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_draw_samples_with_injected_noise_matches_jax_loop(models):
    """Four ancestral steps from the same z_init and per-step eps: the port's
    draw_samples against a hand loop over the JAX package's ddnm_coeffs (the
    body of its lax.scan)."""
    jv, tree, tv, s, v = models
    n = 4
    rng = np.random.default_rng(15)
    z0 = rng.standard_normal((1, 8, 8, 8, 1)).astype(np.float32)
    eps = rng.standard_normal((n, 1, 8, 8, 8, 1)).astype(np.float32)
    steps = jnp.linspace(1.0, 0.0, n + 1)
    z = jnp.asarray(z0)
    for i in range(n):
        w_z, w_x0t, x0t, scale = jv.ddnm_coeffs(
            tree, z, steps[i], steps[i + 1], jnp.asarray(s), [jnp.asarray(v)])
        z = w_z * z + w_x0t * x0t + scale * jnp.asarray(eps[i])
    a0, _ = jalpha_sigma(jv.gamma(tree, jnp.float32(0.0)))
    want = np.asarray(z / a0)
    got = tv.draw_samples(batch_size=1, n_sampling_steps=n,
                          s_conditioning=torch.from_numpy(s),
                          v_conditionings=[torch.from_numpy(v)],
                          noise=(torch.from_numpy(z0), torch.from_numpy(eps)))
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_draw_samples_with_generator_is_reproducible(models):
    _, _, tv, s, v = models
    kw = dict(batch_size=1, n_sampling_steps=2,
              s_conditioning=torch.from_numpy(s),
              v_conditionings=[torch.from_numpy(v)])
    a = tv.draw_samples(torch.Generator().manual_seed(3), **kw)
    b = tv.draw_samples(torch.Generator().manual_seed(3), **kw)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="Generator"):
        tv.draw_samples(None, **kw)


def test_device_none_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vt.CUNet(**KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vt.make_schedule("learned_linear")
