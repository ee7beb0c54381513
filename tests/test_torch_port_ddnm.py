"""The port's ``ddnm_sample`` against the JAX package's on the CPU, f32, at a
small size (chs (8, 16), 8^3). The noise sequence is replayed from JAX's key
chain: z from the first split, then per outer step one re-noising key
followed by L_i + 1 eps keys, each split off the running key.

Tolerance: 1e-4 relative to max(1, max |ref|). The schedule here is narrow
(gamma in [-4, 4]) so that x0t = (z - sigma eps_hat) / alpha stays O(1): at
the flagship's +-13.3 the first steps divide by alpha_1 ~ 1e-3 and the f32
differences of the two frameworks' eps_hat are amplified a thousandfold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import seeded_tree
from vdm4cdm_tpu.diffusion import VDM as JVDM
from vdm4cdm_tpu.diffusion import ddnm_sample as jddnm_sample
from vdm4cdm_tpu.diffusion import make_schedule as jmake_schedule
from vdm4cdm_tpu.models import CUNet as JCUNet

import vdm4cdm_torch as vt


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two threads for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


KW = dict(shape=(1, 8, 8, 8), chs=(8, 16), s_conditioning_channels=1,
          v_conditioning_dims=(6,), norm_groups=4, mid_attn=False,
          dropout_prob=0.0, conv_padding_mode="circular")
N = 5
SHAPE = (1, 8, 8, 8, 1)


@pytest.fixture(scope="module")
def setup():
    jv = JVDM(JCUNet(**KW), jmake_schedule("fixed_linear", -4.0, 4.0))
    tree = seeded_tree(jv, 51)
    tv = vt.VDM(vt.CUNet(**KW, device="cpu"),
                vt.make_schedule("fixed_linear", -4.0, 4.0, device="cpu"))
    tv.load_state_dict(vt.params_from_jax(tree, tv), strict=False)
    rng = np.random.default_rng(52)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    s = rng.standard_normal(SHAPE).astype(np.float32)
    v = rng.standard_normal((1, 6)).astype(np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, :4] = 1.0
    return jv, tree, tv, x, s, v, mask


def _jax_noise(key, ls):
    """The normals ``ddnm_sample`` of the JAX package draws, in order."""
    key, rz = jax.random.split(key)
    out = [jax.random.normal(rz, SHAPE, jnp.float32)]
    for L in ls:
        key, k_renoise = jax.random.split(key)
        out.append(jax.random.normal(k_renoise, SHAPE, jnp.float32))
        for _ in range(L + 1):
            key, k_eps = jax.random.split(key)
            out.append(jax.random.normal(k_eps, SHAPE, jnp.float32))
    return [torch.from_numpy(np.array(a)) for a in out]


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("return_all", [False, True])
@pytest.mark.parametrize("l", [0, 2, np.array([0, 3, 1, 0, 2])],
                         ids=["l0", "l2", "l_array"])
def test_ddnm_sample_matches_jax(setup, l, return_all):
    jv, tree, tv, x, s, v, mask = setup
    jmask = jnp.asarray(mask)
    y = x * mask
    key = jax.random.PRNGKey(123)
    want = jddnm_sample(
        jv, jax.tree_util.tree_map(jnp.asarray, tree), key, jnp.asarray(y),
        lambda z: z * jmask, lambda z: z * jmask, n_sampling_steps=N, l=l,
        s_conditioning=jnp.asarray(s), v_conditionings=[jnp.asarray(v)],
        return_all=return_all)
    ls = np.minimum(np.full(N, l) if isinstance(l, int) else l, np.arange(N))
    noise = _jax_noise(key, ls.tolist())
    tmask = torch.from_numpy(mask)
    got = vt.ddnm_sample(
        tv, torch.from_numpy(y), lambda z: z * tmask, lambda z: z * tmask,
        n_sampling_steps=N, l=l, s_conditioning=torch.from_numpy(s),
        v_conditionings=[torch.from_numpy(v)], return_all=return_all,
        noise=iter(noise))
    assert got.shape == ((N,) + SHAPE if return_all else SHAPE)
    assert torch.isfinite(got).all() and not got.requires_grad
    _close(got.numpy(), want)


def test_consistency_with_the_measurement_and_generator_noise(setup):
    """A(x_hat) == y by construction of the projection, whatever the noise;
    a generator drives it and is reproducible."""
    _, _, tv, x, s, v, mask = setup
    tmask = torch.from_numpy(mask)
    A = AT = lambda z: z * tmask  # noqa: E731
    y = A(torch.from_numpy(x))
    kw = dict(n_sampling_steps=N, l=2, s_conditioning=torch.from_numpy(s),
              v_conditionings=[torch.from_numpy(v)])
    a = vt.ddnm_sample(tv, y, A, AT, generator=torch.Generator().manual_seed(1),
                       **kw)
    b = vt.ddnm_sample(tv, y, A, AT, generator=torch.Generator().manual_seed(1),
                       **kw)
    c = vt.ddnm_sample(tv, y, A, AT, generator=torch.Generator().manual_seed(2),
                       **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    for out in (a, c):
        assert (A(out) - y).abs().max().item() < 1e-5
    assert a[:, 4:].abs().max() > 0  # the hole is filled by the model


def test_argument_checks(setup):
    _, _, tv, x, _, _, mask = setup
    y = torch.from_numpy(x * mask)
    ident = lambda z: z  # noqa: E731
    with pytest.raises(ValueError, match="one entry per step"):
        vt.ddnm_sample(tv, y, ident, ident, n_sampling_steps=3, l=[1, 2],
                       generator=torch.Generator())
    with pytest.raises(ValueError, match="non-negative integers"):
        vt.ddnm_sample(tv, y, ident, ident, n_sampling_steps=2, l=[1, -1],
                       generator=torch.Generator())
    with pytest.raises(ValueError, match="Generator"):
        vt.ddnm_sample(tv, y, ident, ident, n_sampling_steps=2, l=0)
