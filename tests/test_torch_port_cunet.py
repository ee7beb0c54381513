"""The port's CUNet against the JAX CUNet on the CPU (f32): the same fully
randomized weights, converted by ``params_from_jax``, and the same seeded
numpy inputs. Tolerance: 1e-4 absolute on eps_hat (outputs are O(1); the two
frameworks differ only in f32 summation order, measured ~3e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import seeded_tree
from vdm4cdm_tpu.diffusion import VDM as JVDM
from vdm4cdm_tpu.diffusion import make_schedule as jmake_schedule
from vdm4cdm_tpu.models import CUNet as JCUNet
from vdm4cdm_tpu.models.cunet import timestep_embedding as jtimestep_embedding

import vdm4cdm_torch as vt
from vdm4cdm_torch.models.cunet import timestep_embedding

SHAPE = (1, 8, 8, 8)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The module's torch work is small; two threads keep it off the cores
    that the other test workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _kw(padding, mid_attn):
    return dict(shape=SHAPE, chs=(8, 16, 16, 16), s_conditioning_channels=1,
                v_conditioning_dims=(6,), norm_groups=4, mid_attn=mid_attn,
                dropout_prob=0.0, conv_padding_mode=padding)


def _pair(padding, mid_attn, seed=1):
    kw = _kw(padding, mid_attn)
    jv = JVDM(JCUNet(**kw), jmake_schedule("learned_linear", -13.3, 13.3))
    tree = seeded_tree(jv, seed)
    tv = vt.VDM(vt.CUNet(**kw, device="cpu"),
                vt.make_schedule("learned_linear", device="cpu"))
    tv.load_state_dict(vt.params_from_jax(tree, tv))
    return jv, tree, tv


def _inputs(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((batch, *SHAPE[1:], 1)).astype(np.float32)
    s = rng.standard_normal((batch, *SHAPE[1:], 1)).astype(np.float32)
    v = rng.standard_normal((batch, 6)).astype(np.float32)
    t = np.array([0.3, 0.8][:batch], np.float32)
    return z, s, v, t


@pytest.mark.parametrize("padding,mid_attn", [
    ("circular", False), ("circular", True), ("zeros", False),
    ("zeros", True)])
def test_eps_hat_matches_jax(padding, mid_attn):
    jv, tree, tv = _pair(padding, mid_attn)
    z, s, v, t = _inputs()
    want = np.asarray(jv.eps_hat(tree, jnp.asarray(z), jnp.asarray(t),
                                 jnp.asarray(s), [jnp.asarray(v)]))
    with torch.no_grad():
        got = tv.eps_hat(torch.from_numpy(z), torch.from_numpy(t),
                         torch.from_numpy(s), [torch.from_numpy(v)])
    assert got.dtype == torch.float32 and got.shape == want.shape
    # the randomized weights make eps_hat far from the zero-init identity
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_bf16_compute_tracks_f32():
    """compute_dtype=bfloat16 casts activations as the JAX module does; on
    the same weights it stays within bf16 rounding of the f32 result."""
    _, tree, tv = _pair("circular", False)
    kw = _kw("circular", False)
    tb = vt.VDM(vt.CUNet(**kw, compute_dtype=torch.bfloat16, device="cpu"),
                vt.make_schedule("learned_linear", device="cpu"))
    tb.load_state_dict(vt.params_from_jax(tree, tb))
    z, s, v, t = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        ref = tv.eps_hat(z, t, s, [v])
        got = tb.eps_hat(z, t, s, [v])
    assert got.dtype == torch.float32
    err = (got - ref).abs().max().item()
    assert err < 0.1 * ref.abs().max().item(), err


def test_timestep_embedding_matches_jax():
    """The angles t * f reach 1000 rad, where one f32 ulp of f (XLA's and
    torch's exp may differ by one) moves sin/cos by up to ~1e-4 * t * 8;
    1e-3 absolute states that."""
    t = np.array([0.0, 0.25, 0.999, 1.0], np.float32)
    for dim in (8, 9, 32):
        want = np.asarray(jtimestep_embedding(jnp.asarray(t), dim))
        got = timestep_embedding(torch.from_numpy(t), dim).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_params_from_jax_missing_key_raises():
    jv, tree, tv = _pair("zeros", True)
    del tree["unet"]["mid_attn"]["proj"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        vt.params_from_jax(tree, tv)


def test_params_from_jax_unused_key_raises():
    jv, tree, tv = _pair("zeros", False)
    tree["unet"]["down_0_0"]["extra"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(KeyError, match="unused"):
        vt.params_from_jax(tree, tv)
    with pytest.raises(KeyError, match="top-level"):
        vt.params_from_jax({"ema": {"w": np.zeros(1)}, **tree})


def test_fresh_model_is_zero_at_output():
    """conv_out and every ResBlock's second conv start at zero, as in the
    JAX module: eps_hat of a fresh model is exactly 0 (why every parity test
    randomizes all parameters first)."""
    net = vt.CUNet(**_kw("circular", True), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    z, s, v, t = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        assert net(z, t, s, [v]).abs().max().item() == 0.0
    assert net.down_0_0.Conv_1.kernel.abs().max().item() == 0.0
    assert net.mid_attn_block.proj.kernel.abs().max().item() == 0.0
