"""The port's GroupNorm sites against the JAX package on the CPU, f32, on the
same seeded numpy inputs:

  * ``norm_affine_act`` / ``group_norm`` / ``group_norm_film`` against
    ``vdm4cdm_tpu/ops/norm.py`` (its XLA composition): 2e-5 absolute;
  * the ext-sums form against the Pallas ``fused_norm_affine_packed_ext`` and
    the pair form against ``fused_norm_affine_packed2``, both in interpret
    mode at a tiny packed shape (C=32, p=4): 2e-5 absolute, as the JAX
    package's own tests hold these kernels to its oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdm4cdm_tpu.ops import norm as jnorm
from vdm4cdm_tpu.ops.packed import pack, unpack, Packed
from vdm4cdm_tpu.ops.pallas import fused_norm as jfn

from vdm4cdm_torch.ops import norm
from vdm4cdm_torch.ops.kernels import gn_apply, gn_sums
from vdm4cdm_torch.ops.pair import Pair


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One thread for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ATOL = 2e-5
ZERO_SEED = jnp.zeros((1,), jnp.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _affine(seed, b, c):
    rng = np.random.default_rng(seed)
    a = (1.0 + 0.3 * rng.standard_normal((b, c))).astype(np.float32)
    bb = (0.2 * rng.standard_normal((b, c))).astype(np.float32)
    return a, bb


def _x(seed, shape, scale=1.5, shift=0.4):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape) + shift).astype(np.float32)


@pytest.mark.parametrize("act", [None, "silu"])
def test_norm_affine_act_matches_jax(act):
    x = _x(0, (2, 4, 4, 8, 32))
    a, b = _affine(1, 2, 32)
    want = np.asarray(jnorm.norm_affine_act(jnp.asarray(x), jnp.asarray(a),
                                            jnp.asarray(b), 8, act=act))
    got = norm.norm_affine_act(_t(x), _t(a), _t(b), 8, act=act)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_group_norm_and_film_match_jax():
    x = _x(2, (2, 4, 4, 4, 16))
    rng = np.random.default_rng(3)
    scale = (1 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(16)).astype(np.float32)
    fs, fsh = _affine(4, 2, 16)
    want = np.asarray(jnorm.group_norm(jnp.asarray(x), jnp.asarray(scale),
                                       jnp.asarray(bias), 4, act="silu"))
    got = norm.group_norm(_t(x), _t(scale), _t(bias), 4, act="silu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    want = np.asarray(jnorm.group_norm_film(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(fs - 1.0), jnp.asarray(fsh), 4))
    got = norm.group_norm_film(_t(x), _t(scale), _t(bias), _t(fs - 1.0),
                               _t(fsh), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("act", [None, "silu"])
def test_ext_sums_matches_pallas_ext(act):
    """Conv-emitted sums: the port folds per-channel sums (B, 2, C); the
    Pallas entry takes per-lane sums (B, 2, p*C) of the packed carrier."""
    C, p, G = 32, 4, 8
    x = _x(5, (2, 2, 4, 8, C))
    a, b = _affine(6, 2, C)
    xq = pack(jnp.asarray(x), p).flat_rows()
    lane_sums = jfn._run_sums(xq, True)
    want = jfn.fused_norm_affine_packed_ext(
        xq, jnp.asarray(a), jnp.asarray(b), ZERO_SEED, lane_sums, C, G, 1e-6,
        act, 0.0, None, True)
    want = np.asarray(want).reshape(x.shape)
    sums = np.asarray(lane_sums).reshape(2, 2, p, C).sum(2)
    # the port's sums pass agrees with the Pallas sums kernel
    np.testing.assert_allclose(gn_sums(_t(x).reshape(2, -1, C)).numpy(),
                               sums, rtol=1e-5, atol=1e-4)
    got = norm.norm_affine_act(_t(x), _t(a), _t(b), G, act=act,
                               ext_sums=_t(sums))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("act", [None, "silu"])
def test_pair_matches_pallas_pair(act):
    """Joint statistics over a lazy concat: Ca=32, Cb=16, groups=4 puts
    channels 24..35 in one group, straddling the boundary at 32."""
    Ca, Cb, p, G = 32, 16, 4, 4
    xa = _x(7, (2, 2, 4, 8, Ca), 1.3, 0.2)
    xb = _x(8, (2, 2, 4, 8, Cb), 0.7, -0.4)
    a, b = _affine(9, 2, Ca + Cb)
    pa, pb = pack(jnp.asarray(xa), p), pack(jnp.asarray(xb), p)
    ya, yb = jfn.fused_norm_affine_packed2(
        pa.flat_rows(), pb.flat_rows(), jnp.asarray(a), jnp.asarray(b),
        ZERO_SEED, Ca, Cb, G, 1e-6, act, 0.0, None, True)
    want_a = unpack(Packed(ya.reshape(pa.data.shape), pa.spatial, Ca, p))
    want_b = unpack(Packed(yb.reshape(pb.data.shape), pb.spatial, Cb, p))
    got = norm.norm_affine_act(Pair(_t(xa), _t(xb)), _t(a), _t(b), G,
                               act=act)
    assert isinstance(got, Pair)
    np.testing.assert_allclose(got.a.numpy(), np.asarray(want_a), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want_b), rtol=0,
                               atol=ATOL)
    # and the same as GroupNorm over the materialized concat
    joined = norm.norm_affine_act(_t(np.concatenate([xa, xb], -1)), _t(a),
                                  _t(b), G, act=act)
    np.testing.assert_allclose(torch.cat([got.a, got.b], -1).numpy(),
                               joined.numpy(), rtol=0, atol=ATOL)


def test_near_constant_group_no_nan():
    """mean^2 >> var: the f32 sum-based variance comes out negative
    (-0.5625 for this input, the JAX package's regression case) and must be
    clamped at 0 before the rsqrt."""
    rng = np.random.default_rng(0)
    x = (997.0 + 1e-4 * rng.standard_normal((2, 64, 16))).astype(np.float32)
    xt = _t(x).reshape(2, 1, 64, 1, 16)
    y = norm.group_norm(xt, torch.ones(16), torch.zeros(16), 4)
    assert torch.isfinite(y).all()
    yp = norm.group_norm(Pair(xt[..., :8].contiguous(),
                              xt[..., 8:].contiguous()),
                         torch.ones(16), torch.zeros(16), 4)
    assert torch.isfinite(yp.a).all() and torch.isfinite(yp.b).all()


def test_gn_kernel_wrappers_check_and_refuse():
    x = torch.zeros(2, 8, 16)
    a = torch.ones(2, 16)
    with pytest.raises(ValueError, match="needs an integer seed"):
        gn_apply(x, a, a, "silu", dropout_p=0.1)
    with pytest.raises(ValueError, match="shape"):
        gn_apply(x, torch.ones(2, 8), torch.ones(2, 8))
    with pytest.raises(RuntimeError, match="forward-only"):
        gn_sums(x.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="unknown act"):
        gn_apply(x, a, a, "gelu")
    before = (gn_sums.launches, gn_apply.launches)
    gn_apply(x, a, a)
    gn_sums(x)
    assert (gn_sums.launches, gn_apply.launches) == before
