"""The backward of the port's GroupNorm sites (the ``NormAffineAct`` Function
on its plain CPU path: ``gn_bwd_sums`` -> finalize -> ``gn_bwd_apply``)
against ``jax.grad`` of the JAX package's ``ops/norm.norm_affine_act`` (its
XLA composition) at p = 0, f32, on the same seeded numpy inputs: plain, FiLM,
conv-emitted sums and a skip join whose group straddles the boundary.
Tolerance 1e-4 relative to max(1, max |ref|) (sums over a few hundred f32
terms in another order; dx is a difference of terms larger than itself).
Then ``torch.autograd.gradcheck`` of the Function in f64 (the plain versions
compute in f32, so eps 1e-2 with 2e-2 tolerance), and the kernels' plain
versions against the Pallas ``_run_bwd_sums`` / ``_run_bwd_apply`` in
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdm4cdm_tpu.ops import norm as jnorm
from vdm4cdm_tpu.ops.packed import pack
from vdm4cdm_tpu.ops.pallas import fused_norm as jfn

from vdm4cdm_torch.ops import norm
from vdm4cdm_torch.ops.kernels import (gn_bwd_apply, gn_bwd_sums, gn_sums)
from vdm4cdm_torch.ops.pair import Pair


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One thread for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _inputs(seed, shape, c):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal(shape + (c,)) + 0.4).astype(np.float32)
    a = (1.0 + 0.3 * rng.standard_normal((shape[0], c))).astype(np.float32)
    b = (0.2 * rng.standard_normal((shape[0], c))).astype(np.float32)
    ct = rng.standard_normal(shape + (c,)).astype(np.float32)
    return x, a, b, ct


def _jax_grads(x, a, b, ct, groups, act):
    return jax.grad(
        lambda x, a, b: jnp.sum(jnorm.norm_affine_act(x, a, b, groups,
                                                      act=act) * ct),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))


@pytest.mark.parametrize("act", [None, "silu"])
def test_dx_da_db_match_jax_grad(act):
    x, a, b, ct = _inputs(0, (2, 4, 4, 8), 32)
    want = _jax_grads(x, a, b, ct, 8, act)
    xt, at, bt = _t(x, True), _t(a, True), _t(b, True)
    y = norm.norm_affine_act(xt, at, bt, 8, act=act)
    (y * _t(ct)).sum().backward()
    for got, ref in zip((xt.grad, at.grad, bt.grad), want):
        _close(got, ref)


def test_film_site_grads_match_jax_grad():
    """gamma, beta and FiLM get their gradients from autograd through the
    (B, C) ops around the Function."""
    x, fs, fsh, ct = _inputs(1, (2, 4, 4, 4), 16)
    rng = np.random.default_rng(2)
    scale = (1 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(16)).astype(np.float32)
    args = (x, scale, bias, fs - 1.0, fsh)
    want = jax.grad(
        lambda *p: jnp.sum(jnorm.group_norm_film(*p, 4) * ct),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ts = [_t(v, True) for v in args]
    (norm.group_norm_film(*ts, 4) * _t(ct)).sum().backward()
    for t, ref in zip(ts, want):
        _close(t.grad, ref)


@pytest.mark.parametrize("act", [None, "silu"])
def test_ext_sums_site_matches_jax_grad_and_sums_get_none(act):
    x, a, b, ct = _inputs(3, (2, 2, 4, 8), 32)
    want = _jax_grads(x, a, b, ct, 8, act)
    xt, at, bt = _t(x, True), _t(a, True), _t(b, True)
    with torch.no_grad():
        sums = gn_sums(xt.reshape(2, -1, 32))
    sums.requires_grad_(True)
    y = norm.norm_affine_act(xt, at, bt, 8, act=act, ext_sums=sums)
    (y * _t(ct)).sum().backward()
    for got, ref in zip((xt.grad, at.grad, bt.grad), want):
        _close(got, ref)
    assert sums.grad is None


@pytest.mark.parametrize("act", [None, "silu"])
def test_straddling_pair_matches_jax_grad_on_the_concat(act):
    """Ca=32, Cb=16, groups=4: channels 24..35 form one group across the
    boundary, so the backward's group means join both halves' sums."""
    ca, cb = 32, 16
    x, a, b, ct = _inputs(4, (2, 2, 4, 8), ca + cb)
    want = _jax_grads(x, a, b, ct, 4, act)
    xa, xb = _t(x[..., :ca], True), _t(x[..., ca:], True)
    at, bt = _t(a, True), _t(b, True)
    y = norm.norm_affine_act(Pair(xa, xb), at, bt, 4, act=act)
    ctt = _t(ct)
    ((y.a * ctt[..., :ca]).sum() + (y.b * ctt[..., ca:]).sum()).backward()
    _close(torch.cat([xa.grad, xb.grad], -1), want[0])
    _close(at.grad, want[1])
    _close(bt.grad, want[2])


def test_unused_half_gets_a_zero_output_gradient():
    x, a, b, ct = _inputs(5, (1, 2, 2, 4), 16)
    xa, xb = _t(x[..., :8], True), _t(x[..., 8:], True)
    y = norm.norm_affine_act(Pair(xa, xb), _t(a), _t(b), 2, act="silu")
    y.a.sum().backward()
    assert torch.isfinite(xa.grad).all() and torch.isfinite(xb.grad).all()
    # group 0 is channels 0..7: the second half is its own group, so it gets
    # exactly no gradient from the first half's output
    assert xb.grad.abs().max().item() == 0.0


@pytest.mark.parametrize("act", [None, "silu"])
def test_gradcheck_in_f64(act):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 2, 2, 2, 8))).requires_grad_()
    a = torch.from_numpy(1 + 0.3 * rng.standard_normal((1, 8))).requires_grad_()
    b = torch.from_numpy(0.2 * rng.standard_normal((1, 8))).requires_grad_()

    def fn(x, a, b):
        return norm.norm_affine_act(x.float(), a.float(), b.float(), 2,
                                    act=act).double()

    assert torch.autograd.gradcheck(fn, (x, a, b), eps=1e-2, atol=2e-2,
                                    rtol=2e-2)


@pytest.mark.parametrize("act", [None, "silu"])
def test_bwd_kernels_plain_versions_match_pallas_split_kernels(act):
    """``gn_bwd_sums`` / ``gn_bwd_apply`` against the TPU kernels they
    replace (``_run_bwd_sums`` / ``_run_bwd_apply`` on the packed carrier,
    interpret mode, p = 0): per-lane sums fold to per-channel sums."""
    C, p, G = 32, 4, 8
    x, a, b, ct = _inputs(7, (2, 2, 4, 8), C)
    xq = pack(jnp.asarray(x), p).flat_rows()
    ctq = pack(jnp.asarray(ct), p).flat_rows()
    count = float(xq.shape[1] * xq.shape[2] // G)
    stats = jfn._finalize_stats(jfn._run_sums(xq, True), C, G, 1e-6, count)
    tile = lambda v: jnp.tile(jnp.asarray(v), (1, p))[:, None, :]  # noqa: E731
    seed = jnp.zeros((1,), jnp.int32)
    lane_sums = jfn._run_bwd_sums(xq, ctq, stats, tile(a), tile(b), seed,
                                  act=act, dropout_p=0.0, interpret=True)
    m = jfn._group_means(lane_sums, jnp.tile(jnp.asarray(a), (1, p)), C, G,
                         count)
    dxq = jfn._run_bwd_apply(xq, ctq, stats, m, tile(a), tile(b), seed,
                             act=act, dropout_p=0.0, interpret=True)
    want_sums = np.asarray(lane_sums).reshape(2, 2, p, C).sum(2)
    want_dx = np.asarray(dxq).reshape(x.shape)
    mean = _t(np.asarray(stats)[:, 0, :C])
    inv = _t(np.asarray(stats)[:, 1, :C])
    m1 = _t(np.asarray(m)[:, 0, :C])
    m2 = _t(np.asarray(m)[:, 1, :C])
    flat = lambda v: _t(v).reshape(2, -1, C)  # noqa: E731
    got_sums = gn_bwd_sums(flat(x), flat(ct), mean, inv, _t(a), _t(b), act)
    got_dx = gn_bwd_apply(flat(x), flat(ct), mean, inv, _t(a), _t(b), m1, m2,
                          act)
    _close(got_sums, want_sums)
    _close(got_dx.reshape(x.shape), want_dx)


def test_bwd_wrappers_check_and_do_not_count_on_the_cpu():
    x = torch.zeros(2, 8, 16)
    v = torch.ones(2, 16)
    with pytest.raises(ValueError, match="shape"):
        gn_bwd_sums(x, torch.zeros(2, 4, 16), v, v, v, v)
    with pytest.raises(TypeError, match="dtype"):
        gn_bwd_sums(x, x.bfloat16(), v, v, v, v)
    with pytest.raises(ValueError, match="needs an integer seed"):
        gn_bwd_apply(x, x, v, v, v, v, v, v, "silu", 0.1)
    with pytest.raises(ValueError, match="unknown act"):
        gn_bwd_sums(x, x, v, v, v, v, "gelu")
    with pytest.raises(RuntimeError, match="forward-only"):
        gn_bwd_sums(x.clone().requires_grad_(True), x, v, v, v, v)
    before = (gn_bwd_sums.launches, gn_bwd_apply.launches)
    assert gn_bwd_sums(x, x, v, v, v, v).shape == (2, 2, 16)
    assert gn_bwd_apply(x, x, v, v, v, v, v, v).shape == x.shape
    assert (gn_bwd_sums.launches, gn_bwd_apply.launches) == before
