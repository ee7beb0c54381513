"""The backward of the port's k3/s1 conv (the ``Conv3dK3S1`` Function on its
plain CPU path: the dx pass through the forward with flipped, transposed
weights, and ``conv3d_k3s1_dw``) against ``jax.grad`` of the JAX package's
``ops/conv.conv_nd`` (XLA on the CPU), f32, on the same seeded numpy inputs;
one case against the Pallas ``_conv_pallas_dw`` in interpret mode, as the JAX
package's own tests run it. Tolerance 1e-4 relative to max(1, max |ref|):
sums over a few thousand f32 terms in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdm4cdm_tpu.ops.conv import conv_nd as jconv_nd
from vdm4cdm_tpu.ops.pallas.conv3d import _conv_pallas_dw

from vdm4cdm_torch.ops.conv import Conv3dK3S1, conv_nd
from vdm4cdm_torch.ops.kernels import (conv3d_k3s1_dw, conv3d_k3s1_dx,
                                       conv3d_k3s1_fwd)
from vdm4cdm_torch.ops.pair import Pair


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two threads for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
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


def _data(seed, shape, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (cin,)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout))
         / np.sqrt(27 * cin)).astype(np.float32)
    b = (0.3 * rng.standard_normal(cout)).astype(np.float32)
    ct = rng.standard_normal(shape + (cout,)).astype(np.float32)
    return x, w, b, ct


@pytest.mark.parametrize("padding", ["circular", "zeros"])
@pytest.mark.parametrize("cin,cout", [(16, 24), (8, 8)])
def test_dx_dw_db_match_jax_grad(padding, cin, cout):
    x, w, b, ct = _data(0, (2, 4, 6, 8), cin, cout)
    want = jax.grad(
        lambda x, w, b: jnp.sum(jconv_nd(x, w, b, padding_mode=padding) * ct),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = _t(x, True), _t(w, True), _t(b, True)
    y, sums = conv_nd(xt, wt, bt, padding_mode=padding, emit_stats=True)
    assert y.requires_grad and not sums.requires_grad
    (y * _t(ct)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad, bt.grad), want):
        _close(got, ref)


@pytest.mark.parametrize("padding", ["circular", "zeros"])
def test_residual_gets_the_output_gradient(padding):
    x, w, b, ct = _data(1, (1, 4, 4, 4), 8, 16)
    r = np.random.default_rng(2).standard_normal(ct.shape).astype(np.float32)
    want = jax.grad(
        lambda x, r: jnp.sum((jconv_nd(x, jnp.asarray(w), jnp.asarray(b),
                                       padding_mode=padding) + r) * ct),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(r))
    xt, rt = _t(x, True), _t(r, True)
    y = conv_nd(xt, _t(w), _t(b), padding_mode=padding, residual=rt)
    (y * _t(ct)).sum().backward()
    _close(xt.grad, want[0])
    _close(rt.grad, want[1])
    np.testing.assert_array_equal(rt.grad.numpy(), ct)


@pytest.mark.parametrize("padding", ["circular", "zeros"])
def test_pair_input_grads_match_jax_on_the_concat(padding):
    """conv(Pair(a, s), W): both halves' dx, the full dw (the weight slices'
    gradients reassembled by autograd) and db against jax.grad on the
    materialized concat."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 4, 4, 8, 16)).astype(np.float32)
    s = rng.standard_normal((2, 4, 4, 8, 8)).astype(np.float32)
    _, w, b, ct = _data(4, (2, 4, 4, 8), 24, 16)
    want = jax.grad(
        lambda j, w, b: jnp.sum(jconv_nd(j, w, b, padding_mode=padding) * ct),
        argnums=(0, 1, 2))(jnp.asarray(np.concatenate([a, s], -1)),
                           jnp.asarray(w), jnp.asarray(b))
    at, st, wt, bt = _t(a, True), _t(s, True), _t(w, True), _t(b, True)
    y, sums = conv_nd(Pair(at, st), wt, bt, padding_mode=padding,
                      emit_stats=True)
    (y * _t(ct)).sum().backward()
    _close(torch.cat([at.grad, st.grad], -1), want[0])
    _close(wt.grad, want[1])
    _close(bt.grad, want[2])


@pytest.mark.parametrize("padding", ["circular", "zeros"])
def test_dw_matches_pallas_dw_kernel(padding):
    """``conv3d_k3s1_dw`` against the TPU kernel it replaces, in interpret
    mode at the shape of the JAX package's own gradient test."""
    x, _, _, ct = _data(5, (1, 4, 8, 8), 16, 16)
    with pltpu.force_tpu_interpret_mode():
        dw, db = _conv_pallas_dw(jnp.asarray(x), jnp.asarray(ct), padding,
                                 jnp.float32)
    got_dw, got_db = conv3d_k3s1_dw(_t(x), _t(ct), padding == "circular")
    assert got_dw.dtype == got_db.dtype == torch.float32
    _close(got_dw, np.asarray(dw))
    _close(got_db, np.asarray(db))


def test_dx_pass_is_the_forward_on_flipped_transposed_weights():
    x, w, _, ct = _data(6, (1, 4, 4, 4), 8, 16)
    want = jax.grad(lambda x: jnp.sum(jconv_nd(
        x, jnp.asarray(w), None, padding_mode="circular") * ct))(
            jnp.asarray(x))
    got = conv3d_k3s1_dx(_t(ct), _t(w), circular=True)
    assert got.shape == x.shape
    _close(got, want)


def test_bf16_backward_runs_in_x_dtype_and_returns_f32_param_grads():
    x, w, b, ct = _data(7, (1, 4, 4, 4), 8, 8)
    xt = _t(x).bfloat16().requires_grad_(True)
    wt, bt = _t(w, True), _t(b, True)
    y = conv_nd(xt, wt, bt, padding_mode="circular")
    assert y.dtype == torch.bfloat16
    (y.float() * _t(ct)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    assert wt.grad.dtype == bt.grad.dtype == torch.float32
    ref = jax.grad(
        lambda w: jnp.sum(jconv_nd(jnp.asarray(x), w, jnp.asarray(b),
                                   padding_mode="circular") * ct))(
                                       jnp.asarray(w))
    _close(wt.grad, ref, 2e-2)  # x and ct rounded to bf16


def test_sums_are_non_differentiable_and_needs_input_grad_is_honoured():
    x, w, b, ct = _data(8, (1, 4, 4, 4), 8, 8)
    xt, wt = _t(x), _t(w, True)
    before = conv3d_k3s1_fwd.launches
    y, sums = Conv3dK3S1.apply(xt, wt, None, None, True, True)
    assert not sums.requires_grad and sums.shape == (1, 2, 8)
    (y * _t(ct)).sum().backward()
    assert xt.grad is None and wt.grad is not None
    assert conv3d_k3s1_fwd.launches == before


def test_dw_wrapper_checks_its_operands():
    x = torch.zeros(1, 4, 4, 4, 8)
    ct = torch.zeros(1, 4, 4, 4, 16)
    with pytest.raises(ValueError, match="does not fit"):
        conv3d_k3s1_dw(x, torch.zeros(1, 4, 4, 2, 16))
    with pytest.raises(TypeError, match="dtype"):
        conv3d_k3s1_dw(x, ct.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        conv3d_k3s1_dw(x.transpose(1, 2), ct)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3d_k3s1_dw(torch.zeros(1, 4, 4, 4, 12), ct)
    with pytest.raises(RuntimeError, match="forward-only"):
        conv3d_k3s1_dw(x.clone().requires_grad_(True), ct)
    before = conv3d_k3s1_dw.launches
    dw, db = conv3d_k3s1_dw(x, ct)
    assert dw.shape == (3, 3, 3, 8, 16) and db.shape == (16,)
    assert conv3d_k3s1_dw.launches == before
