"""The port's 1x1 projection (``mm1x1_*`` plain versions, ``Conv1x1`` and the
k = 1 route of ``conv_nd``) against the JAX package on the CPU, on the same
seeded numpy inputs.

Against ``lane_matmul`` itself, run as the JAX package's own test runs it
(the Pallas kernel under ``pltpu.force_tpu_interpret_mode()``), at two of its
lane-dense shapes, f32: forward 1e-5 and gradients 2e-5, both scaled by
max |ref| (f32 sums in another order). Interpret mode is heavy, so only those
two shapes go through it; the port's own widths (multiples of 8, which the TPU
kernel does not take) are held against the plain XLA oracle ``x @ w + b`` and
against ``vdm4cdm_tpu.ops.conv.conv_nd``: f32 1e-5, bf16 1.6e-2 (one rounding
to bf16 at another place), both scaled by max(1, max |ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdm4cdm_tpu.ops.conv import conv_nd as jconv_nd
from vdm4cdm_tpu.ops.pallas.lanemm import lane_matmul
from vdm4cdm_tpu.ops.pallas.lanemm import supports as jsupports

from vdm4cdm_torch.ops.conv import Conv1x1, conv_nd
from vdm4cdm_torch.ops.kernels import (KERNELS, mm1x1_dw, mm1x1_dw_plain,
                                       mm1x1_dx, mm1x1_fwd, mm1x1_plain)
from vdm4cdm_torch.ops.kernels.lanemm import supports
from vdm4cdm_torch.ops.pair import Pair

# (B, R, K, N): lane-dense shapes of tests/test_lanemm.py
LANE_CASES = [(2, 64, 128, 256), (1, 48, 384, 128)]
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _data(seed, rows, K, N):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(rows + (K,)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal((N,)).astype(np.float32)
    ct = rng.standard_normal(rows + (N,)).astype(np.float32)
    return x, w, b, ct


def _close(got, want, tol, floor=1.0):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(floor, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("dims", LANE_CASES, ids=str)
def test_forward_matches_lane_matmul_in_interpret_mode(dims):
    B, R, K, N = dims
    x, w, b, _ = _data(0, (B, R), K, N)
    assert jsupports(x.shape, K, N, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = lane_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = mm1x1_fwd(_t(x), _t(w), _t(b))
    _close(got, want, 1e-5, floor=1e-6)
    _close(mm1x1_plain(_t(x), _t(w), _t(b)), want, 1e-5, floor=1e-6)


@pytest.mark.parametrize("dims", LANE_CASES, ids=str)
def test_gradients_match_lane_matmul_in_interpret_mode(dims):
    B, R, K, N = dims
    x, w, b, ct = _data(1, (B, R), K, N)

    def loss(x, w, b):
        return jnp.sum(lane_matmul(x, w, b) * jnp.asarray(ct))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    # through the autograd Function (w in the conv layout) ...
    tx, tb = _t(x).requires_grad_(True), _t(b).requires_grad_(True)
    tw = _t(w).reshape(1, 1, 1, K, N).requires_grad_(True)
    Conv1x1.apply(tx, tw, tb, None).backward(_t(ct))
    for got, ref in zip((tx.grad, tw.grad.reshape(K, N), tb.grad), want):
        _close(got, ref, 2e-5, floor=1e-6)
    # ... and through the raw wrappers
    dw, db = mm1x1_dw(_t(x), _t(ct))
    _close(mm1x1_dx(_t(ct), _t(w)), want[0], 2e-5, floor=1e-6)
    _close(dw, want[1], 2e-5, floor=1e-6)
    _close(db, want[2], 2e-5, floor=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(8, 32), (32, 8), (48, 96), (96, 48)])
def test_forward_matches_xla_oracle_at_port_widths(K, N, dtype):
    """y = x @ w + b (+ residual), the weight cast to x's dtype first, f32
    accumulation: against XLA's product on the CPU."""
    x, w, b, r = _data(2, (2, 3, 4, 5), K, N)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w).astype(jdt)
    acc = jnp.matmul(jx, jw, preferred_element_type=jnp.float32)
    want = acc + jnp.asarray(b)
    jr = jnp.asarray(r, jdt)
    tx, tr = _t(x, dtype), _t(r, dtype)
    _close(mm1x1_fwd(tx, _t(w), _t(b)), want.astype(jdt), TOL[dtype])
    _close(mm1x1_fwd(tx, _t(w)), acc.astype(jdt), TOL[dtype])
    _close(mm1x1_fwd(tx, _t(w), _t(b), tr),
           (want + jr.astype(jnp.float32)).astype(jdt), TOL[dtype])
    got = mm1x1_fwd(tx, _t(w), _t(b), tr)
    assert got.dtype == tx.dtype and got.shape == tr.shape
    assert torch.equal(got, mm1x1_plain(tx, _t(w), _t(b), tr))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(8, 32), (48, 96)])
def test_gradients_match_xla_oracle_at_port_widths(K, N, dtype):
    x, w, b, ct = _data(3, (2, 4, 4, 4), K, N)
    jdt = jnp.dtype(dtype)
    jct = jnp.asarray(ct, jdt)

    def loss(x, w, b):
        y = jnp.matmul(x, w.astype(jdt), preferred_element_type=jnp.float32)
        return jnp.sum((y + b) * jct.astype(jnp.float32))

    want = list(jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b)))
    # autodiff through w.astype(bf16) rounds dw to bf16; the kernel (as
    # lane_matmul's _dw_kernel) keeps the f32 sum, so form it directly
    want[1] = jnp.matmul(
        jnp.asarray(x, jdt).astype(jnp.float32).reshape(-1, K).T,
        jct.astype(jnp.float32).reshape(-1, N))
    tx = _t(x, dtype).requires_grad_(True)
    tw = _t(w).reshape(1, 1, 1, K, N).requires_grad_(True)
    tb = _t(b).requires_grad_(True)
    y = conv_nd(tx, tw, tb)
    y.backward(_t(ct, dtype))
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == torch.float32
    _close(tx.grad, want[0].astype(jnp.float32), TOL[dtype])
    # dw and db are f32 sums of products that are exact in f32
    _close(tw.grad.reshape(K, N), want[1], 2e-5, floor=1e-6)
    _close(tb.grad, want[2], 2e-5, floor=1e-6)
    dw, db = mm1x1_dw_plain(_t(x, dtype), _t(ct, dtype))
    assert dw.dtype == db.dtype == torch.float32
    _close(dw, want[1], 2e-5, floor=1e-6)


@pytest.mark.parametrize("padding", ["zeros", "circular"])
@pytest.mark.parametrize("cin,cout", [(24, 8), (32, 96)])
def test_conv_nd_k1_matches_jax_conv_nd(cin, cout, padding):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 4, 6, cin)).astype(np.float32)
    w = (rng.standard_normal((1, 1, 1, cin, cout))
         / np.sqrt(cin)).astype(np.float32)
    b = (0.3 * rng.standard_normal(cout)).astype(np.float32)
    ct = rng.standard_normal((2, 4, 4, 6, cout)).astype(np.float32)

    def loss(x, w, b):
        return jnp.sum(jconv_nd(x, w, b, padding_mode=padding)
                       * jnp.asarray(ct))

    want = jconv_nd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    padding_mode=padding)
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (_t(a).requires_grad_(True) for a in (x, w, b))
    got = conv_nd(tx, tw, tb, padding_mode=padding)
    _close(got, want, 1e-5)
    got.backward(_t(ct))
    for g, ref in zip((tx.grad, tw.grad, tb.grad), grads):
        _close(g, ref, 1e-4)


def test_conv_nd_k1_over_a_pair_matches_jax_concat():
    """The second half's product takes the first half's output as its
    residual: equal to the product over the concatenated channels, forward
    and every gradient."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 4, 4, 4, 16)).astype(np.float32)
    s = rng.standard_normal((2, 4, 4, 4, 8)).astype(np.float32)
    w = (rng.standard_normal((1, 1, 1, 24, 32)) / np.sqrt(24)).astype(
        np.float32)
    b = (0.3 * rng.standard_normal(32)).astype(np.float32)
    ct = rng.standard_normal((2, 4, 4, 4, 32)).astype(np.float32)

    def loss(a, s, w, b):
        y = jconv_nd(jnp.concatenate([a, s], -1), w, b)
        return jnp.sum(y * jnp.asarray(ct)), y

    grads, want = jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(v) for v in (a, s, w, b)))
    ta, ts, tw, tb = (_t(v).requires_grad_(True) for v in (a, s, w, b))
    got = conv_nd(Pair(ta, ts), tw, tb)
    _close(got, want, 1e-5)
    got.backward(_t(ct))
    for g, ref in zip((ta.grad, ts.grad, tw.grad, tb.grad), grads):
        _close(g, ref, 1e-4)


def test_supports_multiples_of_8_and_the_wrapper_raises_otherwise():
    assert supports(8, 8) and supports(48, 96) and supports(256, 32)
    assert not supports(12, 32) and not supports(32, 4) and not supports(0, 8)
    x = torch.zeros(4, 12)
    with pytest.raises(ValueError, match="multiples of 8"):
        mm1x1_fwd(x, torch.zeros(12, 32))
    with pytest.raises(ValueError, match="multiples of 8"):
        mm1x1_dw(torch.zeros(4, 32), torch.zeros(4, 12))
    with pytest.raises(ValueError, match="does not fit"):
        mm1x1_fwd(torch.zeros(4, 16), torch.zeros(8, 32))
    with pytest.raises(ValueError, match="contiguous"):
        mm1x1_fwd(torch.zeros(16, 4).t(), torch.zeros(16, 32))
    with pytest.raises(RuntimeError, match="forward-only"):
        mm1x1_fwd(torch.zeros(4, 16, requires_grad=True), torch.zeros(16, 8))
    # outside the kernel's widths conv_nd takes the library conv
    y = conv_nd(torch.ones(1, 2, 2, 2, 12), torch.ones(1, 1, 1, 12, 4))
    assert torch.equal(y, torch.full((1, 2, 2, 2, 4), 12.0))


def test_wrappers_are_counted_kernels_and_count_no_cpu_call():
    assert mm1x1_fwd in KERNELS and mm1x1_dw in KERNELS
    before = (mm1x1_fwd.launches, mm1x1_dw.launches)
    mm1x1_fwd(torch.zeros(4, 8), torch.zeros(8, 8))
    mm1x1_dw(torch.zeros(4, 8), torch.zeros(4, 8))
    assert (mm1x1_fwd.launches, mm1x1_dw.launches) == before


# every skip_proj width of the 3D presets (K -> N; the dx pass runs N -> K),
# the channel tails and the 384-channel level of train3D_c_c
PORT_WIDTHS = [(64, 32), (32, 32), (32, 64), (128, 64), (64, 64), (64, 128),
               (256, 128), (128, 128), (128, 256), (256, 256), (48, 96),
               (384, 384)]


def _oracle(x, w, b, ct, dtype):
    """(y, dx) of y = x @ w + b and of its input gradient for ct: through
    ``lane_matmul`` in interpret mode where it takes the shape (f32,
    lane-dense widths), else XLA's product with f32 accumulation."""
    jdt = jnp.dtype(dtype)
    K, N = w.shape
    if dtype == "float32" and jsupports(x.shape, K, N, jnp.float32):
        with pltpu.force_tpu_interpret_mode():
            y, vjp = jax.vjp(lambda v: lane_matmul(v, jnp.asarray(w),
                                                   jnp.asarray(b)),
                             jnp.asarray(x))
            (dx,) = vjp(jnp.asarray(ct))
        return y, dx
    jw = jnp.asarray(w).astype(jdt)
    y = jnp.matmul(jnp.asarray(x, jdt), jw,
                   preferred_element_type=jnp.float32) + jnp.asarray(b)
    dx = jnp.matmul(jnp.asarray(ct, jdt), jw.T,
                    preferred_element_type=jnp.float32)
    return y.astype(jdt), dx.astype(jdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", PORT_WIDTHS, ids=str)
def test_orientation_argument_matches_the_old_call_and_the_oracle(K, N,
                                                                  dtype):
    """``w_transposed``: the plain version reads w (K, N) or its transpose
    (N, K) alike, forward and dx, and both agree with ``lane_matmul`` (or
    the XLA oracle at widths it does not take)."""
    x, w, b, ct = _data(6, (2, 16), K, N)
    tx, tw, tb, tct = _t(x, dtype), _t(w), _t(b), _t(ct, dtype)
    y_old = mm1x1_plain(tx, tw, tb)
    assert torch.equal(mm1x1_plain(tx, tw, tb, w_transposed=False), y_old)
    y_t = mm1x1_plain(tx, tw.t().contiguous(), tb, w_transposed=True)
    dx_old = mm1x1_plain(tct, tw.t())
    dx_new = mm1x1_plain(tct, tw, w_transposed=True)
    assert torch.equal(dx_new, dx_old)
    # the wrappers take the CPU tensors to the plain version unchanged
    assert torch.equal(mm1x1_dx(tct, tw), dx_new)
    assert torch.equal(mm1x1_fwd(tx, tw.t().contiguous(), tb,
                                 w_transposed=True), y_t)
    want_y, want_dx = _oracle(x, w, b, ct, dtype)
    for got, want in ((y_old, want_y), (y_t, want_y), (dx_new, want_dx)):
        assert got.dtype == tx.dtype
        _close(got, np.asarray(jnp.asarray(want, jnp.float32)), TOL[dtype])


def test_orientation_argument_checks_the_weight_shape():
    x = torch.zeros(4, 16)
    assert mm1x1_fwd(x, torch.zeros(32, 16), w_transposed=True).shape == (
        4, 32)
    with pytest.raises(ValueError, match="does not fit"):
        mm1x1_fwd(x, torch.zeros(16, 32), w_transposed=True)
    with pytest.raises(ValueError, match="does not fit"):
        mm1x1_fwd(x, torch.zeros(32, 16))
