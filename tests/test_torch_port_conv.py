"""The port's ``conv_nd`` (its plain CPU path) against the JAX package's
``ops/conv.conv_nd`` (XLA on the CPU), f32, on the same seeded numpy inputs.
Tolerance 1e-5 absolute (outputs are O(1); only the summation order
differs). The conv-emitted GroupNorm sums are held against numpy sums over
JAX's f32 output at 1e-4 relative (sums over a few thousand terms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdm4cdm_tpu.ops.conv import conv_nd as jconv_nd
from vdm4cdm_tpu.ops.resample import upsample_nearest as jupsample_nearest

from vdm4cdm_torch.ops.conv import conv_nd
from vdm4cdm_torch.ops.kernels import conv3d_k3s1_fwd
from vdm4cdm_torch.ops.pair import Pair
from vdm4cdm_torch.ops.resample import upsample_nearest


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two threads for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


ATOL = 1e-5


def _data(seed, shape, cin, cout, k=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (cin,)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, cin, cout))
         / np.sqrt(k ** 3 * cin)).astype(np.float32)
    b = (0.3 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("padding", ["circular", "zeros"])
@pytest.mark.parametrize("cin,cout", [(16, 24), (8, 8)])
def test_k3s1_matches_jax_with_sums(padding, cin, cout):
    x, w, b = _data(0, (2, 4, 6, 8), cin, cout)
    want = np.asarray(jconv_nd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               padding_mode=padding))
    got, sums = conv_nd(_t(x), _t(w), _t(b), padding_mode=padding,
                        emit_stats=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    ref = np.stack([want.sum((1, 2, 3)), (want.astype(np.float64) ** 2)
                    .sum((1, 2, 3))], 1)
    np.testing.assert_allclose(sums.numpy(), ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("padding", ["circular", "zeros"])
def test_stride2_matches_jax(padding):
    x, w, b = _data(1, (2, 8, 6, 4), 16, 16)
    want = np.asarray(jconv_nd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=2, padding_mode=padding))
    got = conv_nd(_t(x), _t(w), _t(b), stride=2, padding_mode=padding)
    assert got.shape == want.shape == (2, 4, 3, 2, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("padding", ["circular", "zeros"])
def test_thin_input_conv_in_matches_jax(padding):
    """conv_in (2 -> 32 in the flagship) takes the library path."""
    x, w, b = _data(2, (2, 4, 4, 8), 2, 8)
    want = np.asarray(jconv_nd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               padding_mode=padding))
    got, sums = conv_nd(_t(x), _t(w), _t(b), padding_mode=padding,
                        emit_stats=True)
    assert sums is None
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_skip_projection_1x1_matches_jax():
    x, w, b = _data(3, (2, 4, 4, 4), 24, 8, k=1)
    want = np.asarray(jconv_nd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = conv_nd(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("k,padding", [(3, "circular"), (3, "zeros"),
                                       (1, "zeros")])
def test_pair_split_matches_concat(k, padding):
    """conv(Pair(a, b), W) == conv(concat(a, b), W): the weights split over
    the halves, the second half's conv adding the first's output; for k3 the
    sums still describe the joined output."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 4, 4, 8, 16)).astype(np.float32)
    s = rng.standard_normal((2, 4, 4, 8, 8)).astype(np.float32)
    _, w, b = _data(5, (1,), 24, 16, k=k)
    joined = np.concatenate([a, s], -1)
    want = np.asarray(jconv_nd(jnp.asarray(joined), jnp.asarray(w),
                               jnp.asarray(b), padding_mode=padding))
    got, sums = conv_nd(Pair(_t(a), _t(s)), _t(w), _t(b),
                        padding_mode=padding, emit_stats=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if k == 3:
        np.testing.assert_allclose(sums[:, 0].numpy(), want.sum((1, 2, 3)),
                                   rtol=1e-4, atol=1e-3)


def test_residual_is_added_before_the_sums():
    x, w, b = _data(6, (1, 4, 4, 4), 8, 16)
    r = np.random.default_rng(7).standard_normal((1, 4, 4, 4, 16))
    r = r.astype(np.float32)
    want = np.asarray(jconv_nd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               padding_mode="circular")) + r
    got, sums = conv_nd(_t(x), _t(w), _t(b), padding_mode="circular",
                        emit_stats=True, residual=_t(r))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(sums[:, 1].numpy(), (want ** 2).sum((1, 2, 3)),
                               rtol=1e-4)


def test_kernel_wrapper_checks_its_operands():
    x = torch.zeros(1, 4, 4, 4, 8)
    w = torch.zeros(3, 3, 3, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        conv3d_k3s1_fwd(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3d_k3s1_fwd(torch.zeros(1, 4, 4, 4, 12),
                        torch.zeros(3, 3, 3, 12, 8))
    with pytest.raises(TypeError, match="dtype"):
        conv3d_k3s1_fwd(x.half(), w)
    with pytest.raises(ValueError, match="w shape"):
        conv3d_k3s1_fwd(x, torch.zeros(3, 3, 3, 16, 8))


def test_kernel_wrapper_is_forward_only():
    """The raw wrapper owns no gradient (``conv_nd``'s Function does): a call
    that autograd would track raises instead of returning an output cut off
    from its inputs."""
    x = torch.zeros(1, 4, 4, 4, 8, requires_grad=True)
    w = torch.zeros(3, 3, 3, 8, 8)
    with pytest.raises(RuntimeError, match="forward-only"):
        conv3d_k3s1_fwd(x, w)
    with torch.no_grad():
        out, _ = conv3d_k3s1_fwd(x, w)
    assert out.shape == (1, 4, 4, 4, 8)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = conv3d_k3s1_fwd.launches
    conv3d_k3s1_fwd(torch.zeros(1, 2, 2, 2, 8), torch.zeros(3, 3, 3, 8, 8))
    assert conv3d_k3s1_fwd.launches == before


def test_upsample_nearest_matches_jax():
    x = np.random.default_rng(8).standard_normal((2, 1, 2, 3, 8))
    x = x.astype(np.float32)
    want = np.asarray(jupsample_nearest(jnp.asarray(x)))
    got = upsample_nearest(_t(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
