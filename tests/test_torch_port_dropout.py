"""The port's dropout: a keep-mask that is a function of (seed, element
index, p), Philox-4x32-10 in torch integer ops (the plain version of the
device function the Triton kernels inline), element i taking word i mod 4
of the call on counter i div 4. The TPU package's bits come from
the TPU's own generator and cannot be reproduced, so this file checks the
function itself (known-answer vectors of Philox-4x32-10 from the Random123
test suite), its distribution (keep rate within 4 sigma), and what the norm
sites do with it: the 1/(1-p) scale, determinism per seed, different sites
differing, and a gradient that is exactly zero where the output was dropped.
Against the JAX package only the p = 0 limit and the expectation can be held:
the mean of the dropped output over many seeds approaches the JAX output
(3 sigma of the seed average)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdm4cdm_tpu.ops import norm as jnorm

from vdm4cdm_torch.ops import norm
from vdm4cdm_torch.ops.kernels import gn_apply, philox
from vdm4cdm_torch.ops.pair import Pair


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One thread for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# Random123 kat_vectors, philox4x32 with 10 rounds: counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    words = [torch.tensor([c], dtype=torch.int64) for c in counter]
    got = philox.philox_4x32(key[0] | (key[1] << 32), *words)
    assert tuple(int(w) for w in got) == want


def test_bits_use_the_64_bit_index_and_seed():
    """Element i takes word i mod 4 of the call on counter i div 4: indices
    0..3 are the four words of the first known answer; 4 * 2^32 is the first
    index whose counter has a high word, and the seed's high word is its
    key's."""
    idx = torch.tensor([0, 1, 2, 3, 2 ** 32, 2 ** 32 + 1, 4 * 2 ** 32,
                        4 * 2 ** 32 + 3], dtype=torch.int64)
    bits = philox.philox_bits_plain(0, idx)
    assert tuple(int(b) for b in bits[:4]) == KAT[0][2]
    assert len(set(bits.tolist())) == 8
    hi = philox.philox_4x32(0, *[torch.tensor([c]) for c in (0, 1, 0, 0)])
    assert (int(bits[6]), int(bits[7])) == (int(hi[0]), int(hi[3]))
    other = philox.philox_bits_plain(1 << 32, idx)  # differs in the high word
    assert not torch.equal(bits, other)
    assert philox.seed_words((0xFFFFFFFF << 32) | 5) == (5, -1)


def _reference_bits(seed, indices):
    """bits(seed, i) one element at a time: word i % 4 of Philox-4x32-10 on
    the counter (i // 4 low, i // 4 high, 0, 0)."""
    out = []
    for i in indices:
        q = i // 4
        words = philox.philox_4x32(
            seed, *[torch.tensor([c], dtype=torch.int64)
                    for c in (q & 0xFFFFFFFF, q >> 32, 0, 0)])
        out.append(int(words[i % 4]))
    return out


@pytest.mark.parametrize("start", [0, 2 ** 32 - 5, 4 * 2 ** 32 - 6,
                                   2 ** 40 + 1])
@pytest.mark.parametrize("seed", [0, 0x1234567890ABCDEF])
def test_mask_bits_equal_a_per_element_reference(seed, start):
    """Over windows that straddle 2^32 and 4 * 2^32 and start off a group's
    boundary."""
    stop = start + 13
    want = _reference_bits(seed, range(start, stop))
    idx = torch.arange(start, stop, dtype=torch.int64)
    assert philox.philox_bits_plain(seed, idx).tolist() == want


@pytest.mark.parametrize("q", [0, 5, 2 ** 30 - 1, 2 ** 32 + 7])
def test_four_consecutive_indices_take_the_four_words_of_one_call(q):
    seed = 0xA4093822299F31D0
    words = philox.philox_4x32(
        seed, *[torch.tensor([c], dtype=torch.int64)
                for c in (q & 0xFFFFFFFF, q >> 32, 0, 0)])
    idx = torch.arange(4 * q, 4 * q + 4, dtype=torch.int64)
    assert philox.philox_bits_plain(seed, idx).tolist() == [
        int(w) for w in words]


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_and_threshold(p, shape=(2, 1000, 64)):
    keep = philox.keep_mask_plain(1234, shape, p, "cpu")
    assert keep.shape == shape and keep.dtype == torch.bool
    n = keep.numel()
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(keep.float().mean().item() - (1 - p)) < 4 * sigma
    assert philox.keep_threshold(p) == min(int((1 - p) * 2 ** 32),
                                           2 ** 32 - 1)
    assert philox.keep_threshold(0.0) == 2 ** 32 - 1
    with pytest.raises(ValueError):
        philox.keep_threshold(1.0)


def test_mask_depends_on_index_not_on_chunking(monkeypatch, chunk=64):
    whole = philox.keep_mask_plain(7, (3, 50, 8), 0.3, "cpu")
    assert torch.equal(whole.reshape(-1), philox.philox_bits_plain(
        7, torch.arange(1200)) < philox.keep_threshold(0.3))
    monkeypatch.setattr(philox, "_PLAIN_CHUNK", chunk)
    assert torch.equal(philox.keep_mask_plain(7, (3, 50, 8), 0.3, "cpu"),
                       whole)
    assert torch.equal(philox.keep_mask_plain(7, (1200,), 0.3, "cpu"),
                       whole.reshape(-1))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_where_channels_are_not_a_multiple_of_4(p):
    test_keep_rate_and_threshold(p, (2, 999, 30))


@pytest.mark.parametrize("chunk", [63, 1])
def test_mask_chunks_may_start_inside_a_group(monkeypatch, chunk):
    test_mask_depends_on_index_not_on_chunking(monkeypatch, chunk)


def test_mix_seed_separates_steps_and_sites():
    seeds = {philox.mix_seed(s, i) for s in range(20) for i in range(30)}
    assert len(seeds) == 600
    assert all(0 <= s < 2 ** 64 for s in seeds)
    assert philox.mix_seed(3, 4) == philox.mix_seed(3, 4)


def _site(seed=0):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal((2, 4, 4, 8, 16)) + 0.4).astype(np.float32)
    a = (1.0 + 0.3 * rng.standard_normal((2, 16))).astype(np.float32)
    b = (0.2 * rng.standard_normal((2, 16))).astype(np.float32)
    return x, a, b


def _t(v, grad=False):
    return torch.from_numpy(np.array(v, np.float32)).requires_grad_(grad)


def test_site_scales_kept_values_and_is_deterministic_per_seed():
    x, a, b = _site()
    p = 0.25
    clean = norm.norm_affine_act(_t(x), _t(a), _t(b), 4, act="silu")
    y1 = norm.norm_affine_act(_t(x), _t(a), _t(b), 4, act="silu",
                              dropout_p=p, dropout_seed=11)
    y2 = norm.norm_affine_act(_t(x), _t(a), _t(b), 4, act="silu",
                              dropout_p=p, dropout_seed=11)
    y3 = norm.norm_affine_act(_t(x), _t(a), _t(b), 4, act="silu",
                              dropout_p=p, dropout_seed=12)
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    keep = philox.keep_mask_plain(11, (2, 4 * 4 * 8, 16), p, "cpu")
    keep = keep.reshape(y1.shape)
    assert torch.equal(y1 != 0, keep)
    np.testing.assert_allclose(y1[keep].numpy(),
                               (clean[keep] / (1 - p)).numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="dropout_seed"):
        norm.norm_affine_act(_t(x), _t(a), _t(b), 4, dropout_p=p)


def test_gradient_is_zero_exactly_where_the_output_was_dropped():
    x, a, b = _site(1)
    p = 0.3
    xt, at, bt = _t(x, True), _t(a, True), _t(b, True)
    # no activation and one channel per group member: dy reaches dx only
    # through the kept elements and the (dense) group means
    y = norm.norm_affine_act(xt, at, bt, 4, act=None, dropout_p=p,
                             dropout_seed=5)
    keep = y != 0
    ct = torch.ones_like(y)
    (dy_probe,) = torch.autograd.grad(y, bt, ct, retain_graph=True)
    # db = sum of dy over voxels = kept count / (1 - p) per (batch, channel)
    np.testing.assert_allclose(
        dy_probe.numpy(),
        keep.reshape(2, -1, 16).sum(1).numpy() / (1 - p), rtol=1e-5)
    # the plain backward kernels see dy = 0 at dropped elements
    from vdm4cdm_torch.ops.kernels.fused_norm import _dy_xhat_plain
    zeros = torch.zeros(2, 16)
    dy, _ = _dy_xhat_plain(xt.detach().reshape(2, -1, 16),
                           ct.reshape(2, -1, 16), zeros, zeros + 1, at.detach(),
                           bt.detach(), True, p, 5)
    assert torch.equal(dy != 0, keep.reshape(2, -1, 16))


def test_pair_halves_use_different_seeds():
    x, a, b = _site(2)
    half = _t(x[..., :8])
    y = norm.norm_affine_act(Pair(half, half.clone()), _t(a), _t(b), 4,
                             act=None, dropout_p=0.5, dropout_seed=9)
    assert not torch.equal(y.a == 0, y.b == 0)


def test_kernel_wrapper_dropout_matches_mask_and_needs_seed():
    x = torch.randn(2, 64, 8, generator=torch.Generator().manual_seed(0))
    a, bv = torch.ones(2, 8), torch.zeros(2, 8)
    y = gn_apply(x, a, bv, None, 0.2, seed=77)
    keep = philox.keep_mask_plain(77, x.shape, 0.2, "cpu")
    assert torch.equal(y != 0, keep)
    np.testing.assert_allclose(y[keep].numpy(), (x[keep] * 1.25).numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="needs an integer seed"):
        gn_apply(x, a, bv, None, 0.2)
    with pytest.raises(ValueError, match="not in"):
        gn_apply(x, a, bv, None, 1.0, seed=1)


def test_expectation_over_seeds_approaches_the_jax_output():
    x, a, b = _site(3)
    want = np.asarray(jnorm.norm_affine_act(jnp.asarray(x), jnp.asarray(a),
                                            jnp.asarray(b), 4, act="silu"))
    p, n = 0.2, 200
    acc = torch.zeros(x.shape)
    for seed in range(n):
        acc += norm.norm_affine_act(_t(x), _t(a), _t(b), 4, act="silu",
                                    dropout_p=p, dropout_seed=seed)
    # each element: mean of n draws of want * Bernoulli(1-p) / (1-p)
    sigma = np.abs(want) * np.sqrt(p / (1 - p) / n)
    z = (acc.numpy() / n - want) / np.maximum(sigma, 1e-6)
    assert np.abs(z).max() < 5.0 and abs(z.mean()) < 3.0 / np.sqrt(z.size)
