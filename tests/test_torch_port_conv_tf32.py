"""Why the f32 conv kernels split each operand in three TF32 products.

``csrc/conv3d_fwd.cu`` and ``csrc/conv3d_dw.cu`` run their f32 paths on the
TF32 tensor cores: each operand f becomes hi = tf32(f) and lo = tf32(f -
hi), both rounded by ``cvt.rna.tf32.f32`` (to nearest, ties away from
zero, 10 mantissa bits), and a product a b is taken as lo_a hi_b + hi_a
lo_b + hi_a hi_b (``conv3d_brick.cuh``). These tests emulate that split in
float64 on the bit patterns, at the trained model's contraction depths (27
taps x 16 and x 64 input channels), and hold the 3xTF32 conv within 1e-5 of
the float64 conv under the chip checks' measure (max error over max(1, max
|reference|)), while one TF32 pass misses the kernels' f32 tolerance (1e-4,
``chip_smoke.TOL``)."""

import numpy as np
import pytest

F32_CONV_TOL = 1e-4  # chip_smoke.TOL[("conv", "float32")]


def tf32_rna(f):
    """``cvt.rna.tf32.f32`` on float32 values: add half of the 13 dropped
    bits' weight to the magnitude bits and truncate them (the sign bit is
    apart, so the magnitude rounds away from zero at a tie)."""
    u = np.asarray(f, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(f):
    f = np.asarray(f, np.float32)
    hi = tf32_rna(f)
    return hi, tf32_rna(f - hi)  # f - hi is exact in float32


def taps(x, circular=True):
    """im2col of a SAME 3x3x3 conv: x (D, H, W, C) -> (D H W, 27 C), tap
    (kz, ky, kx) reading x[d + kz - 1, h + ky - 1, w + kx - 1]."""
    mode = "wrap" if circular else "constant"
    xp = np.pad(x, ((1, 1), (1, 1), (1, 1), (0, 0)), mode=mode)
    D, H, W, C = x.shape
    cols = [xp[kz:kz + D, ky:ky + H, kx:kx + W].reshape(-1, C)
            for kz in range(3) for ky in range(3) for kx in range(3)]
    return np.concatenate(cols, 1)


def conv_operands(cin, cout, seed, size=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((size, size, size, cin)).astype(np.float32)
    w = (rng.standard_normal((27 * cin, cout))
         / np.sqrt(27 * cin)).astype(np.float32)
    return taps(x), w


def rel_err(got, ref):
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def test_rna_rounds_to_nearest_ties_away_on_ten_mantissa_bits():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    f = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4,
                  3.0, 0.0], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0],
                    np.float32)
    np.testing.assert_array_equal(tf32_rna(f), want)
    assert not (tf32_rna(f).view(np.uint32) & np.uint32(0x1FFF)).any()


def test_hi_plus_lo_holds_float32_to_2_pow_minus_22():
    f = np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
    hi, lo = split(f)
    err = np.abs(f.astype(np.float64) - hi - lo) / np.abs(f)
    assert err.max() <= 2.0 ** -22
    assert np.abs(lo).max() <= 2.0 ** -11 * np.abs(f).max()


@pytest.mark.parametrize("cin", (16, 64))
def test_3xtf32_conv_is_within_1e_5_of_float64(cin):
    a, b = conv_operands(cin, 16, seed=cin)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    (ah, al), (bh, bl) = split(a), split(b)
    f64 = [t.astype(np.float64) for t in (ah, al, bh, bl)]
    ah, al, bh, bl = f64
    got = al @ bh + ah @ bl + ah @ bh  # the small terms first
    err = rel_err(got, ref)
    assert err <= 1e-5, err
    # the dropped lo_a lo_b term is below the float32 output's rounding
    assert rel_err(got + al @ bl, ref) <= 1e-6


@pytest.mark.parametrize("cin", (16, 64))
def test_one_tf32_pass_misses_the_f32_tolerance(cin):
    a, b = conv_operands(cin, 16, seed=cin)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    one_pass = tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64)
    assert rel_err(one_pass, ref) > F32_CONV_TOL
