"""The FLOP and byte arithmetic against hand counts at a tiny shape."""

import pytest

from portbench import flops
from portbench.reference.cunet import Arch

# 3D, 8^3, two levels of widths 8 and 16, one ResBlock a level
TINY = Arch(ndim=3, size=8, in_channels=1, s_channels=1, v_dims=(6,),
            chs=(8, 16), groups=8, dropout=0.0, n_res=1, circular=False)


def _k3(cin, cout, vox):
    return 2 * 27 * cin * cout * vox


def test_forward_flops_by_hand():
    v0, v1 = 8 ** 3, 4 ** 3
    convs = (_k3(2, 8, v0)                                  # conv_in
             + _k3(8, 8, v0) * 2                            # down_0_0
             + _k3(8, 8, v1)                                # downsample_0
             + _k3(8, 16, v1) + _k3(16, 16, v1) + 2 * 8 * 16 * v1  # down_1_0
             + 2 * (_k3(16, 16, v1) * 2)                    # mid_0, mid_1
             # up_1_0 (16+16 -> 16), up_1_1 (16+8 -> 16): k3, k3, 1x1
             + _k3(32, 16, v1) + _k3(16, 16, v1) + 2 * 32 * 16 * v1
             + _k3(24, 16, v1) + _k3(16, 16, v1) + 2 * 24 * 16 * v1
             + _k3(16, 16, v0)                              # upsample_1
             # up_0_0 (16+8 -> 8), up_0_1 (8+8 -> 8)
             + _k3(24, 8, v0) + _k3(8, 8, v0) + 2 * 24 * 8 * v0
             + _k3(16, 8, v0) + _k3(8, 8, v0) + 2 * 16 * 8 * v0
             + _k3(8, 1, v0))                               # conv_out
    emb = 32
    dense = 2 * (8 * emb + emb * emb + 6 * emb + emb * emb)
    film = 2 * emb * 2 * (8 + 16 + 16 + 16 + 16 + 16 + 8 + 8)
    assert flops.model_flops(TINY, 3) == pytest.approx(
        3 * (convs + dense + film), rel=1e-12)


# one level of width 8 at 8^3, no ResBlock on the way down: conv_in, the
# two mid ResBlocks, one decoder ResBlock on the join (8 + 8), conv_out
ONE = Arch(3, 8, 1, 1, (6,), (8,), 8, 0.0, 0, False)
V = 8 ** 3


def _least(f, nbytes, peak=989e12):
    return max(f / peak, nbytes / 3.35e12)


def _conv(cin, cout, residual=False, elt=2):
    x, y, w = cin * V * elt, cout * V * elt, 27 * cin * cout * 4
    return _k3(cin, cout, V), x, y, w, residual


CONVS = [_conv(2, 8), _conv(8, 8), _conv(8, 8, True), _conv(8, 8),
         _conv(8, 8, True), _conv(16, 8), _conv(8, 8, True), _conv(8, 1)]


def test_conv_least_time_by_hand():
    fwd = sum(_least(f, x + y * (2 if r else 1) + w)
              for f, x, y, w, r in CONVS)
    assert flops.conv_least_s(ONE, 1, "bfloat16", False, False) == \
        pytest.approx(fwd, rel=1e-12)
    bwd = sum(_least(f, x + y + w) * (1 if i == 0 else 2)
              for i, (f, x, y, w, r) in enumerate(CONVS))
    assert flops.conv_least_s(ONE, 1, "bfloat16", True, False) == \
        pytest.approx(fwd + bwd, rel=1e-12)
    # remat recomputes the six convs inside ResBlocks
    again = sum(_least(f, x + y * (2 if r else 1) + w)
                for f, x, y, w, r in CONVS[1:7])
    assert flops.conv_least_s(ONE, 1, "bfloat16", True, True) == \
        pytest.approx(fwd + bwd + again, rel=1e-12)


def test_norm_bytes_by_hand():
    a8, a16 = V * 8 * 4, V * 16 * 4
    # mid blocks: first norm sums and applies, the second takes the hand
    # conv's sums; the decoder block's first norm runs on the 16-wide join;
    # norm_out
    fwd = 2 * (3 * a8 + 2 * a8) + 3 * a16 + 2 * a8 + 3 * a8
    bwd = 5 * (2 * a8 + 2 * a8 + a16 + a8 + a8)
    assert flops.norm_least_s(ONE, 1, "float32", False, False) == \
        pytest.approx(fwd / 3.35e12)
    assert flops.norm_least_s(ONE, 1, "float32", True, False) == \
        pytest.approx((fwd + bwd) / 3.35e12)


def test_launches_match_the_flagship_counts():
    """The kernel wrappers' launches per forward and per train step of the
    128^3 flagship, as the port counts them on the card (PERF.md)."""
    arch = Arch(3, 128, 1, 1, (6,), (32, 64, 128, 256), 8, 0.1, 2, False)
    assert flops.launches(arch, train=False, remat=False) == {
        "conv3d_k3s1_fwd": 59, "conv3d_k3s1_dw": 0, "gn_sums": 35,
        "gn_apply": 57, "gn_bwd_sums": 0, "gn_bwd_apply": 0,
        "mm1x1_fwd": 27, "mm1x1_dw": 0}
    assert flops.launches(arch, train=True, remat=False) == {
        "conv3d_k3s1_fwd": 118, "conv3d_k3s1_dw": 59, "gn_sums": 35,
        "gn_apply": 57, "gn_bwd_sums": 57, "gn_bwd_apply": 57,
        "mm1x1_fwd": 54, "mm1x1_dw": 27}


def test_peaks():
    assert flops.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 495e12}
    assert flops.HBM_BYTES_PER_S == 3.35e12
