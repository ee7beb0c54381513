"""The launch plan of the 1x1 projection's forward kernel
(``ops/kernels/lanemm.py::fwd_plan``, the rules of ``csrc/lanemm.cu``;
``chip_smoke.py`` holds it equal to the compiled source's on the card). The
sites are the ``mm1x1_fwd`` calls a forward of ``trainVDM3D128_c_c`` and of
``trainSFM3D128_c_c`` makes, recorded on the CPU at a 16^3 crop and scaled to
the 128^3 crop at the batches the port runs (1, 2 and 4), with their dx
passes (N -> K, no residual), and row counts with tails. At each, the
persistent CTAs' row tiles cover every row exactly once, the padded widths
hold K and N, and the shared memory the kernel carves fits a CTA and the
CTAs the grid assumes an SM."""

import math

import numpy as np
import pytest
import torch

import chip_smoke
import vdm4cdm_torch as vt
from vdm4cdm_torch.ops import conv as conv_mod
from vdm4cdm_torch.ops.kernels import lanemm as L

CROP, RECORD_CROP = 128, 16
DTYPES = (torch.bfloat16, torch.float32)


def _record(preset):
    """(rows at RECORD_CROP and batch 1, K, N, residual) of every
    ``mm1x1_fwd`` call of one forward, in call order."""
    calls = []
    real = conv_mod.mm1x1_fwd

    def spy(x, w, bias=None, residual=None, **kw):
        calls.append((x.numel() // x.shape[-1], w.shape[0], w.shape[1],
                      residual is not None))
        return real(x, w, bias, residual, **kw)

    model = chip_smoke.build(vt, preset, RECORD_CROP, "float32", "cpu", 0)
    shape = (1, RECORD_CROP, RECORD_CROP, RECORD_CROP, 1)
    gen = torch.Generator().manual_seed(0)
    z, s = (torch.randn(shape, generator=gen) for _ in range(2))
    v = torch.randn(1, 6, generator=gen)
    t = torch.tensor([0.5])
    conv_mod.mm1x1_fwd = spy
    try:
        with torch.no_grad():
            if preset == chip_smoke.VDM_PRESET:
                model.eps_hat(z, t, s, [v])
            else:
                model.velocity(z, t, [v], s)
    finally:
        conv_mod.mm1x1_fwd = real
    return calls


RECORDED = {p: _record(p) for p in (chip_smoke.VDM_PRESET,
                                    chip_smoke.SFM_PRESET)}


def _sites(preset):
    """(R, K, N, residual) of every launch at the 128^3 crop, batches 1, 2
    and 4: the forward calls and their dx passes."""
    scale = (CROP // RECORD_CROP) ** 3
    out = set()
    for rows, k, n, res in RECORDED[preset]:
        for batch in (1, 2, 4):
            r = rows * scale * batch
            out.add((r, k, n, res))
            out.add((r, n, k, False))
    return sorted(out)


# row counts that end inside a tile, at the main path's widths
TAILS = [(r, k, n, res) for r in (1, 7, 129, 1000003, 2 * 32 ** 3 + 5)
         for k, n in ((32, 32), (64, 32), (32, 64), (256, 256), (48, 96))
         for res in (False, True)]


def test_a_forward_makes_27_calls_at_the_skip_proj_widths():
    for preset, calls in RECORDED.items():
        assert len(calls) == 27, preset
        widths = {(k, n) for _, k, n, _ in calls}
        assert widths == {(size_k, size_n) for _, size_k, size_n in
                          chip_smoke.mm1x1_cases()[:-2]}, preset
        # a Pair's second half takes the first half's output
        assert sum(res for *_, res in calls) == 12
    assert RECORDED[chip_smoke.VDM_PRESET] == RECORDED[chip_smoke.SFM_PRESET]


def _check(site, dtype):
    R, K, N, res = site
    p = L.fwd_plan(dtype, R, K, N, res)
    assert p.threads == L.THREADS
    if p.kind == 0:
        assert dtype == torch.float32 or max(K, N) > L.TC_MAX
        assert p.grid == math.ceil(R / p.bm) * math.ceil(N / p.np)
        assert p.np in (32, 64) and (N <= 32) == (p.np == 32)
        return
    assert dtype == torch.bfloat16
    assert p.kp in (32, 64, 128, 256) and p.kp >= K > p.kp // 2 or (
        p.kp == 32 and K <= 32)
    assert p.np in (32, 64, 128, 256) and p.np >= N > p.np // 2 or (
        p.np == 32 and N <= 32)
    # a warp takes 16 rows and at most 64 columns, 8 warps a CTA
    assert p.bm == 16 * 8 * min(p.np, 64) // p.np
    # the kernel's carve: weight, bias, output staging, the ring
    stage = p.bm * p.kp * 2 + (p.bm * p.np * 2 if res else 0)
    assert p.smem == (p.np * p.kp * 2 + p.np * 4 + p.bm * p.np * 2
                      + p.stages * stage)
    assert 2 <= p.stages <= 4 and p.smem <= L.SMEM_CTA
    assert p.ctas_per_sm in (1, 2)
    assert p.ctas_per_sm * (p.smem + L.SMEM_RESERVED) <= L.SMEM_SM
    tiles = math.ceil(R / p.bm)
    assert p.grid == min(tiles, L.SMS * p.ctas_per_sm) >= 1
    # CTA c walks tiles c, c + grid, ... (n_my of them, as the kernel
    # counts): every tile once, so every row once
    walked = []
    for c in range(p.grid):
        mine = np.arange(c, tiles, p.grid)
        assert len(mine) == (tiles - 1 - c) // p.grid + 1
        walked.append(mine)
    walked = np.sort(np.concatenate(walked))
    assert np.array_equal(walked, np.arange(tiles))
    assert tiles * p.bm >= R > (tiles - 1) * p.bm


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("preset", sorted(RECORDED))
def test_tiles_cover_each_row_once_and_fit_shared_memory(preset, dtype):
    sites = _sites(preset)
    assert len(sites) >= 3 * 10
    for site in sites:
        _check(site, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_row_tails_and_channel_tails(dtype):
    for site in TAILS:
        _check(site, dtype)


def test_the_main_path_runs_the_persistent_kernel_two_ctas_an_sm():
    for preset in RECORDED:
        for R, K, N, res in _sites(preset):
            p = L.fwd_plan(torch.bfloat16, R, K, N, res)
            assert p.kind == 1
            if max(K, N) <= 64:
                assert p.ctas_per_sm == 2 and p.stages >= 2
    # past 256 channels, the blocks of 128 rows
    assert L.fwd_plan(torch.bfloat16, 4096, 384, 384, True).kind == 0
    small = L.fwd_plan(torch.bfloat16, 2 * 128 ** 3, 32, 32, False, sms=66)
    assert small.grid == 132 and L.fwd_plan(
        torch.bfloat16, 2 * 128 ** 3, 32, 32, False).grid == 264
