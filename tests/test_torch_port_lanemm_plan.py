"""The launch plans of the 1x1 projection's kernels
(``ops/kernels/lanemm.py::fwd_plan`` and ``dw_plan``, the rules of
``csrc/lanemm.cu``; ``chip_smoke.py`` holds them equal to the compiled
source's on the card). The 3D sites are the ``mm1x1_fwd`` calls a forward of
``trainVDM3D128_c_c`` and of ``trainSFM3D128_c_c`` makes, recorded on the CPU
at a 16^3 crop and scaled to the 128^3 crop at the batches the port runs (1,
2 and 4), with their dx passes (N -> K, no residual); the f32 sites add the
2D models' (``train_uc_c``, ``trainSFM_c_uc``, recorded at 32^2, scaled to
256^2 at batch 12) and the trained model's (``VDM_GRF_c_c_32``, recorded at
8^3, scaled to 32^3 at batches 12 and 8), and row counts with tails. At
each, the persistent CTAs' row tiles cover every row exactly once (and in
f32 every column slice), the padded widths hold K and N, the shared memory
the kernel carves fits a CTA and the CTAs the grid assumes an SM, and the
staged rows' strides keep the fragment reads conflict-free. The f32 weight
gradient's runs cover every row once for each (K, N) tile, and where (K, N)
fits one CTA (up to 192 x 96) that is each row read once."""

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


def _one_thread(fn):
    """fn() with torch on one thread: the recorded forwards are small, and
    the other test workers hold the other cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)


RECORDED = _one_thread(lambda: {p: _record(p) for p in (
    chip_smoke.VDM_PRESET, chip_smoke.SFM_PRESET)})


def _record_model(model, size, nd):
    """(rows at ``size`` and batch 1, K, N, residual) of every
    ``mm1x1_fwd`` call of one forward of a VDM or SFM, in call order."""
    calls = []
    real = conv_mod.mm1x1_fwd

    def spy(x, w, bias=None, residual=None, **kw):
        calls.append((x.numel() // x.shape[-1], w.shape[0], w.shape[1],
                      residual is not None))
        return real(x, w, bias, residual, **kw)

    net = getattr(model, "score_model", None) or model.unet
    gen = torch.Generator().manual_seed(0)
    spatial = (size,) * nd
    z = torch.randn(1, *spatial, net.shape[0], generator=gen)
    s = (torch.randn(1, *spatial, net.s_conditioning_channels, generator=gen)
         if net.s_conditioning_channels else None)
    vs = [torch.randn(1, d, generator=gen) for d in net.v_conditioning_dims]
    conv_mod.mm1x1_fwd = spy
    try:
        with torch.no_grad():
            net(z, torch.tensor([0.5]), s_conditioning=s, v_conditionings=vs)
    finally:
        conv_mod.mm1x1_fwd = real
    return calls


def _f32_recorded():
    """{model: (its calls, rows scale, batches)} of the f32 models."""
    out = {}
    for name in (chip_smoke.TWOD_VDM, chip_smoke.TWOD_SFM):
        model, _ = chip_smoke.build_2d(vt, name, 32, "cpu", 0)
        out[name] = (_record_model(model, 32, 2), (chip_smoke.TWOD_SIZE
                                                   // 32) ** 2,
                     (chip_smoke.TWOD_BATCH,))
    cfg = vt.preset(chip_smoke.BLESSED, **{"data.cropsize": 8})
    model = vt.build_model(cfg, device="cpu")
    out[chip_smoke.BLESSED] = (_record_model(model, 8, 3), (32 // 8) ** 3,
                               (chip_smoke.BLESSED_REPS,
                                chip_smoke.BLESSED_TRAIN_BATCH))
    return out


F32_RECORDED = _one_thread(_f32_recorded)


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


def _f32_sites(name):
    """(R, K, N, residual) of every launch of an f32 model at its size and
    batches: the forward calls and their dx passes."""
    calls, scale, batches = F32_RECORDED[name]
    out = set()
    for rows, k, n, res in calls:
        for batch in batches:
            out.add((rows * scale * batch, k, n, res))
            out.add((rows * scale * batch, n, k, False))
    return sorted(out)


# row counts that end inside a tile, at the main path's widths (and the 2D
# models' 384 and the widest slices)
TAILS = [(r, k, n, res) for r in (1, 7, 129, 1000003, 2 * 32 ** 3 + 5)
         for k, n in ((32, 32), (64, 32), (32, 64), (256, 256), (48, 96),
                      (384, 384), (192, 96), (8, 200), (200, 8))
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


def _walk_covers_once(p, R):
    """The persistent walk: CTA c takes column slice c % slices and row
    tiles c // slices, + grid // slices, ... (n_my of them, as the kernel
    counts); every (row tile, slice) pair once, so every output once."""
    slices = p.slices or 1
    assert p.grid % slices == 0
    tiles, per_slice = math.ceil(R / p.bm), p.grid // slices
    assert 1 <= per_slice <= tiles
    seen = np.zeros((tiles, slices), np.int64)
    for c in range(p.grid):
        first = c // slices
        mine = np.arange(first, tiles, per_slice)
        assert len(mine) == (tiles - 1 - first) // per_slice + 1
        seen[mine, c % slices] += 1
    assert (seen == 1).all()
    assert tiles * p.bm >= R > (tiles - 1) * p.bm


def _check_f32(p, R, K, N, res):
    assert p.kind == 2 and p.grid >= 1
    # the column slices: multiples of 8 that cover N once
    assert p.slice_n % 8 == 0 and p.slices == math.ceil(N / p.slice_n)
    assert (p.slices - 1) * p.slice_n < N <= p.slices * p.slice_n
    # warps: warps_n across the slice (NT <= 8 n8 tiles each, the fewest
    # that hold it), warps_k across K (at least one k step each), 16 rows
    # each along the rest
    nt = p.np // (8 * p.warps_n)
    assert p.warps_n in (1, 2, 4, 8) and 1 <= nt <= 8
    assert p.warps_k in (1, 2, 4, 8) and p.warps_n * p.warps_k <= 8
    assert p.warps_k <= K // 8
    assert p.np == 8 * nt * p.warps_n and p.np - 8 * p.warps_n < p.slice_n
    assert p.slice_n <= p.np
    assert p.bm == 16 * 8 // (p.warps_n * p.warps_k)
    # the staged x rows, K + 4 floats: = 4 mod 8, so rows g = 0..7 of a
    # fragment read start in 8 distinct groups of 4 banks
    assert p.kp == K + 4 and p.kp % 8 == 4
    ldr = L.f32_ldr(p.np)
    assert ldr % 32 in (8, 24)
    # the kernel's carve: split weight slice, bias, the K shares' sums, the
    # ring
    wbytes = 8 * K * p.np
    stage = p.bm * p.kp * 4 + (p.bm * ldr * 4 if res else 0)
    assert wbytes <= L.F32_WMAX
    assert p.smem == (wbytes + 4 * p.np + (p.warps_k - 1) * p.bm * p.np * 4
                      + p.stages * stage)
    assert 2 <= p.stages <= 4 and p.smem <= L.SMEM_CTA
    assert p.ctas_per_sm in (1, 2)
    assert p.ctas_per_sm * (p.smem + L.SMEM_RESERVED) <= L.SMEM_SM
    assert p.grid <= L.SMS * p.ctas_per_sm
    _walk_covers_once(p, R)


def _check(site, dtype):
    R, K, N, res = site
    p = L.fwd_plan(dtype, R, K, N, res)
    assert p.threads == L.THREADS
    if dtype == torch.float32:
        _check_f32(p, R, K, N, res)
        return
    assert (p.slices, p.slice_n, p.warps_n, p.warps_k) == (0, 0, 0, 0)
    if p.kind == 0:
        assert max(K, N) > L.TC_MAX
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
    _walk_covers_once(p, R)


def _check_dw(R, K, N):
    """The f32 weight gradient's plan: the (K, N) tiles cover dw once, the
    runs cover the rows once for each tile; returns how many times the
    kernel reads each row of x and of ct."""
    p = L.dw_plan(R, K, N)
    ktiles = p.tiles // p.tiles_n
    assert p.tiles == ktiles * p.tiles_n and p.grid == p.runs * p.tiles
    assert (ktiles - 1) * p.kc < K <= ktiles * p.kc
    assert (p.tiles_n - 1) * p.nc < N <= p.tiles_n * p.nc
    rows = p.run_chunks * p.br
    assert (p.runs - 1) * rows < R <= p.runs * rows
    assert p.threads == L.THREADS
    assert p.kc % 8 == 0 and p.nc % 8 == 0
    assert p.kc <= L.DW_KC and p.nc <= L.DW_NC
    # the fewest tiles under that cap
    assert ktiles == math.ceil(K / L.DW_KC)
    assert p.tiles_n == math.ceil(N / L.DW_NC)
    # warps_k x warps_n warps of at most 6 m16 and 6 n8 fragments hold the
    # tile, the fewest such; the rest of the 8 warps are row groups, each
    # with whole 8-row steps of a chunk
    wk, wn = p.warps_k, p.warps_n
    groups = p.threads // 32 // (wk * wn)
    assert wk in (1, 2) and wn in (1, 2, 4) and groups * wk * wn == 8
    assert math.ceil(math.ceil(p.kc / 16) / wk) <= L.DW_MT
    assert math.ceil(p.nc // 8 / wn) <= L.DW_NT
    assert wk == 1 or math.ceil(p.kc / 16) > L.DW_MT
    assert wn == 1 or math.ceil(p.nc // 8 / (wn // 2)) > L.DW_NT
    assert p.br % (8 * groups) == 0
    for w in (p.kc, p.nc):
        assert L.dw_ld(w) % 32 in (8, 24)
    # the runs fill the SMs as far as the rows allow (a chunk leaves 15/16
    # of the shortest chunk's runs or more), none longer than
    # DW_CHAIN_ROWS rows a warp
    target = max(1, L.SMS // p.tiles)
    shortest = min(b for b in range(32, 257, 32) if b % (8 * groups) == 0)
    runs0 = L.dw_runs(R, shortest, target)
    assert 16 * L.dw_runs(R, p.br, target) >= 15 * runs0
    assert p.run_chunks * p.br <= L.DW_CHAIN_ROWS * groups
    assert p.run_chunks == min(math.ceil(math.ceil(R / p.br) / target),
                               L.DW_CHAIN_ROWS * groups // p.br)
    # the ring; drained, it takes the warps' sums of the tile (dw and db)
    row_bytes = (L.dw_ld(p.kc) + L.dw_ld(p.nc)) * 4
    stage = p.br * row_bytes
    assert p.smem == p.stages * stage <= L.SMEM_CTA
    assert (p.kc * p.nc + p.nc) * 4 <= p.smem
    assert p.stages == 4 or (p.stages + 1) * stage > L.SMEM_CTA
    assert p.stages >= 2 and p.br % 32 == 0 and 32 <= p.br <= 256
    # no other chunk of whole steps that leaves as many runs keeps more
    # bytes in flight (15/16 of the shortest chunk's)
    for b in range(32, 257, 32):
        fits = [s for s in (4, 3, 2) if s * b * row_bytes <= L.SMEM_CTA]
        if (b % (8 * groups) == 0 and fits
                and 16 * L.dw_runs(R, b, target) >= 15 * runs0):
            assert (fits[0] - 1) * b * row_bytes <= (p.stages - 1) * stage
    # one CTA an SM: a single wave wherever the tiles leave room and no run
    # was cut at DW_CHAIN_ROWS
    if p.tiles <= L.SMS and p.run_chunks < L.DW_CHAIN_ROWS * groups // p.br:
        assert p.grid <= L.SMS
    # CTA b: tile b % tiles, run b // tiles; every (tile, run) once
    seen = np.zeros((p.tiles, p.runs), np.int64)
    for b in range(p.grid):
        seen[b % p.tiles, b // p.tiles] += 1
    assert (seen == 1).all()
    # x rows are read by the N tiles, ct rows by the K tiles
    return p.tiles_n, ktiles


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


@pytest.mark.parametrize("name", sorted(F32_RECORDED))
def test_f32_sites_cover_each_row_once_and_fit_shared_memory(name):
    sites = _f32_sites(name)
    assert len(sites) >= 8
    for site in sites:
        _check(site, torch.float32)


@pytest.mark.parametrize("name", sorted(F32_RECORDED))
def test_f32_weight_gradient_reads_each_row_once_where_the_tile_fits(name):
    for R, K, N, _ in _f32_sites(name):
        x_reads, ct_reads = _check_dw(R, K, N)
        if K <= L.DW_KC and N <= L.DW_NC:
            assert (x_reads, ct_reads) == (1, 1)
        else:
            assert x_reads == math.ceil(N / L.DW_NC)
            assert ct_reads == math.ceil(K / L.DW_KC)


def test_f32_weight_gradient_plans_at_3d_sites_and_tails():
    sites = {(R, K, N) for preset in RECORDED for R, K, N, _ in
             _sites(preset)} | {(R, K, N) for R, K, N, _ in TAILS}
    for R, K, N in sorted(sites):
        _check_dw(R, K, N)


def test_the_f32_site_tables_are_the_recorded_sites():
    """The f32 models' distinct (rows, K, N) forward sites are the ones
    ``chip_smoke.py`` checks and times (``twod_mm1x1_cases`` at 256^2,
    ``blessed_mm1x1_cases`` at 32^3)."""
    for name in (chip_smoke.TWOD_VDM, chip_smoke.TWOD_SFM):
        calls, scale, _ = F32_RECORDED[name]
        sites = sorted({(rows * scale, k, n) for rows, k, n, _ in calls})
        assert sites == sorted(chip_smoke.twod_mm1x1_cases())
    assert (16384 * 12, 96, 96) in {(S * 12, k, n) for S, k, n in sites}
    calls, scale, _ = F32_RECORDED[chip_smoke.BLESSED]
    sites = sorted({(rows * scale, k, n) for rows, k, n, _ in calls})
    assert sites == sorted((size ** 3, k, n) for size, k, n in
                           chip_smoke.blessed_mm1x1_cases())


def test_f32_plans_of_the_large_2d_sites():
    """The design's choices where the time is: one slice (x read once)
    wherever the split weight fits, two slices at 192 -> 96 and its dx."""
    p = L.fwd_plan(torch.float32, 786432, 96, 48, True)
    assert (p.slices, p.np, p.bm) == (1, 48, 128)
    p = L.fwd_plan(torch.float32, 196608, 96, 96, True)
    assert (p.slices, p.warps_n, p.bm) == (1, 2, 64)
    for k, n, res in ((192, 96, True), (96, 192, False)):
        assert L.fwd_plan(torch.float32, 196608, k, n, res).slices == 2
    # 384 channels: narrow slices, each warp 32 columns over a quarter of K
    p = L.fwd_plan(torch.float32, 12288, 384, 384, True)
    assert (p.slice_n, p.warps_n, p.warps_k, p.bm) == (32, 1, 4, 32)
    # the widths past the shared memory raise in the wrapper, not at launch
    assert L.fwd_plan(torch.float32, 100, 2048, 8, False).grid == -1


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


def _walk_ring(stages, items):
    """The f32 kernels' cp.async ring, as both walk it: ``stages - 1``
    groups committed up front (items 0 .. stages - 2, empty past the last
    item), then at item j ``cp.async.wait_group(stages - 2)``, a barrier,
    item j + stages - 1 (if any) into stage (j + stages - 1) % stages and
    one commit, then item j read from stage j % stages. Returns the reads
    that find their group still in flight and the refills of a stage whose
    item is still to be read."""
    committed, early, clobbered = [], [], []
    holds = {}  # stage -> item
    for s in range(stages - 1):
        committed.append(s if s < items else None)
        if s < items:
            holds[s] = s
    for j in range(items):
        landed = len(committed) - (stages - 2)  # groups complete after wait
        nxt = j + stages - 1
        if nxt < items:
            stage = nxt % stages
            if stage in holds and holds[stage] >= j:
                clobbered.append((j, stage))
            holds[stage] = nxt
        committed.append(nxt if nxt < items else None)
        if committed.index(j) >= landed or holds[j % stages] != j:
            early.append(j)
    return early, clobbered


@pytest.mark.parametrize("stages", (2, 3, 4))
def test_f32_rings_read_each_item_after_it_lands(stages):
    """Every item (the forward's row tile, dw's chunk) is read after its
    copies landed, and no stage is refilled while its item is unread, at
    every ring depth the plans choose and for runs shorter than the ring."""
    for items in (1, 2, 3, 4, 5, 17):
        assert _walk_ring(stages, items) == ([], [])
    # the plans' depths are among these
    depths = {L.fwd_plan(torch.float32, R, K, N, res).stages
              for R, K, N, res in TAILS} | {
                  L.dw_plan(R, K, N).stages
                  for R, K, N, _ in TAILS}
    assert depths <= {2, 3, 4}
