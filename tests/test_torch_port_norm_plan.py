"""The launch plan of the GroupNorm reductions ``gn_sums`` and
``gn_bwd_sums`` (``ops/kernels/fused_norm.py::sums_plan``), on the CPU: no
Triton, no card. The sites are every norm call a forward of
``trainVDM3D128_c_c`` and of ``trainSFM3D128_c_c`` makes (recorded at a 16^3
crop, scaled to 128^3 at batches 1, 2 and 4), of the trained model
``VDM_GRF_c_c_32`` (8^3, scaled to 32^3 at batches 8 and 12), of the 2D
models ``train_uc_c`` and ``trainSFM_c_uc`` (32^2, scaled to 256^2 at batch
12), a sharded rank's slab (2, 64 or 66 planes of 128^2, 32), the halves of
a decoder join, and row counts with ragged tails. At each: the programs
cover every (batch, row, channel) once; the channel chunk is a power of two
that divides C (a multiple of 4 wherever C is) or the one padded tile of a
width without such a factor; the grid and the partials per (batch, chunk)
stay within the plan's caps. At small shapes a replay of the plan in plain
torch (per-program partials, then the fold in run order) equals the plain
versions in f64, and the chunked Philox counters (the GROUPED arithmetic of
``philox.device_keep`` on ``row_base + c0``) give ``keep_mask_plain``'s
bits."""

import math

import numpy as np
import pytest
import torch

import chip_smoke
import vdm4cdm_torch as vt
from vdm4cdm_torch.ops import norm as ops_norm
from vdm4cdm_torch.ops.kernels import fused_norm as FN
from vdm4cdm_torch.ops.kernels import philox

SMS = 132  # the H100 SXM
ELT = {torch.bfloat16: 2, torch.float32: 4}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One thread for the module's torch work (the replays): beside five
    other test workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _one_thread(fn):
    """fn() with torch on one thread: the recorded forwards are small, and
    the other test workers hold the other cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)


def _record(model, size, nd):
    """The (S at ``size``, C) of every ``gn_apply`` call of one forward (a
    Pair's halves each), the sites of both reductions."""
    calls = []
    real = ops_norm.gn_apply

    def spy(x, a, b, act, p=0.0, seed=0):
        calls.append((x.shape[1], x.shape[2]))
        return real(x, a, b, act, p, seed)

    net = getattr(model, "score_model", None) or model.unet
    gen = torch.Generator().manual_seed(0)
    spatial = (size,) * nd
    z = torch.randn(1, *spatial, net.shape[0], generator=gen)
    s = (torch.randn(1, *spatial, net.s_conditioning_channels, generator=gen)
         if net.s_conditioning_channels else None)
    vs = [torch.randn(1, d, generator=gen) for d in net.v_conditioning_dims]
    ops_norm.gn_apply = spy
    try:
        with torch.no_grad():
            net(z, torch.tensor([0.5]), s_conditioning=s, v_conditionings=vs)
    finally:
        ops_norm.gn_apply = real
    return calls


def _recorded():
    """{model: (its calls, S scale, batches, dtypes)}."""
    out = {}
    for preset in (chip_smoke.VDM_PRESET, chip_smoke.SFM_PRESET):
        model = chip_smoke.build(vt, preset, 16, "float32", "cpu", 0)
        out[preset] = (_record(model, 16, 3), (128 // 16) ** 3, (1, 2, 4),
                       (torch.bfloat16, torch.float32))
    cfg = vt.preset(chip_smoke.BLESSED, **{"data.cropsize": 8})
    out[chip_smoke.BLESSED] = (
        _record(vt.build_model(cfg, device="cpu"), 8, 3), (32 // 8) ** 3,
        (chip_smoke.BLESSED_TRAIN_BATCH, chip_smoke.BLESSED_REPS),
        (torch.float32,))
    for name in (chip_smoke.TWOD_VDM, chip_smoke.TWOD_SFM):
        model, _ = chip_smoke.build_2d(vt, name, 32, "cpu", 0)
        out[name] = (_record(model, 32, 2), (chip_smoke.TWOD_SIZE // 32) ** 2,
                     (chip_smoke.TWOD_BATCH,), (torch.float32,))
    return out


RECORDED = _one_thread(_recorded)


def _sites(name):
    """(B, S, C, dtype) of every reduction launch of a recorded model."""
    calls, scale, batches, dtypes = RECORDED[name]
    return sorted({(b, S * scale, C, dt) for S, C in calls for b in batches
                   for dt in dtypes}, key=str)


# a sharded rank's slab (its own planes, and with the two halo planes); a
# decoder join's halves (chip_smoke's PAIR_CASE and TWOD_PAIR); row counts
# that end inside a block, at the models' widths and the padded 30
OTHER = ([(2, d * 128 ** 2, 32, dt) for d in (64, 66)
          for dt in (torch.bfloat16, torch.float32)]
         + [(2, 32 ** 3, c, dt) for c in (256, 128)
            for dt in (torch.bfloat16, torch.float32)]
         + [(2, 64 ** 2, c, torch.float32) for c in (384, 192)]
         + [(b, s, c, dt) for b in (1, 3) for s in (1, 7, 129, 1000003,
                                                     2 * 32 ** 3 + 5)
            for c in (16, 30, 32, 48, 96, 384)
            for dt in (torch.bfloat16, torch.float32)])


def _run_rows(p, S):
    """The kernels' ``run_rows``: each run's [start, stop) rows."""
    runs = np.arange(p.runs, dtype=np.int64)
    starts = runs * p.row_blocks // p.runs * p.block_s
    stops = np.minimum((runs + 1) * p.row_blocks // p.runs * p.block_s, S)
    return starts, stops


def _check(B, S, C, dtype, kind, sms=SMS):
    elt = ELT[dtype]
    p = FN.sums_plan(B, S, C, elt, sms, kind)
    warps, elems, maxnreg, waves = FN._SUMS_KNOBS[kind, elt]
    # as many programs an SM as its registers hold, in whole waves
    resident = FN._RF_REGS // (maxnreg * 32 * warps)
    assert resident >= 1 and resident * warps <= 64 and maxnreg <= 255
    per_sm = resident * waves
    # the channel chunk
    pow2 = C & -C
    bc = p.block_c
    assert bc & (bc - 1) == 0
    if pow2 >= 4:
        assert not p.padded and C % bc == 0 and bc % 4 == 0
        assert bc * elt <= FN._ROW_CHUNK_BYTES
        assert bc == min(pow2, FN._ROW_CHUNK_BYTES // elt)
        assert p.chunks == C // bc
    else:
        assert p.padded and p.chunks == 1 and bc >= C > bc // 2
    assert p.block_s * bc == elems or (p.block_s == 1 and bc >= elems)
    # the grid: (chunk, run, batch), within the caps
    assert p.grid == (p.chunks, p.runs, B)
    assert 1 <= p.runs <= FN._MAX_RUNS and p.runs <= 65535 and B <= 65535
    programs = math.prod(p.grid)
    assert programs <= max(sms * per_sm, B * p.chunks)
    # beyond one wave of resident programs, whole waves (up to the rounding
    # of runs to the batch and chunks), unless the rows run out first
    wave = sms * resident
    if programs > wave and p.runs < p.row_blocks:
        assert programs % wave == 0 or programs % wave >= wave - B * p.chunks

    assert (p.num_warps, p.num_stages, p.maxnreg) == (warps, FN._SUMS_STAGES,
                                                       maxnreg)
    # runs of whole blocks cover [0, S) once, none empty, their lengths a
    # block apart at most
    assert p.row_blocks == max(1, -(-S // p.block_s)) >= p.runs
    starts, stops = _run_rows(p, S)
    assert (stops > starts).all() or S == 0
    assert starts[0] == 0 and stops[-1] == S
    assert (starts[1:] == stops[:-1]).all()
    blocks = np.diff(np.arange(p.runs + 1) * p.row_blocks // p.runs)
    assert blocks.max() - blocks.min() <= 1
    assert p.fold == (p.runs > 1)
    # the fold reads at most _FOLD_BYTES of partials, a power of two of
    # them a step, as many elements a step as a block of the fold's budget
    assert p.runs * 2 * bc * 4 <= max(FN._FOLD_BYTES, 2 * bc * 4)
    fr = p.fold_rows
    assert fr & (fr - 1) == 0 and fr * bc == max(FN._FOLD_ELEMS, bc)
    assert p.scratch_floats() == (B * p.chunks * p.runs * 2 * bc
                                  if p.fold else 0)
    return p


@pytest.mark.parametrize("name", [chip_smoke.VDM_PRESET, chip_smoke.SFM_PRESET,
                                  chip_smoke.BLESSED, chip_smoke.TWOD_VDM,
                                  chip_smoke.TWOD_SFM])
def test_plans_cover_every_recorded_site_once(name):
    sites = _sites(name)
    assert sites
    for B, S, C, dt in sites:
        for kind in FN.SUMS_KINDS:
            _check(B, S, C, dt, kind)


def test_plans_cover_slabs_pair_halves_and_row_tails():
    for B, S, C, dt in OTHER:
        for kind in FN.SUMS_KINDS:
            for sms in (SMS, 114, 8):
                _check(B, S, C, dt, kind, sms)


def test_the_recorded_widths_are_the_models():
    widths = {name: {C for _, C in RECORDED[name][0]} for name in RECORDED}
    # the 3D models' levels and joins; the 2D models' 48 * 2^k
    assert {32, 64, 128, 256} <= widths[chip_smoke.VDM_PRESET]
    assert widths[chip_smoke.VDM_PRESET] == widths[chip_smoke.SFM_PRESET]
    assert {48, 96, 192, 384} <= widths[chip_smoke.TWOD_VDM]
    assert {16, 32, 48, 64} <= widths[chip_smoke.BLESSED]
    # every 2D width chunks without padding: 48 -> 16, ..., 384 -> 128
    for C in widths[chip_smoke.TWOD_VDM] | widths[chip_smoke.TWOD_SFM]:
        p = FN.sums_plan(12, 256 ** 2, C, 4, SMS)
        assert not p.padded and p.block_c == min(C & -C, 128)


def test_the_2d_sites_no_longer_pad_and_fill_the_card():
    # (12, 128^2, 192) f32 was 12288 programs of one padded 16 x 256 tile
    # and 1024 atomics on each output word
    for kind in FN.SUMS_KINDS:
        warps, _, maxnreg, waves = FN._SUMS_KNOBS[kind, 4]
        per_sm = FN._RF_REGS // (maxnreg * 32 * warps) * waves
        p = FN.sums_plan(12, 128 ** 2, 192, 4, SMS, kind)
        assert (p.block_c, p.chunks, p.padded) == (64, 3, False)
        assert SMS * per_sm * 3 // 4 <= math.prod(p.grid) <= SMS * per_sm
        p = FN.sums_plan(12, 256 ** 2, 96, 4, SMS, kind)
        assert (p.block_c, p.chunks) == (32, 3)
        assert SMS * per_sm * 3 // 4 <= math.prod(p.grid) <= SMS * per_sm


def _replay(p, B, S, C, value):
    """The plan in plain torch, f64: ``value(b, rows, cols)`` gives the two
    summands (B-th batch, a run's rows, a chunk's columns: slices) of each
    element; each program sums its run, and the (b, chunk)'s partials are
    folded in run order, ``fold_rows`` at a time."""
    out = torch.zeros(B, 2, C, dtype=torch.float64)
    bc = p.block_c
    for b in range(B):
        for chunk in range(p.chunks):
            cols = slice(chunk * bc, min((chunk + 1) * bc, C))
            parts = []
            for start, stop in zip(*_run_rows(p, S)):
                rows = slice(int(start), int(stop))
                v1, v2 = value(b, rows, cols)
                parts.append(torch.stack([v1.sum(0), v2.sum(0)]))
            parts = torch.stack(parts)
            acc = torch.zeros_like(parts[0])
            for r0 in range(0, p.runs, p.fold_rows):
                acc = acc + parts[r0:r0 + p.fold_rows].sum(0)
            out[b, :, cols] = acc
    return out


def _chunk_keep(seed, p, S, C, b, rows, chunk, dropout_p):
    """The keep bits a GROUPED program computes for its tile: Philox on
    counters (row_base + c0) / 4 + g (g = 0 .. block_c / 4 - 1), the low
    word's carry into the high word, word j of group g on channel 4 g + j."""
    c0 = chunk * p.block_c
    row_base = (b * S + rows.to(torch.int64)) * C
    qb = (row_base + c0) >> 2
    lo0, hi0 = qb & 0xFFFFFFFF, (qb >> 32) & 0xFFFFFFFF
    cq = torch.arange(p.block_c // 4, dtype=torch.int64)
    lo = (lo0[:, None] + cq[None, :]) & 0xFFFFFFFF
    hi = (hi0[:, None] + (lo < lo0[:, None]).to(torch.int64)) & 0xFFFFFFFF
    zero = torch.zeros_like(lo)
    words = philox.philox_4x32(seed, lo, hi, zero, zero)
    bits = torch.stack(words, -1).reshape(len(rows), p.block_c)
    return bits < philox.keep_threshold(dropout_p)


# small sites where the plan folds (sms 8 or 132) or runs once, chunked and
# padded
REPLAY = [(2, 4096, 32), (3, 1000, 48), (2, 1024, 96), (1, 700, 384),
          (2, 513, 30), (2, 12, 96), (4, 64, 16)]


def _f64_sums(v1, v2):
    return torch.stack([v1.double().sum(1), v2.double().sum(1)], 1)


@pytest.mark.parametrize("B,S,C", REPLAY)
def test_a_replay_of_the_plan_equals_the_plain_sums(B, S, C):
    gen = np.random.default_rng(B * S + C)
    x = torch.from_numpy(gen.normal(0.4, 1.5, (B, S, C)).astype(np.float32))
    xd = x.double()
    ref = _f64_sums(xd, xd * xd)  # gn_sums_plain's arithmetic in f64
    torch.testing.assert_close(FN.gn_sums_plain(x).double(), ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    for sms in (8, SMS):
        for dt in (torch.bfloat16, torch.float32):
            p = FN.sums_plan(B, S, C, ELT[dt], sms)
            assert p == FN.sums_plan(B, S, C, ELT[dt], sms, "sums")
            got = _replay(p, B, S, C, lambda b, r, c: (
                xd[b, r, c], xd[b, r, c] ** 2))
            torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("B,S,C", REPLAY)
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
def test_a_replay_of_the_bwd_plan_equals_the_plain_sums(B, S, C, dropout_p):
    gen = np.random.default_rng(B * S + C + 1)

    def f32(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(gen.normal(loc, scale, shape)
                                .astype(np.float32))

    x, ct = f32(B, S, C, scale=1.5, loc=0.4), f32(B, S, C)
    mean, inv = f32(B, C, scale=0.1, loc=0.4), 1.0 + f32(B, C, scale=0.1)
    a, b = 1.0 + f32(B, C, scale=0.3), f32(B, C, scale=0.2)
    seed = 0x0FEDCBA987654321 ^ (S * C)
    # gn_bwd_sums_plain's elements, summed in f64
    dy, xhat = FN._dy_xhat_plain(x, ct, mean, inv, a, b, True, dropout_p,
                                 seed)
    dy, xhat = dy.double(), xhat.double()
    ref = _f64_sums(dy, dy * xhat)
    plain = FN.gn_bwd_sums_plain(x, ct, mean, inv, a, b, True, dropout_p,
                                 seed)
    torch.testing.assert_close(plain.double(), ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    keep = philox.keep_mask_plain(seed, x.shape, dropout_p, "cpu") \
        if dropout_p else None
    for sms in (8, SMS):
        p = FN.sums_plan(B, S, C, 2, sms,
                         "bwd_dropout" if dropout_p else "bwd")

        def value(bi, rows, cols, p=p):
            if keep is not None and not p.padded:
                # the program's mask from its chunk's counters
                chunk = cols.start // p.block_c
                k = _chunk_keep(seed, p, S, C, bi,
                                torch.arange(rows.start, rows.stop), chunk,
                                dropout_p)
                assert torch.equal(k, keep[bi, rows, cols])
            d = dy[bi, rows, cols]
            return d, d * xhat[bi, rows, cols]

        got = _replay(p, B, S, C, value)
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("C", [48, 96, 192, 384, 32, 256])
def test_chunked_counters_give_the_plain_bits_across_the_low_word(C):
    # rows whose counters cross 2^32 (the carry into the high word) and the
    # batch and chunk offsets of a large stream
    seed = 0x1234567890ABCDEF
    S = (1 << 34) // C + 3
    p = FN.sums_plan(2, S, C, 4, SMS, "bwd_dropout")
    assert not p.padded and p.chunks == C // p.block_c
    rows = torch.tensor([0, 1, S // 2, S // 2 + 1, S - 2, S - 1])
    for b in range(2):
        for chunk in range(p.chunks):
            got = _chunk_keep(seed, p, S, C, b, rows, chunk, 0.1)
            idx = ((b * S + rows[:, None]) * C + chunk * p.block_c
                   + torch.arange(p.block_c)[None, :])
            ref = philox.philox_bits_plain(seed, idx) \
                < philox.keep_threshold(0.1)
            assert torch.equal(got, ref)
