"""The launch plans of the two 3x3x3 conv kernels (``ops/kernels/conv3d.py``
``fwd_plan`` / ``dw_plan``, the rules of ``csrc/conv3d_fwd.cu`` and
``csrc/conv3d_dw.cu``; ``chip_smoke.py`` holds them equal to the compiled
sources' on the card): at every conv site the chip run drives, every z mode,
the 32^3 parity model's shapes and its two-plane sharded slabs, the channel
tails and every site of the trained f32 model (``VDM_GRF_c_c_32``), the
bricks cover each output voxel exactly once per output channel tile and K
split, the staged bytes fit a CTA's shared memory, and the dw split fills
the card's SMs wherever the voxels allow it. At the trained model's sites
the f32 tiles divide the channels (no padded output columns) and the
forward fills the card down to the 4^3 level. The f32 forward's cp.async
schedule, walked over every K split of these plans, reads no input chunk
and no weights before their copy has landed."""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from vdm4cdm_torch.ops.kernels import conv3d as C


def _cdiv(a, b):
    return -(-a // b)


def fwd_tiles(plan, B, D, H, W):
    """Each CTA's output block as (b, (d0, h0, w0), (d1, h1, w1), n0, K
    split) for a brick plan, decoded from its block index as conv3d_fwd.cu
    decodes it (the K split fastest, then the Cout tile, then the brick)."""
    nbh, nbw = _cdiv(H, plan.tile_h), _cdiv(W, plan.tile_w)
    ntiles = plan.grid_x // (_cdiv(D, plan.tile_d) * nbh * nbw * plan.ksplit)
    for b in range(plan.grid_y):
        for bx in range(plan.grid_x):
            split, rest = bx % plan.ksplit, bx // plan.ksplit
            tile, br = rest % ntiles, rest // ntiles
            lo = (br // (nbw * nbh) * plan.tile_d,
                  br // nbw % nbh * plan.tile_h, br % nbw * plan.tile_w)
            hi = tuple(min(o + t, n) for o, t, n in
                       zip(lo, (plan.tile_d, plan.tile_h, plan.tile_w),
                           (D, H, W)))
            yield b, lo, hi, tile * plan.cout_tile, split


def dw_runs(plan, B, D, H, W, cin, cout):
    """Each CTA's run of a brick plan as its pieces ((ci0, co0), first
    brick, end brick), the bricks numbered over (b, d, h, w), as
    conv3d_dw.cu cuts the tile-major queue of (tile, brick) items."""
    nb = B * math.prod(_cdiv(n, t) for n, t in
                       zip((D, H, W), (plan.tile_d, plan.tile_h, plan.tile_w)))
    tiles_co = _cdiv(cout, plan.co_tile)
    items = _cdiv(cin, plan.ci_tile) * tiles_co * nb
    for bx in range(plan.grid_x):
        i0, i1 = items * bx // plan.grid_x, items * (bx + 1) // plan.grid_x
        pieces = []
        while i0 < i1:
            tile, b0 = divmod(i0, nb)
            end = min(i1, (tile + 1) * nb)
            pieces.append(((tile // tiles_co * plan.ci_tile,
                            tile % tiles_co * plan.co_tile), b0,
                           end - tile * nb))
            i0 = end
        yield pieces


def _sites():
    """(label, B, out D, H, W, cin, cout, zmode) of every launch: forward,
    dx (cin and cout swapped) and dw, SAME and z-halo."""
    sites = []
    shapes = [(size, size, cin, cout)
              for size, cin, cout, _ in chip_smoke.conv_cases()]
    # the 32^3 parity model's ResBlock convs, level 0 to the 4^3 bottom
    shapes += [(32 >> k, 32 >> k, 32 << k, 32 << k) for k in range(4)]
    for batch in (1, 2, 4):
        for d, hw, cin, cout in shapes:
            sites.append(("fwd", batch, d, hw, hw, cin, cout, 0))
            sites.append(("dx", batch, d, hw, hw, cout, cin, 0))
    slabs = [(local, size, cin, cout)
             for local, size, cin, cout, _ in chip_smoke.zhalo_cases()]
    # the parity model split over two ranks: slabs down to two planes
    slabs += [(16 >> k, 32 >> k, 32 << k, 32 << k) for k in range(4)]
    for local, size, cin, cout in slabs:
        sites.append(("zhalo_fwd", 2, local, size, size, cin, cout, 1))
        sites.append(("zhalo_dx", 2, local + 2, size, size, cout, cin, 2))
    # the trained model: the sampler's batch 12, the train step's 8
    for batch in (8, 12):
        for size, cin, cout in chip_smoke.blessed_conv_cases():
            sites.append(("fwd", batch, size, size, size, cin, cout, 0))
            sites.append(("dx", batch, size, size, size, cout, cin, 0))
    return sites


SITES = _sites()
DTYPES = (torch.bfloat16, torch.float32)
LABELS = ("fwd", "dx", "zhalo_fwd", "zhalo_dx")


def test_the_sites_reach_the_hard_shapes():
    shapes = {(d, cin) for _, _, d, _, _, cin, _, _ in SITES}
    assert (4, 256) in shapes and (2, 256) in shapes  # 4^3 bottom, 2 planes
    assert any(cin == 48 for *_, cin, _, _ in SITES)  # the channel tail
    assert {16, 48} <= {cout for *_, cout, _ in SITES}  # f32 Cout tails
    assert {z for *_, z in SITES} == {0, 1, 2}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("label", LABELS)
def test_forward_tiles_cover_each_output_once(label, dtype):
    sites = [s for s in SITES if s[0] == label]
    assert sites
    for site in sites:
        _check_forward_site(site, dtype)


def _check_forward_site(site, dtype):
    _, B, D, H, W, cin, cout, _ = site
    plan = C.fwd_plan(dtype, B, D, H, W, cin, cout)
    assert plan.kind == 1 and plan.smem_bytes <= C.SMEM_LIMIT
    # two CTAs an SM (each also holds 1 KB the card reserves)
    assert 2 * (plan.smem_bytes + 1024) <= 233472
    assert plan.threads == 32 * plan.tile_d  # a warp per brick plane
    # the K splits each take a non-empty run of the 9 x Cin / 8 steps
    # (an 8-channel chunk against one (kz, kx)); bf16 does not split
    assert 1 <= plan.ksplit <= (9 * cin // 8 if dtype == torch.float32
                                else 1)
    n_tiles = math.ceil(cout / plan.cout_tile)
    count = np.zeros((n_tiles, B, D, H, W), np.int32)
    for b, lo, hi, n0, split in fwd_tiles(plan, B, D, H, W):
        assert n0 < cout and 0 <= split < plan.ksplit
        count[n0 // plan.cout_tile, b, lo[0]:hi[0], lo[1]:hi[1],
              lo[2]:hi[2]] += 1
    assert (count == plan.ksplit).all()


def _dw_sites():
    """(B, D, H, W, cin, cout, zmode) of the dw launches: the forward sites'
    (dw and its z-halo entry take the forward's output shape)."""
    return sorted({(b, d, h, w, cin, cout, z)
                   for label, b, d, h, w, cin, cout, z in SITES
                   if label in ("fwd", "zhalo_fwd")})


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("zmode", (0, 1))
def test_dw_split_covers_each_voxel_once_and_fills_the_card(zmode, dtype):
    sites = [s for s in _dw_sites() if s[-1] == zmode]
    assert sites
    for site in sites:
        _check_dw_site(site, dtype)


def _check_dw_site(site, dtype):
    B, D, H, W, cin, cout, _ = site
    plan = C.dw_plan(dtype, B, D, H, W, cin, cout)
    assert plan.kind == 1 and plan.smem_bytes <= C.SMEM_LIMIT
    nbd, nbh, nbw = (math.ceil(n / t) for n, t in
                     zip((D, H, W), (plan.tile_d, plan.tile_h, plan.tile_w)))
    nb = B * nbd * nbh * nbw
    tiles = math.ceil(cin / plan.ci_tile) * math.ceil(cout / plan.co_tile)
    runs, lengths = {}, []
    for pieces in dw_runs(plan, B, D, H, W, cin, cout):
        lengths.append(sum(r1 - r0 for _, r0, r1 in pieces))
        for tile, r0, r1 in pieces:
            assert tile[0] < cin and tile[1] < cout and r1 > r0
            runs.setdefault(tile, []).append((r0, r1))
    assert len(runs) == tiles
    assert max(lengths) - min(lengths) <= 1  # the SMs get equal work
    for spans in runs.values():  # each tile's runs partition the bricks
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == nb
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # the bricks, numbered over (b, d, h, w) and decoded as the kernel's
    # loader decodes them, cover each voxel once
    count = np.zeros((B, D, H, W), np.int32)
    for bi in range(nb):
        bw, t = bi % nbw, bi // nbw
        bh, t = t % nbh, t // nbh
        bd, bb = t % nbd, t // nbd
        count[bb, bd * plan.tile_d:(bd + 1) * plan.tile_d,
              bh * plan.tile_h:(bh + 1) * plan.tile_h,
              bw * plan.tile_w:(bw + 1) * plan.tile_w] += 1
    assert (count == 1).all()
    # one wave: a CTA an SM, every SM busy where the items allow it
    assert plan.grid_x == plan.splits == min(C.SMS, tiles * nb)


def test_dw_split_follows_the_cards_sm_count():
    small = C.dw_plan(torch.bfloat16, 4, 128, 128, 128, 32, 32, sms=66)
    full = C.dw_plan(torch.bfloat16, 4, 128, 128, 128, 32, 32)
    assert (small.grid_x, full.grid_x) == (66, 132)


def _blessed_plans(batch):
    """(forward, dx, dw) f32 plans at each of the trained model's sites."""
    for size, cin, cout in chip_smoke.blessed_conv_cases():
        shape = (batch, size, size, size)
        yield ((size, cin, cout),
               C.fwd_plan(torch.float32, *shape, cin, cout),
               C.fwd_plan(torch.float32, *shape, cout, cin),
               C.dw_plan(torch.float32, *shape, cin, cout))


@pytest.mark.parametrize("batch", (8, 12))
def test_f32_tiles_divide_the_trained_models_channels(batch):
    """No padded output column at any f32 site of the trained model: the
    forward's Cout tile divides Cout (the dx pass's: Cin), dw's tiles divide
    Cin and Cout; the Cout = 16 and 48 sites take tiles of 16 and 48."""
    tiles = set()
    for (_, cin, cout), fwd, dx, dw in _blessed_plans(batch):
        assert cout % fwd.cout_tile == 0 and cin % dx.cout_tile == 0
        assert cin % dw.ci_tile == 0 and cout % dw.co_tile == 0
        tiles.add((cout, fwd.cout_tile))
    assert (16, 16) in tiles and (48, 48) in tiles


@pytest.mark.parametrize("batch,size", [(12, 4), (12, 8), (1, 16), (8, 16)])
def test_f32_forward_fills_the_card_at_the_small_sites(batch, size):
    """The forward and the dx pass launch a CTA for every SM at the trained
    model's small sites (the sampler's 8^3 and 4^3 levels at batch 12, 16^3
    at batches 1 and 8), splitting the K steps where the bricks x Cout
    tiles alone are fewer; the 32^3 level needs no split."""
    for (s, _, _), fwd, dx, _ in _blessed_plans(batch):
        if s == size:
            for plan in (fwd, dx):
                assert plan.grid_x * plan.grid_y >= C.SMS
                assert plan.ksplit > 1
    for (s, _, _), fwd, dx, _ in _blessed_plans(12):
        if s == 32:
            assert fwd.ksplit == dx.ksplit == 1


def f32_schedule_faults(s0, s1, wait_all_at_chunk_after_first=True):
    """Walks the cp.async groups of ``conv3d_k3s1_f32_kernel`` over its K
    split's steps [s0, s1) (a step: one 8-channel chunk against one (kz,
    kx); chunk c holds steps 9c .. 9c + 8) and returns the reads made
    before their copy had landed: ("x", chunk) where the raw chunk is split,
    ("w", step) where a step's weights are read. The kernel commits {x(s0 //
    9), w(s0)}, then {w(s0 + 1)}, then one group a step: w(s + 2) and, where
    it splits a chunk, the next chunk, issued after the split (the raw
    buffer is single). Each step waits for all but the newest group, and
    for every group at step s0 + 1 where it splits a chunk there (the split
    starts on a chunk's last step); the second argument False drops that
    rule."""
    groups, landed, faults = [], set(), []

    def wait(newest_left):
        for g in groups[:len(groups) - newest_left]:
            landed.update(g)

    groups.append({("x", s0 // 9), ("w", s0)})
    groups.append({("w", s0 + 1)} if s0 + 1 < s1 else set())
    for s in range(s0, s1):
        it = s - s0
        fresh = it == 0 or s % 9 == 0
        wait(0 if (it == 1 and fresh and wait_all_at_chunk_after_first)
             else 1)
        group = set()
        if fresh:
            if ("x", s // 9) not in landed:
                faults.append(("x", s // 9))
            if (s // 9 + 1) * 9 < s1:
                group.add(("x", s // 9 + 1))
        if s + 2 < s1:
            group.add(("w", s + 2))
        groups.append(group)
        if ("w", s) not in landed:
            faults.append(("w", s))
    return faults


def _split_ranges(plan, cin):
    steps = 9 * (cin // 8)
    return [(steps * k // plan.ksplit, steps * (k + 1) // plan.ksplit)
            for k in range(plan.ksplit)]


def test_f32_forward_reads_each_chunk_after_it_lands():
    """Every K split of every f32 forward plan (all sites, z modes and the
    trained model's) reads each input chunk and each step's weights only
    after their copies have landed; the rule that waits for every group at
    a split's second step is what the splits that start on a chunk's last
    step need (the trained model's 4^3 48 -> 64 forward at batch 12: split
    9 starts at step 44)."""
    plans = {(cin, C.fwd_plan(torch.float32, B, D, H, W, cin, cout))
             for _, B, D, H, W, cin, cout, _ in SITES}
    starts = set()
    for cin, plan in plans:
        for s0, s1 in _split_ranges(plan, cin):
            assert s1 > s0
            assert f32_schedule_faults(s0, s1) == [], (cin, plan, s0, s1)
            starts.add(s0 % 9)
    assert 8 in starts  # the case the rule is for is on the path
    plan = C.fwd_plan(torch.float32, 12, 4, 4, 4, 48, 64)
    s0, s1 = _split_ranges(plan, 48)[9]
    assert s0 == 44
    assert f32_schedule_faults(s0, s1, False) == [("x", 5)]


def test_f32_forward_splits_k_only_where_the_reduce_covers_cout():
    """The reduce kernel takes a 4-channel group a thread of 256: a plan
    wider than 1024 output channels keeps one K split, however few CTAs."""
    wide = C.fwd_plan(torch.float32, 1, 4, 4, 4, 64, 2048)
    assert wide.ksplit == 1 and wide.grid_x * wide.grid_y < C.SMS
    edge = C.fwd_plan(torch.float32, 1, 4, 4, 4, 64, 1024)
    assert edge.ksplit > 1
    for _, B, D, H, W, cin, cout, _ in SITES:
        plan = C.fwd_plan(torch.float32, B, D, H, W, cin, cout)
        assert plan.ksplit == 1 or cout <= C.FWD_REDUCE_MAX_COUT


def test_f32_forward_split_follows_the_cards_sm_count():
    """The K split aims at one CTA an SM of the card it runs on."""
    for sms in (66, 132, 144):
        plan = C.fwd_plan(torch.float32, 12, 4, 4, 4, 64, 64, sms=sms)
        assert plan.grid_x * plan.grid_y >= sms
        # and no more splits than that takes
        base = plan.grid_x // plan.ksplit * plan.grid_y
        assert base * (plan.ksplit - 1) < sms


def _sums_rows(plan, B, D, H, W):
    """The workspace row each CTA of a forward plan writes its sums to, by
    (b, Cout tile): its brick, decoded as conv3d_fwd.cu decodes it; for a K
    split, the reduce kernel's CTA of 64 voxels."""
    rows = {}
    if plan.ksplit > 1:
        S = D * H * W
        for b in range(B):
            rows[b, 0] = [v0 // C.FWD_REDUCE_VOX
                          for v0 in range(0, S, C.FWD_REDUCE_VOX)]
        return rows
    nbh, nbw = _cdiv(H, plan.tile_h), _cdiv(W, plan.tile_w)
    for b, lo, _, n0, _ in fwd_tiles(plan, B, D, H, W):
        br = (lo[0] // plan.tile_d * nbh + lo[1] // plan.tile_h) * nbw + \
            lo[2] // plan.tile_w
        rows.setdefault((b, n0), []).append(br)
    return rows


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_sums_fold_takes_each_row_once_in_index_order(dtype):
    """The GroupNorm sums of every forward site (SAME and z-halo, the
    trained model's, the f32 K splits'): each CTA writes one row of the
    workspace (B, T, 2, Cout) and every (batch, Cout tile) writes each of
    the T rows once; the fold's runs, taken in the order their totals are
    added, are the rows 0 .. T - 1 in index order, each once, a segment of
    at least 64 rows (or one), at most 64 segments; the column groups cover
    2 Cout; the workspace holds the rows and the segments' partials."""
    split = 0
    for label, B, D, H, W, cin, cout, _ in SITES:
        if label not in ("fwd", "zhalo_fwd"):
            continue
        fwd = C.fwd_plan(dtype, B, D, H, W, cin, cout)
        plan = C.sums_plan(dtype, B, D, H, W, cin, cout)
        split += fwd.ksplit > 1
        for key, rows in _sums_rows(fwd, B, D, H, W).items():
            assert sorted(rows) == list(range(plan.rows)), (label, key)
        order = [r for _, _, t0, t1 in C.fold_runs(plan)
                 for r in range(t0, t1)]
        assert order == list(range(plan.rows))
        runs = list(C.fold_runs(plan))
        assert [(s, w) for s, w, _, _ in runs] == [
            (s, w) for s in range(plan.segments)
            for w in range(plan.threads // 32)]
        assert 1 <= plan.segments <= C.FOLD_MAX_SEGS
        assert plan.segments == 1 or \
            plan.rows // plan.segments >= C.FOLD_MIN_ROWS
        assert plan.groups * C.FOLD_COLS >= 2 * cout > \
            (plan.groups - 1) * C.FOLD_COLS
        floats, tickets = C.sums_workspace(plan, B, cout)
        assert floats == B * plan.rows * 2 * cout + \
            B * plan.groups * plan.segments * C.FOLD_COLS
        assert tickets == B * plan.groups
    assert split if dtype == torch.float32 else not split


def test_sums_fold_fills_the_card_at_the_large_sites():
    """At the flagship's 128^3 sites the fold's CTAs make about two waves
    of the card (64 segments of 128 bricks at (4, 128^3, 32 -> 32))."""
    plan = C.sums_plan(torch.bfloat16, 4, 128, 128, 128, 32, 32)
    assert plan == C.SumsPlan(8192, 1, 64, 256)
    small = C.sums_plan(torch.bfloat16, 4, 128, 128, 128, 32, 32, sms=16)
    assert small.segments == 8  # two waves of a 16-SM card
