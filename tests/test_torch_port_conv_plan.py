"""The launch plans of the two 3x3x3 conv kernels (``ops/kernels/conv3d.py``
``fwd_plan`` / ``dw_plan``, the rules of ``csrc/conv3d_fwd.cu`` and
``csrc/conv3d_dw.cu``; ``chip_smoke.py`` holds them equal to the compiled
sources' on the card): at every conv site the chip run drives, every z mode,
the 32^3 parity model's shapes and its two-plane sharded slabs, and the
channel tails, the bricks cover each output voxel exactly once per output
channel tile, the staged bytes fit a CTA's shared memory, and the dw split
fills the card's SMs wherever the voxels allow it."""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from vdm4cdm_torch.ops.kernels import conv3d as C


def _cdiv(a, b):
    return -(-a // b)


def fwd_tiles(plan, B, D, H, W):
    """Each CTA's output block as (b, (d0, h0, w0), (d1, h1, w1), n0) for a
    brick plan, decoded from its block index as conv3d_fwd.cu decodes it."""
    nbh, nbw = _cdiv(H, plan.tile_h), _cdiv(W, plan.tile_w)
    ntiles = _cdiv(plan.grid_x, _cdiv(D, plan.tile_d) * nbh * nbw)
    for b in range(plan.grid_y):
        for bx in range(plan.grid_x):
            tile, br = bx % ntiles, bx // ntiles
            lo = (br // (nbw * nbh) * plan.tile_d,
                  br // nbw % nbh * plan.tile_h, br % nbw * plan.tile_w)
            hi = tuple(min(o + t, n) for o, t, n in
                       zip(lo, (plan.tile_d, plan.tile_h, plan.tile_w),
                           (D, H, W)))
            yield b, lo, hi, tile * plan.cout_tile


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
    return sites


SITES = _sites()
DTYPES = (torch.bfloat16, torch.float32)
LABELS = ("fwd", "dx", "zhalo_fwd", "zhalo_dx")


def test_the_sites_reach_the_hard_shapes():
    shapes = {(d, cin) for _, _, d, _, _, cin, _, _ in SITES}
    assert (4, 256) in shapes and (2, 256) in shapes  # 4^3 bottom, 2 planes
    assert any(cin == 48 for *_, cin, _, _ in SITES)  # the channel tail
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
    assert plan.smem_bytes <= C.SMEM_LIMIT
    if plan.kind == 0:  # runs of the flattened voxels
        runs = plan.grid_x * plan.tile_w
        assert runs >= D * H * W > runs - plan.tile_w
        assert plan.grid_y * plan.cout_tile >= cout and plan.grid_z == B
        return
    # two CTAs an SM (each also holds 1 KB the card reserves)
    assert 2 * (plan.smem_bytes + 1024) <= 233472
    assert plan.threads == 32 * plan.tile_d  # a warp per brick plane
    n_tiles = math.ceil(cout / plan.cout_tile)
    count = np.zeros((n_tiles, B, D, H, W), np.int32)
    for b, lo, hi, n0 in fwd_tiles(plan, B, D, H, W):
        assert n0 < cout
        count[n0 // plan.cout_tile, b, lo[0]:hi[0], lo[1]:hi[1],
              lo[2]:hi[2]] += 1
    assert (count == 1).all()


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
    assert plan.smem_bytes <= C.SMEM_LIMIT
    if plan.kind == 0:
        assert plan.splits * plan.tile_w >= B * D * H * W
        assert (plan.splits - 1) * plan.tile_w < B * D * H * W
        return
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
