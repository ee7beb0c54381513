"""The dropout keep-mask as a defined function of (seed, element index, p).

The TPU package draws its dropout mask inside the fused GroupNorm kernels
from the TPU's own generator, seeded per (batch, tile)
(``vdm4cdm_tpu/ops/pallas/fused_norm.py::_dropout_mask``), so its bits depend
on the tiling. Here the mask is a pure function:

    bits(seed, i) = word (i mod 4) of Philox-4x32-10(key = (seed_lo, seed_hi),
                                     counter = (q_lo, q_hi, 0, 0)),  q = i div 4
    keep(seed, i, p) = bits(seed, i) < min(int((1 - p) * 2^32), 2^32 - 1)

with ``seed`` the 64-bit seed of the dropout site and ``i`` the flat index of
the element in its (B, S, C) stream: one Philox call gives the bits of four
consecutive elements. Because nothing depends on tiling, the forward pass and
both backward passes regenerate the same mask and never store it, and the
plain version below (torch integer ops, any device) gives the same bits as
the Triton device function, which the kernels of ``fused_norm.py`` inline.
Where C is a multiple of 4, the four elements of a group are four channels
of one voxel, so a kernel calls Philox once per group (about 25 integer
operations an element) and spreads its words over the group; for other C it
computes the same bits per element.

Seeds are host integers: :func:`mix_seed` derives a site's seed from the
step's seed and the site's index without touching the device.
"""

from __future__ import annotations

import functools

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # Philox-4x32 round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # key increments (Weyl sequence)
_ROUNDS = 10
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
# elements per slice of the plain version (bounds its int64 temporaries)
_PLAIN_CHUNK = 1 << 22


def keep_threshold(p: float) -> int:
    """keep = bits < threshold, for a drop probability p in [0, 1)."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout_p {p} not in [0, 1)")
    return min(int((1.0 - p) * 2 ** 32), 2 ** 32 - 1)


def mix_seed(seed: int, index: int) -> int:
    """A 64-bit seed for site ``index`` under the step seed ``seed``: a
    murmur-style avalanche (the splitmix64 finalizer) on Python ints, so that
    neighbouring steps and sites land on unrelated Philox keys."""
    z = (seed + 0x9E3779B97F4A7C15 * (index + 1)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def seed_words(seed: int):
    """The key words (lo, hi) of a seed as signed 32-bit Python ints, the
    form in which a kernel takes them as scalar arguments."""
    seed &= _MASK64

    def signed(v):
        return v - (1 << 32) if v >= (1 << 31) else v

    return signed(seed & _MASK32), signed(seed >> 32)


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) words of the 64-bit product m * c for uint32 values held in
    int64: the high word from 16-bit halves (no 64-bit overflow), the low
    word from the wrapped product."""
    hi = (m * (c >> 16) + ((m * (c & 0xFFFF)) >> 16)) >> 16
    return hi, (m * c) & _MASK32


def philox_4x32(seed: int, c0, c1, c2, c3):
    """Philox-4x32-10 on uint32 words held in int64 tensors; returns the four
    output words (int64 tensors with values below 2^32)."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(_ROUNDS):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits_plain(seed: int, index: torch.Tensor) -> torch.Tensor:
    """bits(seed, i) for an int64 tensor of element indices: word i mod 4
    of the call on counter i div 4."""
    q = index >> 2
    zero = torch.zeros_like(q)
    words = torch.stack(philox_4x32(seed, q & _MASK32, (q >> 32) & _MASK32,
                                    zero, zero))
    return words.gather(0, (index & 3)[None])[0]


def keep_mask_plain(seed: int, shape, p: float, device) -> torch.Tensor:
    """The bool keep-mask of a contiguous tensor of ``shape``: element i of
    its flat order is kept iff bits(seed, i) < keep_threshold(p)."""
    n = 1
    for s in shape:
        n *= int(s)
    thresh = keep_threshold(p)
    out = torch.empty(n, dtype=torch.bool, device=device)
    for start in range(0, n, _PLAIN_CHUNK):
        stop = min(n, start + _PLAIN_CHUNK)
        idx = torch.arange(start, stop, dtype=torch.int64, device=device)
        out[start:stop] = philox_bits_plain(seed, idx) < thresh
    return out.reshape(tuple(shape))


@functools.cache
def device_keep():
    """The ``@triton.jit`` device function ``keep(offs, row_base, seed_lo,
    seed_hi, thresh, BLOCK_S, BLOCK_C, GROUPED)``: the bool keep block of a
    [BLOCK_S, BLOCK_C] block of elements. ``offs`` holds their int64 flat
    indices, ``row_base`` (BLOCK_S,) the int64 flat index of each row's
    channel 0; the seed words and the threshold are scalar kernel arguments.
    With ``GROUPED`` (C a multiple of 4, so each row's base is too) Philox
    runs once per four channels on a [BLOCK_S, BLOCK_C // 4] block of
    counters, its 32-bit words carried from the row's base without int64
    arithmetic per element, and the four words are interleaved over the
    four channels; otherwise it runs per element on i div 4 and keeps word
    i mod 4."""
    import triton
    import triton.language as tl

    @triton.jit
    def philox(c0, c1, seed_lo, seed_hi):
        c2 = tl.zeros_like(c0)
        c3 = tl.zeros_like(c0)
        m0 = tl.full(c0.shape, 0xD2511F53, tl.uint32)
        m1 = tl.full(c0.shape, 0xCD9E8D57, tl.uint32)
        k0 = tl.zeros_like(c0) + seed_lo.to(tl.uint32)
        k1 = tl.zeros_like(c0) + seed_hi.to(tl.uint32)
        w0 = tl.full(c0.shape, 0x9E3779B9, tl.uint32)
        w1 = tl.full(c0.shape, 0xBB67AE85, tl.uint32)
        for _ in tl.static_range(10):
            p0 = c0
            p2 = c2
            c0 = tl.umulhi(m1, p2) ^ c1 ^ k0
            c2 = tl.umulhi(m0, p0) ^ c3 ^ k1
            c1 = m1 * p2
            c3 = m0 * p0
            k0 = k0 + w0
            k1 = k1 + w1
        return c0, c1, c2, c3

    @triton.jit
    def keep(offs, row_base, seed_lo, seed_hi, thresh,
             BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
             GROUPED: tl.constexpr):
        if GROUPED:
            qb = row_base >> 2
            lo0 = qb.to(tl.uint32)
            hi0 = (qb >> 32).to(tl.uint32)
            cq = tl.arange(0, BLOCK_C // 4).to(tl.uint32)
            lo = lo0[:, None] + cq[None, :]
            hi = hi0[:, None] + (lo < lo0[:, None]).to(tl.uint32)
            b0, b1, b2, b3 = philox(lo, hi, seed_lo, seed_hi)
            # [.., g, a, b] = word 2a + b of group g
            bits = tl.reshape(tl.join(tl.join(b0, b2), tl.join(b1, b3)),
                              [BLOCK_S, BLOCK_C])
        else:
            q = offs >> 2
            b0, b1, b2, b3 = philox(q.to(tl.uint32), (q >> 32).to(tl.uint32),
                                    seed_lo, seed_hi)
            w = offs & 3
            bits = tl.where(w == 0, b0,
                            tl.where(w == 1, b1, tl.where(w == 2, b2, b3)))
        return bits < thresh.to(tl.uint32)

    return keep
