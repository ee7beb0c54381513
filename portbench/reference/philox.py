"""The dropout keep-mask, written out from its definition.

A ResBlock of the UNet drops activations after its second norm's SiLU. The
mask is a defined function of the block's 64-bit seed and the element's flat
index i in the channels-last (B, S, C) stream of that norm's output:

    bits(seed, i) = word (i mod 4) of Philox-4x32-10(key = (seed_lo, seed_hi),
                                     counter = (q_lo, q_hi, 0, 0)),  q = i div 4
    keep(seed, i, p) = bits(seed, i) < min(int((1 - p) * 2^32), 2^32 - 1)

and a kept element is scaled by 1 / (1 - p). A block's seed is
``mix_seed(step_seed, block_index)`` (a splitmix64 finalizer), the step's seed
``mix_seed(generator_seed, step)``. This file is a frozen copy of that
definition in plain integer torch operations, so that the reference needs
nothing of the program to rebuild the masks.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
_CHUNK = 1 << 25  # elements per slice (bounds the int64 temporaries)


def mix_seed(seed: int, index: int) -> int:
    """The seed of site ``index`` under ``seed`` (splitmix64's finalizer)."""
    z = (seed + 0x9E3779B97F4A7C15 * (index + 1)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) words of m * c for words held in int64: the product wraps
    mod 2^64, and an arithmetic shift then a mask still give its high
    word."""
    p = m * c
    return (p >> 32) & _MASK32, p & _MASK32


def _bits(seed: int, index: torch.Tensor) -> torch.Tensor:
    q = index >> 2
    c0, c1 = q & _MASK32, (q >> 32) & _MASK32
    c2 = torch.zeros_like(q)
    c3 = torch.zeros_like(q)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    words = torch.stack((c0, c1, c2, c3))
    return words.gather(0, (index & 3)[None])[0]


def keep_mask(seed: int, shape, p: float, device,
              first: int = 0) -> torch.Tensor:
    """The bool keep-mask of a contiguous tensor of ``shape`` whose first
    element has flat index ``first`` in the stream."""
    n = 1
    for s in shape:
        n *= int(s)
    thresh = min(int((1.0 - p) * 2 ** 32), 2 ** 32 - 1)
    out = torch.empty(n, dtype=torch.bool, device=device)
    for start in range(0, n, _CHUNK):
        stop = min(n, start + _CHUNK)
        idx = torch.arange(first + start, first + stop, dtype=torch.int64,
                           device=device)
        out[start:stop] = _bits(seed & _MASK64, idx) < thresh
    return out.reshape(tuple(shape))
