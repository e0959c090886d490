# Frozen copy of glaze_tpu_torch/ops/sobol.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Owen-scrambled Sobol (0,2)-sequence, vectorized for the wavefront (torch).

Port of :mod:`glaze_tpu.ops.sobol`, word for word the same uint32 values
(Burley, "Practical Hash-based Owen Scrambling", JCGT 2020): the i-th
point of pixel p in dimension pair d is

    j   = nested_uniform_scramble(i,  seed(p, d, "shuffle"))
    x   = sobol_dim1(j)   --  van der Corput, reversed bits
    y   = sobol_dim2(j)   --  Pascal-matrix Sobol direction numbers
    u,v = nested_uniform_scramble(x|y, seed(p, d, axis))  *  2^-32

torch has no uint32 arithmetic, so a word is an int64 tensor holding a
value in [0, 2**32), as in :mod:`benchmark.ref.ops.rng`. The hashes
multiply a word by constants up to 0xC7AFE638, whose product reaches
2**64 and would overflow a signed int64: :func:`mul32` splits the
constant into 16-bit halves, so no intermediate passes 2**49, and masks.
Nothing relies on wrap-around. Left shifts are masked too.

Sobol dimension 2 XORs the direction numbers of the index's set bits; the
port reads them from four 256-entry tables (one per index byte) built at
import, four gathers in place of 32 selects, the same words.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

# Sobol direction numbers, dimension 2 (primitive polynomial x+1):
# v[0] = 1000...0b, v[k] = v[k-1] ^ (v[k-1] >> 1), the Pascal matrix mod 2
_V2 = [0x80000000]
for _k in range(1, 32):
    _V2.append((_V2[-1] ^ (_V2[-1] >> 1)) & M32)
# _V2_BYTES[b, v]: XOR of the direction numbers of the set bits of byte
# value v at byte b of the index
_V2_BYTES = np.zeros((4, 256), np.int64)
for _b in range(4):
    for _v in range(256):
        _w = 0
        for _i in range(8):
            if (_v >> _i) & 1:
                _w ^= _V2[8 * _b + _i]
        _V2_BYTES[_b, _v] = _w

_INV32 = float(np.float32(2.3283064365386963e-10))  # 2^-32
# uint32 * 2^-32 in float32 rounds lanes >= 0xFFFFFF80 to exactly 1.0;
# clamp to one-minus-epsilon, as glaze_tpu does
_ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def _u32(x) -> torch.Tensor:
    return x.to(torch.int64) & M32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 words ``x`` (int64) and a constant
    ``c``, with every intermediate below 2**49: x * lo(c) + ((x * hi(c))
    mod 2**16) * 2**16."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def reverse_bits(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse each uint32 lane (O(log n) swaps)."""
    x = _u32(x)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & M32) | (x >> 16)


def _laine_karras(x, seed):
    """Hash permutation whose bit k depends only on bits 0..k-1 (a valid
    per-level Owen flip, Laine & Karras 2011 via Burley 2020)."""
    x = (x + seed) & M32
    x = x ^ mul32(x, 0x6C50B47C)
    x = x ^ mul32(x, 0xB82F1E52)
    x = x ^ mul32(x, 0xC7AFE638)
    x = x ^ mul32(x, 0x8D22F6E6)
    return x


def nested_uniform_scramble(x, seed):
    """Base-2 Owen scramble of a uint32 (bits = binary-tree path)."""
    return reverse_bits(_laine_karras(reverse_bits(x), _u32(seed)))


def _hash(x):
    """Finalizer-quality uint32 hash (for deriving independent seeds)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def seed_keys(pixel_key, domain):
    """(shuffle, owen_u, owen_v) seeds for one sample domain of a pixel.

    ``pixel_key``: uint32 words (int64) identifying the pixel and the
    render; ``domain``: an int or a tensor of uint32 words (0 = jitter,
    1 + 9*bounce + slot = path decisions)."""
    if isinstance(domain, (int, np.integer)):
        mix = (0x9E3779B9 * ((int(domain) + 1) & M32)) & M32
    else:
        mix = mul32((_u32(domain) + 1) & M32, 0x9E3779B9)
    base = _hash(_u32(pixel_key) ^ mix)
    return base, _hash(base ^ 0x85EBCA6B), _hash(base ^ 0xC2B2AE35)


def _to_unit(x):
    return torch.clamp(x.to(torch.float32) * _INV32, max=_ONE_MINUS_EPS)


def _sobol_dim2(j):
    """Sobol dimension 2 of the index words ``j``: the XOR of the
    direction numbers of their set bits, one table gather per byte."""
    tab = torch.as_tensor(_V2_BYTES, device=j.device)
    y = tab[0][j & 0xFF]
    for b in range(1, 4):
        y = y ^ tab[b][(j >> (8 * b)) & 0xFF]
    return y


def sobol02(index, pixel_key, domain):
    """The ``index``-th 2D sample of ``pixel_key``'s ``domain`` stream:
    (u, v) float32 in [0, 1). ``index``: uint32 words per lane."""
    s_shuf, s_u, s_v = seed_keys(pixel_key, domain)
    j = nested_uniform_scramble(_u32(index), s_shuf)
    x = reverse_bits(j)  # Sobol dim 1 (van der Corput)
    y = _sobol_dim2(j)
    u = nested_uniform_scramble(x, s_u)
    v = nested_uniform_scramble(y, s_v)
    return _to_unit(u), _to_unit(v)


def sobol1(index, pixel_key, domain):
    """1D stream: Owen-scrambled van der Corput (single draws such as the
    light pick or the Russian-roulette roll)."""
    s_shuf, s_u, _ = seed_keys(pixel_key, domain)
    j = nested_uniform_scramble(_u32(index), s_shuf)
    u = nested_uniform_scramble(reverse_bits(j), s_u)
    return _to_unit(u)
