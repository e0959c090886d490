# Frozen copy of glaze_tpu_torch/core/xxh64.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""xxHash64 implementation used by the .glaze file format.

The reference uses ``twox_hash::XxHash64`` with a fixed seed
(``lib/src/parser/v1.rs:40-47``).  This module provides a
pure-Python implementation plus an optional fast path through the native C
extension in :mod:`benchmark.ref.native` (built on demand with g++).
"""

from __future__ import annotations

_MASK = 0xFFFFFFFFFFFFFFFF

_PRIME1 = 0x9E3779B185EBCA87
_PRIME2 = 0xC2B2AE3D27D4EB4F
_PRIME3 = 0x165667B19E3779F9
_PRIME4 = 0x85EBCA77C2B2AE63
_PRIME5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK


def _round(acc: int, inp: int) -> int:
    acc = (acc + inp * _PRIME2) & _MASK
    acc = _rotl(acc, 31)
    return (acc * _PRIME1) & _MASK


def _merge_round(acc: int, val: int) -> int:
    val = _round(0, val)
    acc ^= val
    acc = (acc * _PRIME1 + _PRIME4) & _MASK
    return acc


def xxh64_py(data: bytes, seed: int = 0) -> int:
    """Pure-Python xxHash64 (reference implementation, exact)."""
    length = len(data)
    if length >= 32:
        v1 = (seed + _PRIME1 + _PRIME2) & _MASK
        v2 = (seed + _PRIME2) & _MASK
        v3 = seed & _MASK
        v4 = (seed - _PRIME1) & _MASK
        i = 0
        limit = length - 32
        while i <= limit:
            v1 = _round(v1, int.from_bytes(data[i : i + 8], "little"))
            v2 = _round(v2, int.from_bytes(data[i + 8 : i + 16], "little"))
            v3 = _round(v3, int.from_bytes(data[i + 16 : i + 24], "little"))
            v4 = _round(v4, int.from_bytes(data[i + 24 : i + 32], "little"))
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _MASK
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
    else:
        h = (seed + _PRIME5) & _MASK
        i = 0
    h = (h + length) & _MASK
    # tail
    while i + 8 <= length:
        k1 = _round(0, int.from_bytes(data[i : i + 8], "little"))
        h ^= k1
        h = (_rotl(h, 27) * _PRIME1 + _PRIME4) & _MASK
        i += 8
    if i + 4 <= length:
        h ^= (int.from_bytes(data[i : i + 4], "little") * _PRIME1) & _MASK
        h = (_rotl(h, 23) * _PRIME2 + _PRIME3) & _MASK
        i += 4
    while i < length:
        h ^= (data[i] * _PRIME5) & _MASK
        h = (_rotl(h, 11) * _PRIME1) & _MASK
        i += 1
    # avalanche
    h ^= h >> 33
    h = (h * _PRIME2) & _MASK
    h ^= h >> 29
    h = (h * _PRIME3) & _MASK
    h ^= h >> 32
    return h


_native = None
_native_checked = False


def _get_native():
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from benchmark.ref.native import lib as native_lib

            _native = native_lib
        except Exception:
            _native = None
    return _native


def xxh64(data: bytes, seed: int = 0) -> int:
    """xxHash64 of ``data`` with ``seed``; uses the native library if built."""
    native = _get_native()
    if native is not None:
        return native.xxh64(data, seed)
    return xxh64_py(data, seed)
