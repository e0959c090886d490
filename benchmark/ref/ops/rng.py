# Frozen copy of glaze_tpu_torch/ops/rng.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Counter-free PCG-style hash RNG, vectorized (torch).

Reproduces the reference's RNG chain (``lib/src/shaders/random.glsl:7-58``)
bit for bit with :mod:`glaze_tpu.ops.rng`: a PCG output-permutation hash
over a mutable uint32 state, advanced once per draw. Uniform floats use
the mantissa trick (random mantissa bits OR'd into the exponent of 1.0,
minus 1.0), yielding [0, 1).

torch has no uint32 ``+`` or ``>>``, so a uint32 state is carried in an
int64 tensor holding values in [0, 2**32) and every step masks with
``& 0xFFFFFFFF``. Products stay below 2**62, so nothing overflows.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
MANTISSA_MASK = 0x007FFFFF
FLOAT_ONE = 0x3F800000


def hash_u32(seed: torch.Tensor) -> torch.Tensor:
    """PCG hash (random.glsl:7-12) on uint32 values held in int64."""
    seed = seed.to(torch.int64) & M32
    state = (seed * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def float_bits(v: torch.Tensor) -> torch.Tensor:
    """float32 bit pattern as a uint32 value in int64."""
    return v.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & M32


def srand_f32x3(a, b, c) -> torch.Tensor:
    """Seed from three floats (random.glsl:36-42): hash(x ^ hash(y ^ hash(z)))."""
    x = float_bits(a)
    y = float_bits(b)
    z = float_bits(c)
    return hash_u32(x ^ hash_u32(y ^ hash_u32(z)))


def next_u32(state: torch.Tensor):
    """Advance the state; returns (new_state, random uint32 in int64)."""
    new = hash_u32(state)
    return new, new


def next_f32(state: torch.Tensor):
    """Advance the state; returns (new_state, uniform float32 in [0, 1))."""
    state, bits = next_u32(state)
    flt = (FLOAT_ONE | (bits & MANTISSA_MASK)).to(torch.int32).view(torch.float32)
    return state, flt - 1.0
