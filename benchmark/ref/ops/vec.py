# Frozen copy of glaze_tpu_torch/ops/vec.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Structure-of-arrays 3-vectors: tuples of (R,) component tensors.

The same layout as :mod:`glaze_tpu.ops.vec`, so the port's public
functions take and return what the JAX package's do.
"""

from __future__ import annotations

import torch


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def neg(a):
    return (-a[0], -a[1], -a[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a, eps=1e-20):
    inv = 1.0 / torch.clamp(length(a), min=eps)
    return scale(a, inv)


def where(mask, a, b):
    return tuple(torch.where(mask, ai, bi) for ai, bi in zip(a, b))


def reflect(i, n):
    """GLSL reflect: i - 2 dot(n,i) n."""
    d = dot(n, i)
    return sub(i, scale(n, 2.0 * d))


def refract(i, n, eta):
    """GLSL refract; returns the zero vector on total internal reflection."""
    ndi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    ok = k >= 0.0
    coef = eta * ndi + torch.sqrt(torch.clamp(k, min=0.0))
    r = sub(scale(i, eta), scale(n, coef))
    zero = torch.zeros_like(r[0])
    return where(ok, r, (zero, zero, zero))
