# Frozen copy of glaze_tpu_torch/ops/spectra.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Spectral algebra on device, transposed (16, R) layout.

torch counterpart of the ``*_t`` functions of :mod:`glaze_tpu.ops.spectra`:
Smits-style RGB->spectrum with separate reflectance/illuminant bases,
CIE XYZ integration, luminance and the XYZ->linear-RGB matrix. Spectral
bins run along dim 0, rays along dim 1. The tables are the port's own
copy in :mod:`benchmark.ref.core.spectrum`.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.ref.core import spectrum as _cpu
from benchmark.ref.ops import const

SAMPLES = _cpu.SAMPLES
INVY_SUM = float(np.float32(_cpu.INVY_SUM))

CIE_X = np.asarray(_cpu.CIE_X, np.float32)
CIE_Y = np.asarray(_cpu.CIE_Y, np.float32)
CIE_Z = np.asarray(_cpu.CIE_Z, np.float32)
SURFACE_BASIS = np.asarray(_cpu.SURFACE_BASIS, np.float32)  # (7, 16)
ILLUMINANT_BASIS = np.asarray(_cpu.ILLUMINANT_BASIS, np.float32)
SURFACE_SCALE = float(np.float32(_cpu.SURFACE_SCALE))
ILLUMINANT_SCALE = float(np.float32(_cpu.ILLUMINANT_SCALE))

# XYZ -> linear sRGB (spectrum.glsl:74-81)
XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float32,
)
_CIE_COLS = {k: v.reshape(SAMPLES, 1).copy()
             for k, v in (("x", CIE_X), ("y", CIE_Y), ("z", CIE_Z))}
_SURF_COLS = [SURFACE_BASIS[i].reshape(SAMPLES, 1).copy() for i in range(7)]
_ILLUM_COLS = [ILLUMINANT_BASIS[i].reshape(SAMPLES, 1).copy() for i in range(7)]


def one_t(r: int, device) -> torch.Tensor:
    return torch.ones((SAMPLES, r), dtype=torch.float32, device=device)


def uniform_t(f: torch.Tensor) -> torch.Tensor:
    """(R,) scalar field -> flat spectrum (16, R)."""
    return f[None, :].expand((SAMPLES,) + tuple(f.shape))


def from_rgb_t(r, g, b, is_light: bool) -> torch.Tensor:
    """Smits RGB->spectrum on (R,) channels -> (16, R)."""
    cols = _ILLUM_COLS if is_light else _SURF_COLS
    white, cyan, magenta, yellow, red, green, blue = (
        const(c, r.device) for c in cols)

    m1 = (r <= g) & (r <= b)
    m1a = g <= b
    branch1 = r * white + torch.where(
        m1a, (g - r) * cyan + (b - g) * blue, (b - r) * cyan + (g - b) * green
    )
    m2 = (g <= r) & (g <= b)
    m2a = r <= b
    branch2 = g * white + torch.where(
        m2a, (r - g) * magenta + (b - r) * blue, (b - g) * magenta + (r - b) * red
    )
    m3a = r <= g
    branch3 = b * white + torch.where(
        m3a, (r - b) * yellow + (g - r) * green, (g - b) * yellow + (r - g) * red
    )
    res = torch.where(m1, branch1, torch.where(m2, branch2, branch3))
    scale = ILLUMINANT_SCALE if is_light else SURFACE_SCALE
    return torch.clamp(res * scale, 0.0, 1.0)


def from_surface_color_t(r, g, b) -> torch.Tensor:
    return from_rgb_t(r, g, b, is_light=False)


def from_illuminant_color_t(r, g, b) -> torch.Tensor:
    return from_rgb_t(r, g, b, is_light=True)


def to_xyz_t(sp: torch.Tensor):
    """(16, R) -> 3x(R,)."""
    d = sp.device
    x = torch.sum(sp * const(_CIE_COLS["x"], d), dim=0)
    y = torch.sum(sp * const(_CIE_COLS["y"], d), dim=0)
    z = torch.sum(sp * const(_CIE_COLS["z"], d), dim=0)
    return x * INVY_SUM, y * INVY_SUM, z * INVY_SUM


def luminance_t(sp: torch.Tensor) -> torch.Tensor:
    """(16, R) -> (R,), unclamped like GLSL."""
    return torch.sum(sp * const(_CIE_COLS["y"], sp.device), dim=0) * INVY_SUM


def to_rgb_t(sp: torch.Tensor):
    """(16, R) -> 3x(R,) linear RGB."""
    x, y, z = to_xyz_t(sp)
    m = [[float(v) for v in row] for row in XYZ_TO_RGB]
    r = m[0][0] * x + m[0][1] * y + m[0][2] * z
    g = m[1][0] * x + m[1][1] * y + m[1][2] * z
    b = m[2][0] * x + m[2][1] * y + m[2][2] * z
    return r, g, b
