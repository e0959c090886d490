# Frozen copy of glaze_tpu_torch/core/color.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""sRGB / CIE XYZ color types (port of lib/src/geometry/color.rs)."""

from __future__ import annotations

import numpy as np


def srgb_encode_np(linear: np.ndarray) -> np.ndarray:
    """Linear -> sRGB transfer function (color.rs:108-137, vectorized)."""
    linear = np.asarray(linear, dtype=np.float32)
    hi = 1.055 * np.power(np.maximum(linear, 1e-12), 1.0 / 2.4) - 0.055
    lo = linear * 12.92
    return np.maximum(np.where(linear > 0.0031308, hi, lo), 0.0).astype(np.float32)


def srgb_decode_np(srgb: np.ndarray) -> np.ndarray:
    """sRGB -> linear transfer function (color.rs:140-158, vectorized)."""
    srgb = np.asarray(srgb, dtype=np.float32)
    hi = np.power((srgb + 0.055) / 1.055, 2.4)
    lo = srgb / 12.92
    return np.where(srgb > 0.04045, hi, lo).astype(np.float32)


class ColorRGB:
    """A visible color in the sRGB color space, components in [0, 1]."""

    __slots__ = ("r", "g", "b")

    def __init__(self, r: float, g: float, b: float):
        self.r = float(r)
        self.g = float(g)
        self.b = float(b)

    @staticmethod
    def new(r, g, b) -> "ColorRGB":
        return ColorRGB(r, g, b)

    @staticmethod
    def from_u8(col) -> "ColorRGB":
        return ColorRGB(col[0] / 255.0, col[1] / 255.0, col[2] / 255.0)

    def to_u8(self):
        return [
            int(min(max(self.r, 0.0), 1.0) * 255.0),
            int(min(max(self.g, 0.0), 1.0) * 255.0),
            int(min(max(self.b, 0.0), 1.0) * 255.0),
        ]

    def to_xyz(self) -> "ColorXYZ":
        """sRGB -> CIE 1931 XYZ, D65/2deg (color.rs:140-168)."""
        def lin(c):
            return ((c + 0.055) / 1.055) ** 2.4 if c > 0.04045 else c / 12.92

        r, g, b = lin(self.r) * 100.0, lin(self.g) * 100.0, lin(self.b) * 100.0
        x = max(r * 0.4124564 + g * 0.3575761 + b * 0.1804375, 0.0)
        y = max(r * 0.2126729 + g * 0.7151522 + b * 0.0721750, 0.0)
        z = max(r * 0.0193339 + g * 0.119192 + b * 0.9503041, 0.0)
        return ColorXYZ(x, y, z)

    def _coerce(self, o):
        if isinstance(o, ColorRGB):
            return o.r, o.g, o.b
        return float(o), float(o), float(o)

    def __add__(self, o):
        a, b, c = self._coerce(o)
        return ColorRGB(self.r + a, self.g + b, self.b + c)

    def __sub__(self, o):
        a, b, c = self._coerce(o)
        return ColorRGB(self.r - a, self.g - b, self.b - c)

    def __mul__(self, o):
        a, b, c = self._coerce(o)
        return ColorRGB(self.r * a, self.g * b, self.b * c)

    def __truediv__(self, o):
        a, b, c = self._coerce(o)
        return ColorRGB(self.r / a, self.g / b, self.b / c)

    def __repr__(self):
        return f"ColorRGB({self.r}, {self.g}, {self.b})"


class ColorXYZ:
    """A visible color in CIE 1931 XYZ space, components roughly [0, 100]."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: float, y: float, z: float):
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)

    @staticmethod
    def new(x, y, z) -> "ColorXYZ":
        return ColorXYZ(x, y, z)

    def to_rgb(self) -> "ColorRGB":
        """CIE 1931 XYZ -> sRGB with gamma (color.rs:108-137)."""
        x, y, z = self.x / 100.0, self.y / 100.0, self.z / 100.0
        r = x * 3.2404542 + y * -1.5371385 + z * -0.4985314
        g = x * -0.969266 + y * 1.8760108 + z * 0.0415560
        b = x * 0.0556434 + y * -0.2040259 + z * 1.0572252

        def gam(c):
            return 1.055 * c ** (1.0 / 2.4) - 0.055 if c > 0.0031308 else c * 12.92

        return ColorRGB(max(gam(r), 0.0), max(gam(g), 0.0), max(gam(b), 0.0))

    def __repr__(self):
        return f"ColorXYZ({self.x}, {self.y}, {self.z})"
