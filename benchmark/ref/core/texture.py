# Frozen copy of glaze_tpu_torch/core/texture.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Textures with mip chains (port of lib/src/materials/texture.rs).

Pixel data is stored as NumPy uint8 arrays: (H, W) for grayscale, (H, W, 4)
for RGBA. Mip generation uses a Catmull-Rom-family cubic filter (PIL BICUBIC),
matching the reference's ``FilterType::CatmullRom``.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np
from PIL import Image


class TextureFormat(Enum):
    """Available texture pixel formats (texture.rs:53-67)."""

    Gray = "Gray"
    RgbaNorm = "RgbaNorm"
    RgbaSrgb = "RgbaSrgb"

    @staticmethod
    def values():
        return [TextureFormat.Gray, TextureFormat.RgbaNorm, TextureFormat.RgbaSrgb]

    def str(self) -> str:
        return {
            TextureFormat.Gray: "Gray",
            TextureFormat.RgbaNorm: "Rgba (linear)",
            TextureFormat.RgbaSrgb: "Rgba (sRGB)",
        }[self]

    @property
    def channels(self) -> int:
        return 1 if self == TextureFormat.Gray else 4


@dataclass
class TextureInfo:
    """Metadata about a texture (texture.rs:10-22)."""

    name: str = ""
    width: int = 0
    height: int = 0
    format: TextureFormat = TextureFormat.RgbaSrgb


def ilog2(x: int) -> int:
    """log2 of a power of two (texture.rs:282-291)."""
    return int(x).bit_length() - 1


def _resize(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    img = Image.fromarray(arr)
    return np.asarray(img.resize((w, h), Image.BICUBIC))


def gen_mipmaps_np(img: np.ndarray) -> list[np.ndarray]:
    """Full mip chain for a power-of-two image (texture.rs:256-277)."""
    h, w = img.shape[0], img.shape[1]
    assert w & (w - 1) == 0, "texture width must be a power of 2"
    assert h & (h - 1) == 0, "texture height must be a power of 2"
    levels = 1 + ilog2(max(w, h))
    mips = [img]
    for _ in range(1, levels):
        w = max(1, w >> 1)
        h = max(1, h >> 1)
        mips.append(_resize(mips[-1], w, h))
    return mips


class Texture:
    """An RGBA or grayscale texture, possibly with a mip chain."""

    def __init__(self, info: TextureInfo, data: list[np.ndarray]):
        self.info = info
        self.data = [np.ascontiguousarray(d, dtype=np.uint8) for d in data]

    # -- constructors --------------------------------------------------------
    @staticmethod
    def new_gray(info: TextureInfo, data: np.ndarray) -> "Texture":
        assert info.format == TextureFormat.Gray
        return Texture(info, [data])

    @staticmethod
    def new_gray_with_mipmaps(info: TextureInfo, data: list[np.ndarray]) -> "Texture":
        assert info.format == TextureFormat.Gray
        return Texture(info, data)

    @staticmethod
    def new_rgba(info: TextureInfo, data: np.ndarray) -> "Texture":
        assert info.format in (TextureFormat.RgbaSrgb, TextureFormat.RgbaNorm)
        return Texture(info, [data])

    @staticmethod
    def new_rgba_with_mipmaps(info: TextureInfo, data: list[np.ndarray]) -> "Texture":
        assert info.format in (TextureFormat.RgbaSrgb, TextureFormat.RgbaNorm)
        return Texture(info, data)

    @staticmethod
    def default() -> "Texture":
        """1x1 white sRGB texture (texture.rs:236-253)."""
        info = TextureInfo("default", 1, 1, TextureFormat.RgbaSrgb)
        return Texture(info, [np.full((1, 1, 4), 255, np.uint8)])

    # -- accessors -----------------------------------------------------------
    def name(self) -> str:
        return self.info.name

    def raw(self, level: int) -> bytes:
        return self.data[level].tobytes()

    def array(self, level: int) -> np.ndarray:
        return self.data[level]

    def dimensions(self, level: int):
        w, h = self.info.width, self.info.height
        return (max(1, w >> level), max(1, h >> level))

    def format(self) -> TextureFormat:
        return self.info.format

    def mipmap_levels(self) -> int:
        return len(self.data)

    def max_mipmap_levels(self) -> int:
        return 1 + ilog2(max(self.info.width, self.info.height))

    def bytes_per_pixel(self) -> int:
        return self.info.format.channels

    def size_bytes(self, level: int) -> int:
        w, h = self.dimensions(level)
        return w * h * self.bytes_per_pixel()

    def has_mipmaps(self) -> bool:
        return self.mipmap_levels() == self.max_mipmap_levels()

    def gen_mipmaps(self):
        if not self.has_mipmaps():
            base = self.data[-1]
            self.data = gen_mipmaps_np(base)

    def __eq__(self, other):
        return (
            isinstance(other, Texture)
            and self.info == other.info
            and len(self.data) == len(other.data)
            and all(np.array_equal(a, b) for a, b in zip(self.data, other.data))
        )
