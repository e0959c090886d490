# Frozen copy of glaze_tpu_torch/ops/texture.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Texture atlas packing (host) and bilinear / trilinear sampling (device).

torch port of :mod:`glaze_tpu.ops.texture`. Level 0 and the mip chain of
every texture are packed into ONE (T, 4) table of RGBA8 texels
(R | G<<8 | B<<16 | A<<24); each row holds the texel AND its 2x2
REPEAT-wrapped bilinear neighbourhood [self, right, down, down-right], so
a bilinear tap is one row gather. sRGB decode happens per texel before
filtering, as Vulkan's *_SRGB formats do.

The packed words are uint32 in the JAX package; here they are the same
bits in an int32 tensor (torch has no uint32 shifts). Channel extraction
``(p >> 8*k) & 0xFF`` reads the same bytes either way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TextureAtlas(NamedTuple):
    texels: torch.Tensor  # (T, 4) int32: packed RGBA8 bits
    offset: torch.Tensor  # (N,) int32 start of level 0
    width: torch.Tensor  # (N,) int32
    height: torch.Tensor  # (N,) int32
    srgb: torch.Tensor  # (N,) float32 1.0 if sRGB encoded
    mip_base: torch.Tensor  # (N,) int32 first row of the mip table
    mip_count: torch.Tensor  # (N,) int32
    mip_offset: torch.Tensor  # (M,) int32
    mip_width: torch.Tensor  # (M,) int32
    mip_height: torch.Tensor  # (M,) int32


def build_atlas_np(textures) -> dict:
    """Packs every :class:`benchmark.ref.core.texture.Texture` (all mip
    levels) into NumPy arrays with the :class:`TextureAtlas` field names;
    ``texels`` is uint32. Texture ids in materials index this list
    directly (id 0 = the default 1x1 white texture)."""
    from benchmark.ref.core.texture import TextureFormat

    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    levels = [[tex.array(k) for k in range(len(tex.data))]
              for tex in textures]
    if not levels:
        one = i32([1])
        return dict(texels=np.full((1, 4), 0xFFFFFFFF, np.uint32),
                    offset=i32([0]), width=one, height=one,
                    srgb=np.asarray([0.0], np.float32),
                    mip_base=i32([0]), mip_count=one,
                    mip_offset=i32([0]), mip_width=one, mip_height=one)
    total = sum(a.shape[0] * a.shape[1] for ls in levels for a in ls)
    out = np.zeros((total, 4), np.uint32)
    offsets, widths, heights, srgbs = [], [], [], []
    mip_base, mip_count = [], []
    mip_offset, mip_width, mip_height = [], [], []
    pos = 0
    for tex, ls in zip(textures, levels):
        gray = tex.format() == TextureFormat.Gray
        mip_base.append(len(mip_offset))
        mip_count.append(len(ls))
        for lvl, arr in enumerate(ls):
            h, w = arr.shape[0], arr.shape[1]
            a = arr.astype(np.uint32)
            if gray:
                packed = a | (a << 8) | (a << 16) | np.uint32(255 << 24)
            else:
                packed = (a[..., 0] | (a[..., 1] << 8) | (a[..., 2] << 16)
                          | (a[..., 3] << 24))
            right = np.roll(packed, -1, axis=1)
            down = np.roll(packed, -1, axis=0)
            down_right = np.roll(right, -1, axis=0)
            out[pos:pos + h * w] = np.stack(
                [packed, right, down, down_right], axis=-1).reshape(-1, 4)
            if lvl == 0:
                offsets.append(pos)
                widths.append(w)
                heights.append(h)
                srgbs.append(1.0 if tex.format() == TextureFormat.RgbaSrgb
                             else 0.0)
            mip_offset.append(pos)
            mip_width.append(w)
            mip_height.append(h)
            pos += w * h
    return dict(texels=out, offset=i32(offsets), width=i32(widths),
                height=i32(heights), srgb=np.asarray(srgbs, np.float32),
                mip_base=i32(mip_base), mip_count=i32(mip_count),
                mip_offset=i32(mip_offset), mip_width=i32(mip_width),
                mip_height=i32(mip_height))


def atlas_from_np(fields: dict, device) -> TextureAtlas:
    """:class:`TextureAtlas` on ``device`` from :func:`build_atlas_np`'s
    arrays; the uint32 texels move as int32 bits."""
    def t(name):
        a = np.array(fields[name], order="C")
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(device)
    return TextureAtlas(*(t(name) for name in TextureAtlas._fields))


def build_atlas(textures, device) -> TextureAtlas:
    return atlas_from_np(build_atlas_np(textures), device)


def srgb_to_linear(c):
    """Per-channel sRGB EOTF (texel decode)."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * c ** (1.0 / 2.4) - 0.055)


_INV255 = float(np.float32(1.0 / 255.0))


def _taps(quad, srgb, channels):
    """Unpacks the 4 bilinear taps of a (R, 4) quad gather into per-tap
    tuples of ``channels`` float channels, sRGB-decoding RGB."""
    taps = []
    for k in range(4):
        p = quad[:, k]
        chans = []
        for c in range(channels):
            x = ((p >> (8 * c)) & 0xFF).to(torch.float32) * _INV255
            if c < 3:
                x = torch.where(srgb, srgb_to_linear(x), x)
            chans.append(x)
        taps.append(chans)
    return taps


def _bilinear(atlas: TextureAtlas, off, w, h, srgb, u, v, channels):
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    x = u * wf - 0.5
    y = v * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.remainder(x0.to(torch.int32), w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    quad = atlas.texels[(off + y0i * w + x0i).long()]
    c00, c10, c01, c11 = _taps(quad, srgb, channels)

    def lerp2(k):
        top = c00[k] * (1.0 - fx) + c10[k] * fx
        bot = c01[k] * (1.0 - fx) + c11[k] * fx
        return top * (1.0 - fy) + bot * fy

    return tuple(lerp2(k) for k in range(channels))


def sample_rgba_v(atlas: TextureAtlas, tex_id, u, v):
    """Bilinear RGBA fetch at mip 0, REPEAT wrap; returns (r, g, b, a)."""
    tex_id = tex_id.long()
    return _bilinear(atlas, atlas.offset[tex_id], atlas.width[tex_id],
                     atlas.height[tex_id], atlas.srgb[tex_id] > 0.5, u, v, 4)


def sample_rgb_v(atlas: TextureAtlas, tex_id, u, v):
    r, g, b, _ = sample_rgba_v(atlas, tex_id, u, v)
    return r, g, b


def sample_r_v(atlas: TextureAtlas, tex_id, u, v):
    return sample_rgba_v(atlas, tex_id, u, v)[0]


def sample_rgb_lod_v(atlas: TextureAtlas, tex_id, u, v, lod):
    """Trilinear fetch: bilinear at floor(lod) and floor(lod)+1 (clamped to
    the texture's chain), lerped. Returns (r, g, b)."""
    tex_id = tex_id.long()
    base = atlas.mip_base[tex_id]
    count = atlas.mip_count[tex_id]
    lod = torch.minimum(torch.clamp(lod, min=0.0),
                        (count - 1).to(torch.float32))
    l0 = torch.floor(lod)
    frac = lod - l0
    l0i = l0.to(torch.int32)
    l1i = torch.minimum(l0i + 1, count - 1)
    srgb = atlas.srgb[tex_id] > 0.5

    def level(li):
        row = (base + li).long()
        return _bilinear(atlas, atlas.mip_offset[row], atlas.mip_width[row],
                         atlas.mip_height[row], srgb, u, v, 3)

    a = level(l0i)
    b = level(l1i)
    return tuple(ca + frac * (cb - ca) for ca, cb in zip(a, b))
