"""Scene "upload": ParsedScene -> :class:`DeviceScene` of torch tensors.

torch port of :mod:`glaze_tpu.scene.flatten`. The host stages are the JAX
package's, on NumPy: instances are flattened to world-space triangles,
per-triangle derivatives computed, the tree(s) that ``GLAZE_TREE``
selects built natively (:func:`glaze_tpu_torch.accel.build_bvh_auto_np`:
classic, fat-leaf, or fat-leaf plus a classic any-hit tree), materials /
lights / textures packed, and the sky importance tables built as
Walker/Vose alias tables. Scenes with opacity maps also get the exact
opacity classification, the opaque/alpha subset trees and the baked 8x8
cell masks (:func:`build_alpha_split`; the masks are baked into a classic
main tree only, a fat one carries none). The result crosses to the device
once, field by field (:func:`device_scene_from_numpy`), where a fat tree
gathers its coefficient table.

Deviations from the reference renderer are the JAX package's, kept so
both packages render the same image: AREA light pdfs use the true
world-space triangle area, and the sky CDF is inverted by exact indexing.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from glaze_tpu_torch.accel import build_bvh_auto_np, tree_from_np
from glaze_tpu_torch.accel.bvh import (
    BVH,
    SENTINEL,
    ChunkedBVH,
    attach_tri_payload,
    build_bvh_chunked_np,
    float_table_to,
    pack_alpha_masks,
)
from glaze_tpu_torch.accel.fat import FAT_KEYS
from glaze_tpu_torch.core import LightType, Texture
from glaze_tpu_torch.core.distribution import Distribution2D
from glaze_tpu_torch.core.spectrum import CIE_Y, INVY_SUM, rgb_to_spectrum_np
from glaze_tpu_torch.ops.texture import TextureAtlas, atlas_from_np, build_atlas_np
from glaze_tpu_torch.utils.runtime import span, traced

# Columns of the fused per-triangle attribute table ``tri_attr`` (N, 34)
ATTR_V0 = 0  # 3: hit-point base
ATTR_E1 = 3  # 3
ATTR_E2 = 6  # 3
ATTR_N0 = 9  # 3 per vertex normal
ATTR_N1 = 12
ATTR_N2 = 15
ATTR_UV0 = 18  # 2 per vertex uv
ATTR_UV1 = 20
ATTR_UV2 = 22
ATTR_GN = 24  # 3: geometric normal
ATTR_DPDU = 27  # 3
ATTR_DPDV = 30  # 3
ATTR_MAT = 33  # 1: material id as float
ATTR_ROWS = 34

# Columns of the material scalar table ``mat_scalars`` (M, MS_ROWS)
MS_IOR = 0
MS_ROUGHNESS_MUL = 1
MS_METALNESS_MUL = 2
MS_ANISOTROPY = 3
MS_IS_SPECULAR = 4
MS_DIFFUSE_R = 5
MS_DIFFUSE_G = 6
MS_DIFFUSE_B = 7
MS_BSDF = 8  # bsdf family as float
MS_MTYPE = 9  # raw MaterialType
MS_ROWS = 10

# Columns of the material texture-id table ``mat_tex`` (M, 5) int32
MT_DIFFUSE = 0
MT_ROUGHNESS = 1
MT_METALNESS = 2
MT_OPACITY = 3
MT_NORMAL = 4

# The field names of glaze_tpu.scene.flatten._SCENE_FIELDS
_SCENE_FIELDS = (
    "bvh",  # BVH, or FatBVH under GLAZE_TREE=fat|hybrid
    "bvh_any",  # the classic any-hit BVH of GLAZE_TREE=hybrid | None
    # the opaque/alpha split of scenes with opacity maps (the reference's
    # per-BLAS OPAQUE flag as two trees), None without opacity maps; the
    # *_map arrays take subset-tree slots to full-tree attribute rows
    "bvh_opaque",  # BVH | None
    "bvh_opaque_map",  # (No,) int32 | None
    "bvh_alpha",  # BVH of the MIXED triangles | None
    "bvh_alpha_map",  # (Na,) int32 | None
    "alpha_attr",  # (Na, 10) int32 alpha-test rows per alpha-tree slot:
    #                uv0/uv1/uv2 (f32 bits), atlas offset, width, height,
    #                srgb flag | None
    "alpha_attr_full",  # (N_bvh, 10) int32, the same rows in full-tree
    #                     order (zero for triangles never texture-tested)
    "alpha_boxes",  # (K, 6) f32 AABBs of the MIXED triangle clusters
    "tri_attr",  # (N, 34) f32 fused shading attributes, see ATTR_*
    "tri_material",  # (N,) int32
    "tri_pos_orig",  # (N0, 9) v0/v1/v2 in original (pre-BVH) order
    "mat_bsdf",  # (M,) int32 family 0..5 (lambert..uber)
    "mat_scalars",  # (M, MS_ROWS) f32
    "mat_tex",  # (M, 5) int32
    "mat_metal_ior",  # (M, 16)
    "mat_metal_fresnel",  # (M, 16) eta^2 + k^2
    "light_type",  # (L,) int32 LightType
    "light_color",  # (L, 16)
    "light_pos",  # (L, 3)
    "light_dir",  # (L, 3) normalized
    "light_intensity",  # (L,)
    "light_tri_first",  # (L,) int32 (original order)
    "light_tri_count",  # (L,) int32
    "light_material",  # (L,) int32
    "light_scalars",  # (L, 8) [type, intensity, tri_first, tri_count, material, 0, 0, 0]
    "lights_no",  # () int32
    "sky_tex",  # () int32, 0 = no sky
    "sky_intensity",  # () f32
    "sky_obj2world",  # (3, 3)
    "sky_world2obj",  # (3, 3)
    "sky_marg_prob", "sky_marg_alias", "sky_marginal_val",
    "sky_marginal_integral", "sky_cond_prob", "sky_cond_alias",
    "sky_cond_val", "sky_cond_integral",
    "sky_marg_rows",  # (H, 4) [prob, alias, val, cond_integral]
    "sky_cond_rows",  # (H*W, 4) [prob, alias, val, 0]
    "sky_cond_n",  # () int32: W
    "atlas",  # TextureAtlas
    "scene_radius",  # ()
    "scene_centre",  # (3,)
    "exposure",  # ()
)

_BVH_KEYS = ("nodes", "tri", "nodes16", "tri8", "n_nodes", "n_tris")
# DeviceScene fields holding a tree; they cross as "<name>.nodes" ...
# (a fat tree as "<name>.leafmat" ... "<name>.leaf_size", see FAT_KEYS; a
# forest as "<name>.chunks" (the chunk count), "<name>.offsets",
# "<name>.n_tris" and chunk i's tables as "<name>.<i>.nodes" ...)
_TREE_FIELDS = ("bvh", "bvh_any", "bvh_opaque", "bvh_alpha")


def _flat_tree(name: str, tree: dict) -> dict:
    """A tree's host tables (a forest's nested) under flat field names."""
    if "chunks" not in tree:
        return {f"{name}.{k}": v for k, v in tree.items()}
    out = {f"{name}.chunks": len(tree["chunks"]),
           f"{name}.offsets": np.asarray(tree["offsets"], np.int64),
           f"{name}.n_tris": int(tree["n_tris"])}
    for i, c in enumerate(tree["chunks"]):
        out.update(_flat_tree(f"{name}.{i}", c))
    return out


def _nested_tree(fields: dict, name: str):
    """The host tables of tree ``name`` from flat field names (the inverse
    of :func:`_flat_tree`), or None when ``fields`` hold no such tree."""
    if f"{name}.chunks" in fields:
        return {"chunks": [_nested_tree(fields, f"{name}.{i}")
                           for i in range(int(fields[f"{name}.chunks"]))],
                "offsets": [int(o) for o in fields[f"{name}.offsets"]],
                "n_tris": int(fields[f"{name}.n_tris"])}
    if f"{name}.nodes" not in fields:
        return None
    keys = FAT_KEYS if f"{name}.leafmat" in fields else _BVH_KEYS
    return {k: fields[f"{name}.{k}"] for k in keys}


class DeviceScene:
    """Scene tables as torch tensors on one device (rows = items). The
    BVH is a :class:`~glaze_tpu_torch.accel.bvh.BVH`, the textures a
    :class:`~glaze_tpu_torch.ops.texture.TextureAtlas`.

    ``mat_families`` / ``light_kinds`` / ``tex_slots`` are host tuples of
    the BSDF families, light types and texture slots the scene uses:
    shading evaluates only those branches, as the JAX package's jitted
    shading specialises on them."""

    __slots__ = _SCENE_FIELDS + ("mat_families", "light_kinds", "tex_slots",
                                 "__weakref__")

    def __init__(self, *, mat_families=None, light_kinds=None,
                 tex_slots=None, **fields):
        for name in _SCENE_FIELDS:
            setattr(self, name, fields.pop(name, None))
        if fields:
            raise TypeError(f"unknown DeviceScene fields: {sorted(fields)}")
        if mat_families is None:
            mat_families = sorted({int(x) for x in self.mat_bsdf.cpu()})
        if light_kinds is None:
            light_kinds = sorted({int(x) for x in self.light_type.cpu()})
        if tex_slots is None:
            mt = self.mat_tex.cpu().numpy()
            tex_slots = [s for s in range(mt.shape[1]) if (mt[:, s] != 0).any()]
        self.mat_families = tuple(mat_families)
        self.light_kinds = tuple(light_kinds)
        self.tex_slots = tuple(tex_slots)

    @property
    def device(self) -> torch.device:
        return self.tri_attr.device

    def to(self, device) -> "DeviceScene":
        """The scene's tables on ``device`` (they move bitwise), or the
        scene itself where it lives already."""
        device = torch.device(device)
        if device == self.device:
            return self
        fields = {}
        for name in _SCENE_FIELDS:
            v = getattr(self, name)
            if name == "atlas":
                v = TextureAtlas(*(t.to(device) for t in v))
            elif v is not None:
                v = v.to(device)
            fields[name] = v
        return DeviceScene(mat_families=self.mat_families,
                           light_kinds=self.light_kinds,
                           tex_slots=self.tex_slots, **fields)

    def _replace(self, **updates):
        """NamedTuple-style copy with overrides (the JAX package's
        ``DeviceScene._replace``): the specialization sets are recomputed
        when their source tables change (material or light edits)."""
        mat_families = None if "mat_bsdf" in updates else self.mat_families
        light_kinds = None if "light_type" in updates else self.light_kinds
        tex_slots = None if "mat_tex" in updates else self.tex_slots
        fields = {n: updates.pop(n, getattr(self, n)) for n in _SCENE_FIELDS}
        if updates:
            raise TypeError(f"unknown DeviceScene fields: {sorted(updates)}")
        return DeviceScene(mat_families=mat_families, light_kinds=light_kinds,
                           tex_slots=tex_slots, **fields)


def compute_derivatives(v0, v1, v2, uv0, uv1, uv2):
    """Per-triangle geometric normal + dpdu/dpdv, vectorized (port of
    generate_derivatives.comp:24-63, with the degenerate-UV fallback)."""
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    dp10 = v1 - v0
    dp20 = v2 - v0
    n = np.cross(dp10, dp20)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-30)

    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    use_x = np.abs(nx) > np.abs(ny)
    denom_x = np.sqrt(np.maximum(nx * nx + nz * nz, 1e-30))
    denom_y = np.sqrt(np.maximum(ny * ny + nz * nz, 1e-30))
    fb_u = np.where(
        use_x[:, None],
        np.stack([-nz, np.zeros_like(nx), nx], 1) / denom_x[:, None],
        np.stack([np.zeros_like(nx), nz, -ny], 1) / denom_y[:, None],
    )
    fb_v = np.cross(n, fb_u)

    dp02 = v0 - v2
    dp12 = v1 - v2
    with np.errstate(divide="ignore", invalid="ignore"):
        invdet = np.where(det == 0.0, 0.0, 1.0 / det)[:, None]
    dpdu = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * invdet
    dpdv = (-duv12[:, 0:1] * dp02 + duv02[:, 0:1] * dp12) * invdet
    bad = (det == 0.0)[:, None]
    dpdu = np.where(bad, fb_u, dpdu)
    dpdv = np.where(bad, fb_v, dpdv)
    return n.astype(np.float32), dpdu.astype(np.float32), dpdv.astype(np.float32)


def flatten_materials(materials):
    """Materials -> row tables (load_raytrace_materials_to_gpu,
    scene.rs:1823-1864)."""
    m = max(len(materials), 1)
    bsdf = np.zeros(m, np.int32)
    scalars = np.zeros((MS_ROWS, m), np.float32)
    scalars[MS_IOR] = 1.46
    scalars[MS_ROUGHNESS_MUL] = 1.0
    scalars[MS_DIFFUSE_R:MS_DIFFUSE_B + 1] = 1.0
    tex = np.zeros((5, m), np.int32)
    metal_ior = np.ones((16, m), np.float32)
    metal_fresnel = np.ones((16, m), np.float32)
    for i, mat in enumerate(materials):
        ior = mat.metal.index_of_refraction()
        k = mat.metal.absorption()
        bsdf[i] = mat.mtype.bsdf_family()
        scalars[MS_IOR, i] = mat.ior
        scalars[MS_ROUGHNESS_MUL, i] = mat.roughness_mul
        scalars[MS_METALNESS_MUL, i] = mat.metalness_mul
        scalars[MS_ANISOTROPY, i] = mat.anisotropy
        scalars[MS_IS_SPECULAR, i] = float(mat.mtype.is_specular())
        scalars[MS_DIFFUSE_R:MS_DIFFUSE_B + 1, i] = (
            np.asarray(mat.diffuse_mul, np.float32) / 255.0
        )
        tex[MT_DIFFUSE, i] = mat.diffuse
        tex[MT_ROUGHNESS, i] = mat.roughness
        tex[MT_METALNESS, i] = mat.metalness
        tex[MT_OPACITY, i] = mat.opacity
        tex[MT_NORMAL, i] = mat.normal
        scalars[MS_BSDF, i] = float(mat.mtype.bsdf_family())
        scalars[MS_MTYPE, i] = float(int(mat.mtype))
        metal_ior[:, i] = ior
        metal_fresnel[:, i] = ior * ior + k * k
    return {
        "mat_bsdf": bsdf,
        "mat_scalars": scalars.T.copy(),
        "mat_tex": tex.T.copy(),
        "mat_metal_ior": metal_ior.T.copy(),
        "mat_metal_fresnel": metal_fresnel.T.copy(),
    }


def reorder_lights(lights):
    """Single SKY light moved last (scene.rs:628-635)."""
    sky = [light for light in lights if light.ltype == LightType.SKY]
    rest = [light for light in lights if light.ltype != LightType.SKY]
    return rest + sky[:1]


def flatten_lights(lights, instance_mat, instance_first, instance_count):
    """Lights -> rows, AREA lights expanded one per instance of their
    material (load_raytrace_lights_to_gpu, scene.rs:1868-1927)."""
    rows = []
    for light in lights:
        d = np.asarray(light.direction, np.float32)
        if not d.any():
            d = np.array([0.0, -1.0, 0.0], np.float32)
        d = d / np.linalg.norm(d)
        base = dict(
            ltype=int(light.ltype),
            color=np.asarray(light.color.wavelength, np.float32),
            pos=np.asarray(light.position, np.float32),
            dir=d,
            intensity=np.float32(light.intensity),
            tri_first=0,
            tri_count=0,
            material=0,
        )
        if light.ltype == LightType.AREA:
            mat_id = int(light.resource_id)
            hit_any = False
            for inst in range(len(instance_mat)):
                if instance_mat[inst] == mat_id:
                    hit_any = True
                    row = dict(base)
                    row["tri_first"] = int(instance_first[inst])
                    row["tri_count"] = int(instance_count[inst])
                    row["material"] = mat_id
                    rows.append(row)
            if not hit_any:
                # reference defaults to instance 0 (scene.rs:1896-1897)
                row = dict(base)
                if len(instance_first):
                    row["tri_first"] = int(instance_first[0])
                    row["tri_count"] = int(instance_count[0])
                row["material"] = mat_id
                rows.append(row)
        else:
            rows.append(base)
    lights_no = len(rows)
    if not rows:
        rows.append(dict(
            ltype=0, color=np.zeros(16, np.float32), pos=np.zeros(3, np.float32),
            dir=np.array([0.0, -1.0, 0.0], np.float32),
            intensity=np.float32(1.0), tri_first=0, tri_count=0, material=0))
    scalars = np.zeros((len(rows), 8), np.float32)
    scalars[:, 0] = [r["ltype"] for r in rows]
    scalars[:, 1] = [r["intensity"] for r in rows]
    scalars[:, 2] = [r["tri_first"] for r in rows]
    scalars[:, 3] = [r["tri_count"] for r in rows]
    scalars[:, 4] = [r["material"] for r in rows]
    return {
        "light_type": np.asarray([r["ltype"] for r in rows], np.int32),
        "light_scalars": scalars,
        "light_color": np.stack([r["color"] for r in rows]).astype(np.float32),
        "light_pos": np.stack([r["pos"] for r in rows]).astype(np.float32),
        "light_dir": np.stack([r["dir"] for r in rows]).astype(np.float32),
        "light_intensity": np.asarray([r["intensity"] for r in rows], np.float32),
        "light_tri_first": np.asarray([r["tri_first"] for r in rows], np.int32),
        "light_tri_count": np.asarray([r["tri_count"] for r in rows], np.int32),
        "light_material": np.asarray([r["material"] for r in rows], np.int32),
        "lights_no": np.int32(lights_no),
    }


def build_alias_tables(weights: np.ndarray):
    """Walker/Vose alias tables for (rows, n) weights (native builder)."""
    from glaze_tpu_torch import native

    return native.get_lib().alias_build(np.ascontiguousarray(weights, np.float32))


def build_sky_tables(lights, textures):
    """Sky importance tables (scene.rs:2191-2232) as alias tables for O(1)
    sampling. tex_id 0 disables the sky (miss radiance and NEE)."""
    sky = next((light for light in lights if light.ltype == LightType.SKY), None)
    if (sky is None or int(sky.resource_id) <= 0
            or int(sky.resource_id) >= len(textures)):
        return {
            "sky_tex": np.int32(0),
            "sky_intensity": np.float32(1.0),
            "sky_obj2world": np.eye(3, dtype=np.float32),
            "sky_world2obj": np.eye(3, dtype=np.float32),
            "sky_marg_prob": np.ones(1, np.float32),
            "sky_marg_alias": np.zeros(1, np.int32),
            "sky_marginal_val": np.ones(1, np.float32),
            "sky_marginal_integral": np.float32(1.0),
            "sky_cond_prob": np.ones(1, np.float32),
            "sky_cond_alias": np.zeros(1, np.int32),
            "sky_cond_val": np.ones(1, np.float32),
            "sky_cond_integral": np.ones(1, np.float32),
            "sky_marg_rows": np.asarray([[1.0, 0.0, 1.0, 1.0]], np.float32),
            "sky_cond_rows": np.asarray([[1.0, 0.0, 1.0, 0.0]], np.float32),
            "sky_cond_n": np.int32(1),
        }
    tex: Texture = textures[int(sky.resource_id)]
    arr = tex.array(0)
    h, w = arr.shape[0], arr.shape[1]
    rgb = np.repeat(arr[..., None], 3, axis=-1) if arr.ndim == 2 else arr[..., :3]
    # luminance of Spectrum::from_rgb(pixel, true) x sin(theta) per row
    # (calculate_skymap_distributions, scene.rs:2191-2210); u8 pixels
    # convert through the sRGB EOTF (color.rs From<[u8;3]>)
    if rgb.dtype == np.uint8:
        cv = np.arange(256, dtype=np.float32) / 255.0
        lut = np.where(cv <= 0.04045, cv / 12.92,
                       ((cv + 0.055) / 1.055) ** 2.4).astype(np.float32)
        lin = lut[rgb]
    else:
        c = rgb.astype(np.float32) / 255.0
        lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    flat = lin.reshape(-1, 3)
    lum = np.zeros(flat.shape[0], np.float32)
    ciey = CIE_Y.astype(np.float32)
    step = 65536
    for s in range(0, flat.shape[0], step):
        spec = rgb_to_spectrum_np(flat[s:s + step], is_light=True)
        lum[s:s + step] = (spec * ciey).sum(-1)
    lum = np.clip(lum.reshape(rgb.shape[:2]) * np.float32(INVY_SUM), 0.0, 1.0)
    sint = np.sin(np.pi * (np.arange(h, dtype=np.float32) + 0.5) / h)
    values = lum * sint[:, None]  # (H, W)
    dist = Distribution2D(values.reshape(-1), w)
    cond_integrals = np.maximum(dist.conditional_integrals(), 1e-20)
    marg_prob, marg_alias = build_alias_tables(cond_integrals[None, :])
    cond_prob, cond_alias = build_alias_tables(values)
    rot = sky.rotation_matrix()[:3, :3].astype(np.float32)
    return {
        "sky_tex": np.int32(sky.resource_id),
        "sky_intensity": np.float32(sky.intensity),
        "sky_obj2world": rot,
        "sky_world2obj": np.linalg.inv(rot).astype(np.float32),
        "sky_marg_prob": marg_prob[0],
        "sky_marg_alias": marg_alias[0],
        "sky_marginal_val": dist.marginal().values().astype(np.float32),
        "sky_marginal_integral": np.float32(max(dist.marginal().integral(), 1e-20)),
        "sky_cond_prob": cond_prob.reshape(-1),
        "sky_cond_alias": cond_alias.reshape(-1),
        "sky_cond_val": dist.conditional_values().astype(np.float32).reshape(-1),
        "sky_cond_integral": cond_integrals.astype(np.float32),
        "sky_marg_rows": np.stack([
            marg_prob[0].astype(np.float32),
            marg_alias[0].astype(np.float32),
            dist.marginal().values().astype(np.float32),
            cond_integrals.astype(np.float32),
        ], axis=1),
        "sky_cond_rows": np.stack([
            cond_prob.reshape(-1).astype(np.float32),
            cond_alias.reshape(-1).astype(np.float32),
            dist.conditional_values().astype(np.float32).reshape(-1),
            np.zeros(h * w, np.float32),
        ], axis=1),
        "sky_cond_n": np.int32(w),
    }


class HostSceneData(NamedTuple):
    """Host-side scene info kept by the renderer (RealtimeScene's CPU
    copies, scene.rs:29-68)."""

    materials: list
    lights: list
    textures: list
    cameras: list
    meta: object
    inst_material: list  # per expanded instance: material id
    inst_tri_first: list  # triangle range in original order
    inst_tri_count: list
    tri_order: object = None  # the tree's padded leaf permutation
    tri_uv: object = None  # (N, 3, 2) f32 original-order uvs


def _opacity_integral(tex):
    """(ii, h, w) opaque-texel integral image of an opacity texture. The
    runtime test is sample_r(...) < 0.5 AFTER any sRGB decode: the decode
    is monotonic, so the texel threshold is its inverse image, 128 raw for
    Gray/Norm and 188 for sRGB."""
    from glaze_tpu_torch.core.texture import TextureFormat

    arr = tex.array(0)
    if arr.ndim == 3:  # alpha-in-gray convention: sample_r reads .r
        arr = arr[..., 0]
    h, w = arr.shape
    thr = 188 if tex.format() == TextureFormat.RgbaSrgb else 128
    opaque_t = (arr >= thr)
    # integral image with one row/col of zeros in front
    ii = np.zeros((h + 1, w + 1), np.int64)
    ii[1:, 1:] = opaque_t.cumsum(0).cumsum(1)
    return ii, h, w


def _classify_alpha_tris(tri_uv, tri_idx, tex):
    """EXACT per-triangle opacity classification: a bilinear sample is a
    convex combination of its 4 texels, so a triangle whose uv footprint
    (+1 texel bilinear support) covers only opaque texels is opaque
    everywhere, only transparent texels transparent everywhere; anything
    else is MIXED and keeps the runtime alpha test. Returns int8 codes per
    triangle: 0 = mixed, 1 = opaque, 2 = transparent."""
    ii, h, w = _opacity_integral(tex)

    def count(y0, y1, x0, x1):
        """# opaque texels in rows [y0, y1) x cols [x0, x1), wrapped."""
        total = 0
        area = 0
        for ya, yb in _wrap_ranges(y0, y1, h):
            for xa, xb in _wrap_ranges(x0, x1, w):
                total += (ii[yb, xb] - ii[ya, xb] - ii[yb, xa] + ii[ya, xa])
                area += (yb - ya) * (xb - xa)
        return total, area

    codes = np.zeros(tri_idx.shape[0], np.int8)
    uvs = tri_uv[tri_idx]  # (K, 3, 2)
    # texel-space footprints (bilinear support: -0.5 offset, +1 margin)
    xs = uvs[..., 0] * w - 0.5
    ys = uvs[..., 1] * h - 0.5
    x0 = np.floor(xs.min(1)).astype(np.int64)
    x1 = np.floor(xs.max(1)).astype(np.int64) + 2
    y0 = np.floor(ys.min(1)).astype(np.int64)
    y1 = np.floor(ys.max(1)).astype(np.int64) + 2
    wide = ((x1 - x0) >= w) | ((y1 - y0) >= h)
    for k in range(tri_idx.shape[0]):
        if wide[k]:
            continue  # footprint wraps the whole texture: mixed
        total, area = count(y0[k], y1[k], x0[k], x1[k])
        if total == area:
            codes[k] = 1
        elif total == 0:
            codes[k] = 2
    return codes


def _wrap_ranges(a, b, n):
    """[a, b) modulo n as at most two in-bounds ranges (b - a < n)."""
    a_m = a % n
    span = b - a
    if a_m + span <= n:
        return [(a_m, a_m + span)]
    return [(a_m, n), (0, a_m + span - n)]


def _classify_alpha_cells(tri_uv, tri_idx, tex, grid=8):
    """EXACT per-CELL opacity classification: each triangle's barycentric
    domain is cut into a ``grid`` x ``grid`` lattice (cell (cu, cv) = u in
    [cu/g, (cu+1)/g] x v in [cv/g, (cv+1)/g], the traversal kernels' cell
    assignment), and each cell is classified by the argument of
    :func:`_classify_alpha_tris`: the uv map is affine in (u, v), so the
    bbox of a cell's four mapped corners (+1 texel bilinear support)
    bounds every bilinear sample the cell can produce. Returns (K,
    grid*grid) int8 codes at cell index cv*grid + cu: 0 = mixed,
    1 = opaque, 2 = transparent."""
    ii, h, w = _opacity_integral(tex)
    total_opaque = int(ii[h, w])
    k = tri_idx.shape[0]
    g = grid
    if k == 0:
        return np.zeros((0, g * g), np.int8)
    uvs = tri_uv[tri_idx].astype(np.float64)  # (K, 3, 2)
    # lattice of barycentric sample points e[a] = a/g: uv is affine, so
    # cell corners are lattice neighbours
    e = np.arange(g + 1, dtype=np.float64) / g
    bu = e[:, None]  # (G+1, 1) broadcast over v index
    bv = e[None, :]
    # (K, G+1, G+1) mapped lattice, texel space with bilinear support
    uv0 = uvs[:, 0][:, None, None]
    uv1 = uvs[:, 1][:, None, None]
    uv2 = uvs[:, 2][:, None, None]
    wgt = (1.0 - bu - bv)[None, :, :, None]
    latt = (uv0 * wgt + uv1 * bu[None, :, :, None]
            + uv2 * bv[None, :, :, None])  # (K, G+1, G+1, 2)
    xs = latt[..., 0] * w - 0.5
    ys = latt[..., 1] * h - 0.5

    def cellwise(a, op):
        return op(op(a[:, :-1, :-1], a[:, 1:, :-1]),
                  op(a[:, :-1, 1:], a[:, 1:, 1:]))

    x0 = np.floor(cellwise(xs, np.minimum)).astype(np.int64)
    x1 = np.floor(cellwise(xs, np.maximum)).astype(np.int64) + 2
    y0 = np.floor(cellwise(ys, np.minimum)).astype(np.int64)
    y1 = np.floor(cellwise(ys, np.maximum)).astype(np.int64) + 2
    wide = ((x1 - x0) >= w) | ((y1 - y0) >= h)
    # periodic 2D prefix count F(y, x) = #opaque in [0,y) x [0,x) of the
    # tiled texture; inclusion-exclusion needs no wrap branching. Shift to
    # nonnegative first (differences are origin-invariant).
    xshift = (max(0, -int(x0.min())) // w + 1) * w
    yshift = (max(0, -int(y0.min())) // h + 1) * h
    x0 += xshift
    x1 += xshift
    y0 += yshift
    y1 += yshift

    def pref(y, x):
        qy, ry = np.divmod(y, h)
        qx, rx = np.divmod(x, w)
        return (qy * (qx * total_opaque + ii[h, rx])
                + qx * ii[ry, w] + ii[ry, rx])

    tot = pref(y1, x1) - pref(y0, x1) - pref(y1, x0) + pref(y0, x0)
    area = (y1 - y0) * (x1 - x0)
    codes = np.zeros((k, g, g), np.int8)
    codes[(tot == area) & ~wide] = 1
    codes[(tot == 0) & ~wide] = 2
    # codes[k, cu, cv] -> cell index cv*g + cu (the kernels' layout)
    return codes.transpose(0, 2, 1).reshape(k, g * g)


def _subset_tree(tri_pos, sel, inv_full):
    """Tree over the ORIGINAL-order triangles ``sel`` (a forest beyond
    CHUNK_MAX_TRIS): (host tree fields, int32 slot -> full-tree row map,
    slot -> original id), or Nones."""
    if sel.size == 0:
        return None, None, None
    fields, order_s = build_bvh_chunked_np(np.ascontiguousarray(tri_pos[sel]))
    sent = order_s == SENTINEL
    local = np.where(sent, 0, order_s).astype(np.int64)
    m = inv_full[sel[local]].astype(np.int32)
    m = np.where(sent, 0, m)  # sentinel slots: degenerate, never hit
    return fields, m, sel[local]


def _alpha_boxes(tri_pos, sel_a):
    """AABBs of <= 64 clusters of the MIXED set (spatial median splits of
    the largest cluster), for the elementwise candidate prefilter."""
    cent = tri_pos[sel_a].mean(axis=1)
    groups = [sel_a]
    while len(groups) < 64:
        sizes = []
        for g in groups:
            ext = (tri_pos[g].reshape(-1, 3).max(0)
                   - tri_pos[g].reshape(-1, 3).min(0))
            sizes.append(float(ext.max()) if g.size else 0.0)
        i = int(np.argmax(sizes))
        g = groups[i]
        if g.size < 32 or sizes[i] <= 0.0:
            break
        c = cent[np.searchsorted(sel_a, g)]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        med = np.median(c[:, axis])
        left = g[c[:, axis] <= med]
        right = g[c[:, axis] > med]
        if left.size == 0 or right.size == 0:
            break
        groups[i] = left
        groups.append(right)
    return np.asarray([
        np.concatenate([tri_pos[g].reshape(-1, 3).min(0),
                        tri_pos[g].reshape(-1, 3).max(0)])
        for g in groups if g.size], np.float32)


@traced("setup.alpha_split")
def build_alpha_split(tri_pos, tri_mat, mat_tex, full_order, sentinel_rows,
                      tri_uv, textures, atlas):
    """Opaque/alpha tree split (acceleration.rs:137-141 OPAQUE-flag
    parity), on the host. Returns a dict of the DeviceScene fields
    ``bvh_opaque``/``bvh_alpha`` (host BVH field dicts), their maps,
    ``alpha_attr``, ``alpha_attr_full``, ``alpha_boxes`` (NumPy or None),
    plus ``_full_payload``: the (N_pad, 4) int32 cell masks of the full
    tree, or None.

    ``tri_pos``: (N, 3, 3) ORIGINAL-order world triangles; ``tri_mat``:
    (N,) material ids; ``mat_tex``: (M, 5) texture table;
    ``full_order``/``sentinel_rows``: the full tree's leaf permutation;
    ``tri_uv``: (N, 3, 2) uvs; ``textures``: the parsed textures;
    ``atlas``: :func:`build_atlas_np`'s dict (the fused alpha-test rows).
    Opacity-mapped triangles are CLASSIFIED exactly: provably opaque ones
    join the opaque tree, provably transparent ones are dropped, and only
    the MIXED boundary triangles form the alpha tree; every triangle of
    the full tree then gets baked 8x8 cell masks (all-OPAQUE,
    all-TRANSPARENT, or real masks for the MIXED set). ``GLAZE_ALPHA_MASK=0``
    bakes none, as in the JAX package: no payload on either tree and no
    full-order alpha rows, so the integrator takes the opaque/alpha
    split."""
    none = {"bvh_opaque": None, "bvh_opaque_map": None,
            "bvh_alpha": None, "bvh_alpha_map": None,
            "alpha_boxes": None, "alpha_attr": None,
            "alpha_attr_full": None, "_full_payload": None}
    n = tri_pos.shape[0]
    if n == 0:
        return none
    tri_mat = np.asarray(tri_mat, np.int64)
    opac_tex = np.asarray(mat_tex)[:, MT_OPACITY]
    has_alpha = (opac_tex != 0)[tri_mat]
    if not has_alpha.any():
        return none

    dropped = np.zeros(n, bool)
    for t in np.unique(opac_tex[opac_tex != 0]):
        sel = np.nonzero(has_alpha & (opac_tex[tri_mat] == t))[0]
        if sel.size == 0 or int(t) >= len(textures):
            continue
        codes = _classify_alpha_tris(tri_uv, sel, textures[int(t)])
        has_alpha[sel[codes == 1]] = False  # provably opaque
        dropped[sel[codes == 2]] = True     # provably transparent
    has_alpha = has_alpha & ~dropped
    if not has_alpha.any() and not dropped.any():
        return none

    # full-tree row of each ORIGINAL tri id
    inv_full = np.zeros(n, np.int64)
    rows = np.nonzero(~sentinel_rows)[0]
    inv_full[full_order[~sentinel_rows]] = rows

    sel_a = np.nonzero(has_alpha)[0]
    sel_o = np.nonzero(~(has_alpha | dropped))[0]
    t_a, m_a, orig_a = _subset_tree(tri_pos, sel_a, inv_full)
    t_o, m_o, _ = _subset_tree(tri_pos, sel_o, inv_full)

    # FULL-TREE payload for the single-walk closest leg: all-OPAQUE cells
    # for opaque / no-alpha triangles (never skipped, never texture-tested),
    # all-TRANSPARENT for provably transparent ones (skipped mid-walk), real
    # 8x8 masks for the MIXED boundary set; none with GLAZE_ALPHA_MASK=0
    masks_on = os.environ.get("GLAZE_ALPHA_MASK", "1") != "0"
    full_payload = None
    if masks_on:
        codes_by_orig = np.zeros((max(sel_a.size, 1), 64), np.int8)
        lut = np.zeros(n, np.int64)  # orig id -> row in codes_by_orig
        lut[sel_a] = np.arange(sel_a.size)
        groups_t = (np.unique(opac_tex[tri_mat[sel_a]]) if sel_a.size
                    else [])
        for t in groups_t:
            if int(t) == 0 or int(t) >= len(textures):
                continue
            sel = sel_a[opac_tex[tri_mat[sel_a]] == t]
            codes_by_orig[lut[sel]] = _classify_alpha_cells(
                tri_uv, sel, textures[int(t)])
        np_pay = np.empty((full_order.shape[0], 4), np.uint32)
        np_pay[:] = np.uint32(0x55555555)  # code 1 (OPAQUE) in all cells
        if sel_a.size:
            np_pay[inv_full[sel_a]] = pack_alpha_masks(
                codes_by_orig[lut[sel_a]]).view(np.uint32)
        if dropped.any():
            np_pay[inv_full[np.nonzero(dropped)[0]]] = np.uint32(0xAAAAAAAA)
        full_payload = np_pay.view(np.int32)

    def attr_rows(origs):
        """(K, 10) int32 fused alpha-test rows (uv as f32 bits, the REAL
        int32 atlas offset, width, height, srgb flag)."""
        k = origs.shape[0]
        a = np.zeros((k, 10), np.int32)
        a[:, 0:6] = (tri_uv[origs].reshape(k, 6)
                     .astype(np.float32).view(np.int32))
        tex_ids = opac_tex[tri_mat[origs]].astype(np.int64)
        a[:, 6] = np.asarray(atlas["offset"])[tex_ids].astype(np.int64)
        a[:, 7] = np.asarray(atlas["width"])[tex_ids].astype(np.int64)
        a[:, 8] = np.asarray(atlas["height"])[tex_ids].astype(np.int64)
        a[:, 9] = np.asarray(atlas["srgb"])[tex_ids] > 0.5
        return a

    attr_full = None
    if masks_on and sel_a.size:
        # only MIXED rows can ever be texture-tested; the rest stay zero
        attr_full = np.zeros((full_order.shape[0], 10), np.int32)
        attr_full[inv_full[sel_a]] = attr_rows(sel_a)

    if t_a is None:
        # classification emptied the re-test set (a fully opaque or fully
        # transparent map)
        return {"bvh_opaque": t_o, "bvh_opaque_map": m_o,
                "bvh_alpha": None, "bvh_alpha_map": None,
                "alpha_boxes": None, "alpha_attr": None,
                "alpha_attr_full": attr_full, "_full_payload": full_payload}

    # alpha TREE payload: the same per-orig cell masks in slot order
    # (leaf-padding slots take orig_a[0]'s mask; their rows are never hit)
    if masks_on:
        t_a = attach_tri_payload(t_a,
                                 pack_alpha_masks(codes_by_orig[lut[orig_a]]))
    return {"bvh_opaque": t_o, "bvh_opaque_map": m_o,
            "bvh_alpha": t_a, "bvh_alpha_map": m_a,
            "alpha_boxes": _alpha_boxes(tri_pos, sel_a),
            "alpha_attr": attr_rows(orig_a),
            "alpha_attr_full": attr_full, "_full_payload": full_payload}


@traced("setup.flatten")
def flatten_scene_np(parsed):
    """Host half of the upload: ParsedScene -> (fields, camera, host).

    ``fields`` maps every DeviceScene field name to NumPy (the BVH as
    ``bvh.nodes`` ... ``bvh.n_tris``, the atlas as ``atlas.texels`` ...),
    the layout :func:`device_scene_from_numpy` reads. The span
    ``setup.flatten`` times it, and ``setup.parse`` its reads of the
    parsed scene's chunks."""
    with span("setup.parse"):
        materials = parsed.materials()
        vertices_np = getattr(parsed, "vertices_np", None)
        meshes = parsed.meshes()
        transforms = parsed.transforms()
        instances = parsed.instances()
        cameras = parsed.cameras()
        textures = parsed.textures()
        lights = reorder_lights(parsed.lights())
        meta = parsed.meta()

        if vertices_np is not None:
            vpos, vnorm, vuv = vertices_np()
        else:
            vertices = parsed.vertices()
            vpos = (np.stack([v.vv for v in vertices]) if vertices
                    else np.zeros((0, 3), np.float32))
            vnorm = (np.stack([v.vn for v in vertices]) if vertices
                     else np.zeros((0, 3), np.float32))
            vuv = (np.stack([v.vt for v in vertices]) if vertices
                   else np.zeros((0, 2), np.float32))

    mesh_by_id = {m.id: m for m in meshes}
    tri_pos, tri_nrm, tri_uv, tri_mat = [], [], [], []
    inst_mat, inst_first, inst_count = [], [], []
    pos = 0
    for inst in instances:
        mesh = mesh_by_id.get(inst.mesh_id)
        if mesh is None:
            continue  # dangling instance (scene.rs:1806-1810)
        t4 = (transforms[inst.transform_id].m
              if inst.transform_id < len(transforms)
              else np.eye(4, dtype=np.float32))
        nmat = np.linalg.inv(t4[:3, :3]).T
        idx = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
        p = vpos[idx] @ t4[:3, :3].T + t4[:3, 3]
        n = vnorm[idx] @ nmat.T
        t_count = idx.shape[0]
        tri_pos.append(p.astype(np.float32))
        tri_nrm.append(n.astype(np.float32))
        tri_uv.append(vuv[idx].astype(np.float32))
        tri_mat.append(np.full(t_count, mesh.material, np.int32))
        inst_mat.append(int(mesh.material))
        inst_first.append(pos)
        inst_count.append(t_count)
        pos += t_count

    if tri_pos:
        tri_pos = np.concatenate(tri_pos)
        tri_nrm = np.concatenate(tri_nrm)
        tri_uv = np.concatenate(tri_uv)
        tri_mat = np.concatenate(tri_mat)
    else:
        # one degenerate placeholder triangle keeps every gather in-bounds
        # (the BVH stores n_tris=0 so it can never be hit)
        tri_pos = np.zeros((1, 3, 3), np.float32)
        tri_nrm = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (1, 3, 1))
        tri_uv = np.zeros((1, 3, 2), np.float32)
        tri_mat = np.zeros(1, np.int32)

    geom_n, dpdu, dpdv = compute_derivatives(
        tri_pos[:, 0], tri_pos[:, 1], tri_pos[:, 2],
        tri_uv[:, 0], tri_uv[:, 1], tri_uv[:, 2],
    )

    # like the JAX package, an empty scene builds its tree over the one
    # degenerate placeholder triangle; GLAZE_TREE picks the tree(s)
    bvh_fields, order, any_fields = build_bvh_auto_np(tri_pos)
    order = np.asarray(order)
    sentinel_rows = order == SENTINEL
    order = np.where(sentinel_rows, 0, order).astype(np.int64)

    mats = flatten_materials(materials)
    atlas = build_atlas_np(textures)
    split = build_alpha_split(tri_pos, tri_mat, mats["mat_tex"], order,
                              sentinel_rows, tri_uv=tri_uv,
                              textures=textures, atlas=atlas)
    # bake the full-tree opacity masks into the main tree, so the single
    # closest walk tests alpha inline (the reference's one TLAS + rahit);
    # a fat tree takes none and the integrator takes the opaque/alpha split
    full_payload = split.pop("_full_payload")
    if full_payload is not None and "leafmat" not in bvh_fields:
        bvh_fields = attach_tri_payload(bvh_fields, full_payload)
    lts = flatten_lights(lights, inst_mat, inst_first, inst_count)
    sky = build_sky_tables(lights, textures)
    camera = cameras[0] if cameras else None

    # fused attribute table in BVH order (see ATTR_*); padding rows zero
    n_bvh = max(len(order), 1)
    attr = np.zeros((n_bvh, ATTR_ROWS), np.float32)

    def bvh_rows(a):
        if not len(order):
            return a[:1]
        out = a[order]
        return np.where(sentinel_rows.reshape((-1,) + (1,) * (a.ndim - 1)),
                        0, out).astype(a.dtype)

    p = bvh_rows(tri_pos)
    nr = bvh_rows(tri_nrm)
    uv = bvh_rows(tri_uv)
    attr[:, ATTR_V0:ATTR_V0 + 3] = p[:, 0]
    attr[:, ATTR_E1:ATTR_E1 + 3] = p[:, 1] - p[:, 0]
    attr[:, ATTR_E2:ATTR_E2 + 3] = p[:, 2] - p[:, 0]
    attr[:, ATTR_N0:ATTR_N0 + 3] = nr[:, 0]
    attr[:, ATTR_N1:ATTR_N1 + 3] = nr[:, 1]
    attr[:, ATTR_N2:ATTR_N2 + 3] = nr[:, 2]
    attr[:, ATTR_UV0:ATTR_UV0 + 2] = uv[:, 0]
    attr[:, ATTR_UV1:ATTR_UV1 + 2] = uv[:, 1]
    attr[:, ATTR_UV2:ATTR_UV2 + 2] = uv[:, 2]
    attr[:, ATTR_GN:ATTR_GN + 3] = bvh_rows(geom_n)
    attr[:, ATTR_DPDU:ATTR_DPDU + 3] = bvh_rows(dpdu)
    attr[:, ATTR_DPDV:ATTR_DPDV + 3] = bvh_rows(dpdv)
    tri_mat_bvh = bvh_rows(tri_mat).astype(np.int32)
    attr[:, ATTR_MAT] = tri_mat_bvh.astype(np.float32)

    fields = _flat_tree("bvh", bvh_fields)
    if any_fields is not None:
        fields.update(_flat_tree("bvh_any", any_fields))
    for name in ("bvh_opaque", "bvh_alpha"):
        tree = split.pop(name)
        if tree is not None:
            fields.update(_flat_tree(name, tree))
    fields.update({k: v for k, v in split.items() if v is not None})
    fields.update({f"atlas.{k}": v for k, v in atlas.items()})
    fields.update(
        tri_attr=attr,
        tri_material=tri_mat_bvh,
        tri_pos_orig=tri_pos.reshape(tri_pos.shape[0], 9),
        scene_radius=np.float32(meta.scene_radius),
        scene_centre=np.asarray(meta.scene_centre, np.float32),
        exposure=np.float32(meta.exposure),
        **mats, **lts, **sky,
    )
    host = HostSceneData(
        materials=list(materials),
        lights=list(lights),
        textures=list(textures),
        cameras=list(cameras),
        meta=meta,
        inst_material=inst_mat,
        inst_tri_first=inst_first,
        inst_tri_count=inst_count,
        tri_order=np.where(sentinel_rows, SENTINEL, order.astype(np.uint32)),
        tri_uv=tri_uv,
    )
    return fields, camera, host


def array_to(a, device) -> torch.Tensor:
    """One NumPy field -> tensor on ``device``. float32 arrays move as int32
    bits (bit-carrier columns cross bitwise); uint32 becomes its int32 bits."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return float_table_to(a, device)
    a = np.array(a, order="C")  # copies; keeps 0-d shapes
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


@traced("setup.upload")
def device_scene_from_numpy(fields: dict, device) -> DeviceScene:
    """Builds the port's :class:`DeviceScene` from NumPy arrays, one field
    at a time: either :func:`flatten_scene_np`'s output or the JAX
    package's flattened scene pulled to NumPy under the same names (each
    tree as ``<name>.nodes`` ... ``<name>.n_tris`` for ``bvh``,
    ``bvh_any``, ``bvh_opaque`` and ``bvh_alpha``, a fat tree with
    ``<name>.leafmat`` and ``<name>.leaf_size`` in place of ``tri8``, a
    forest as ``<name>.chunks``, ``<name>.offsets``, ``<name>.n_tris`` and
    ``<name>.<i>.nodes`` ...; the atlas as ``atlas.texels`` ...). Fields
    absent from ``fields`` are None."""
    device = torch.device(device)
    atlas = atlas_from_np({k: fields[f"atlas.{k}"] for k in TextureAtlas._fields},
                          device)
    plain = {}
    for name in _TREE_FIELDS:
        tree = _nested_tree(fields, name)
        if tree is not None:
            plain[name] = tree_from_np(tree, device)
    for name in _SCENE_FIELDS:
        if name in _TREE_FIELDS or name == "atlas":
            continue
        if fields.get(name) is not None:
            plain[name] = array_to(fields[name], device)
    return DeviceScene(atlas=atlas, **plain)


def _tree_to_np(tree) -> dict:
    """A device tree's host tables (the inverse of ``tree_from_np``)."""
    if isinstance(tree, ChunkedBVH):
        return {"chunks": [_tree_to_np(c) for c in tree.chunks],
                "offsets": list(tree.offsets), "n_tris": tree.n_tris}
    out = {}
    for k in FAT_KEYS if hasattr(tree, "leafmat") else _BVH_KEYS:
        v = getattr(tree, k)
        out[k] = v if isinstance(v, int) else v.cpu().numpy()
    return out


def device_scene_to_numpy(scene: DeviceScene) -> dict:
    """Inverse of :func:`device_scene_from_numpy` (texels as uint32)."""
    out = {}
    for name in _TREE_FIELDS:
        tree = getattr(scene, name)
        if tree is None:
            continue
        out.update(_flat_tree(name, _tree_to_np(tree)))
    for k in TextureAtlas._fields:
        out[f"atlas.{k}"] = getattr(scene.atlas, k).cpu().numpy()
    out["atlas.texels"] = out["atlas.texels"].view(np.uint32)
    for name in _SCENE_FIELDS:
        v = getattr(scene, name)
        if name in _TREE_FIELDS or name == "atlas" or v is None:
            continue
        out[name] = v.cpu().numpy()
    return out


@traced("setup.alpha_split")
def rebuild_alpha_split(scene: DeviceScene, host: HostSceneData) -> dict:
    """The opaque/alpha split of ``scene`` rebuilt from ``host``'s current
    materials and textures (the JAX package's
    ``RayTraceRenderer._refresh_alpha_rounds``), as DeviceScene updates on
    the scene's device: the seven split fields, uploaded as
    :func:`flatten_scene` uploads them, and, where the rebuild bakes cell
    masks and the main tree is classic, ``bvh`` with the new masks. A
    removed map leaves the main tree's old masks in place, as in the JAX
    package: with no alpha rounds no walk reads them."""
    device = scene.device
    tri_pos = scene.tri_pos_orig.cpu().numpy().reshape(-1, 3, 3)
    order = np.asarray(host.tri_order)
    sentinel_rows = order == SENTINEL
    order = np.where(sentinel_rows, 0, order).astype(np.int64)
    tri_mat = np.zeros(tri_pos.shape[0], np.int64)
    for m, f, c in zip(host.inst_material, host.inst_tri_first,
                       host.inst_tri_count):
        tri_mat[f:f + c] = m
    split = build_alpha_split(
        tri_pos, tri_mat, flatten_materials(host.materials)["mat_tex"],
        order, sentinel_rows, tri_uv=host.tri_uv, textures=host.textures,
        atlas=build_atlas_np(host.textures))
    full_payload = split.pop("_full_payload")
    updates = {}
    for name, v in split.items():
        if v is None:
            updates[name] = None
        elif name in _TREE_FIELDS:
            updates[name] = tree_from_np(v, device)
        else:
            updates[name] = array_to(v, device)
    if full_payload is not None and not hasattr(scene.bvh, "leafmat"):
        updates["bvh"] = tree_from_np(
            attach_tri_payload(_tree_to_np(scene.bvh), full_payload), device)
    return updates


def flatten_scene(parsed, device=None):
    """Full upload: ParsedScene -> (DeviceScene, Camera, HostSceneData).
    ``device`` defaults to ``cuda`` and raises without it (see
    :func:`glaze_tpu_torch.device.resolve_device`)."""
    from glaze_tpu_torch.device import resolve_device

    device = resolve_device(device)
    fields, camera, host = flatten_scene_np(parsed)
    return device_scene_from_numpy(fields, device), camera, host


__all__ = ["BVH", "DeviceScene", "HostSceneData", "flatten_scene",
           "flatten_scene_np", "device_scene_from_numpy",
           "device_scene_to_numpy", "flatten_materials", "flatten_lights",
           "build_sky_tables", "compute_derivatives", "array_to",
           "rebuild_alpha_split"]
