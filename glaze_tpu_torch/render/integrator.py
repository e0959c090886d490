"""The wavefront path-tracing integrator, SoA (torch).

Port of the main path of :mod:`glaze_tpu.render.integrator` (the
reference's ``path_trace.rgen``): one :func:`launch_step` advances EVERY
pixel's light path by exactly one bounce. ``draw(spp)`` runs
``spp * PT_STEPS`` launches; the DIRECT integrator is the same step with
``direct_only=True``. Every launch increments every pixel's sample count
and adds that launch's NEE / miss radiance (update_count/update_result,
path_trace.rgen:119-133); the image is ``rgb(sum) * exposure / count``.

Layout: the pixel axis is the last one. Positions/directions are
(x, y, z) tuples of (P,) tensors, spectra are (16, P). Lanes run in the
tile-swizzled pixel order of the JAX package (:func:`pixel_coords_np`),
so states and images compare lane for lane.

Each launch makes two traces: the closest hit of the path rays
(:func:`trace_alpha_sorted`) and the NEE shadow rays
(:func:`_any_hit_sorted`, or :func:`_occlusion_sorted` with opacity
maps), both Morton-sorted for coherence and both on the CUDA kernels when
the scene lives on the card. The closest hit walks ``scene.bvh`` (a
fat-leaf tree under ``GLAZE_TREE=fat|hybrid``), the shadow rays the
classic ``scene.bvh_any`` of a hybrid scene, else ``scene.bvh``.

Opacity maps (``alpha_rounds > 0``; raytrace_hit.rahit semantics: a hit
whose opacity sample is < 0.5 is skipped) take one of three branches,
chosen from what the scene carries:

- the FULL MASKED TREE (``scene.bvh`` with baked 8x8 cell masks and
  ``alpha_attr_full``, i.e. the scene has MIXED triangles): one masked
  walk skips TRANSPARENT cells in the kernel; only MIXED-cell hits pay the
  exact texture re-test rounds. Shadow rays take the 3-state masked any
  hit, and only their pending lanes walk the small alpha tree;
- the OPAQUE/ALPHA SPLIT (a scene without the full payload: a fat-leaf
  main tree, which carries none, or one the JAX package flattened with
  ``GLAZE_ALPHA_MASK=0``): an unmasked walk of the opaque tree plus a
  walk of the alpha tree, for shadow rays too;
- the WHOLE-SCENE RE-TRACE loop, when classification left no MIXED
  triangle (``alpha_attr_full`` and ``bvh_alpha`` are None).

The port reads none of the JAX package's environment switches and takes
their defaults: ``GLAZE_ALPHA_PREFIX`` = 1.0 (no candidates-first sort key,
the re-test rounds run at full width), ``GLAZE_ALPHA_MASK`` on,
``GLAZE_ALPHA_ROUNDS`` = 1 (the renderer's round count).

Not ported in this slice (they raise): the ``ld`` sampler, adaptive lane
masks and more than one sample in flight per pixel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from glaze_tpu_torch import accel
from glaze_tpu_torch.ops import rng as rng_mod
from glaze_tpu_torch.ops import shading
from glaze_tpu_torch.ops import spectra
from glaze_tpu_torch.ops import texture as tx
from glaze_tpu_torch.ops import vec
from glaze_tpu_torch.render import bsdf as bsdf_mod
from glaze_tpu_torch.render import lights as lights_mod
from glaze_tpu_torch.scene import flatten as fl

PT_STEPS = 6  # raytrace_structures.rs:87
RUSSIAN_ROULETTE = PT_STEPS // 2  # path_trace.rgen:11
INV_2PI = float(np.float32(0.1591549))
INV_PI = float(np.float32(0.3183099))

# Lanes are tile-swizzled: each TILE_W x TILE_H block of pixels is 2048
# consecutive lanes (the JAX package's traversal packet).
TILE_W = 128
TILE_H = 16


class PathState(NamedTuple):
    """Per-pixel path state + accumulation image; every leaf's LAST axis
    is the lane axis."""

    importance: torch.Tensor  # (16, P)
    origin: tuple  # 3 x (P,)
    direction: tuple  # 3 x (P,)
    bounce: torch.Tensor  # (P,) float32
    last_specular: torch.Tensor  # (P,) float32
    accum: tuple  # 3 x (P,) RGB radiance sum
    count: torch.Tensor  # (P,) float32 sample count
    path_no: torch.Tensor  # (P,) int64 camera-path index (uint32 values)
    sq: torch.Tensor  # (P,) sum of squared per-launch luminance


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not yet ported to glaze_tpu_torch")


def init_state(width: int, height: int, device, sif: int = 1) -> PathState:
    if sif != 1:
        _not_ported("samples in flight > 1")
    p = pixel_count(width, height)

    def z():
        return torch.zeros((p,), dtype=torch.float32, device=device)

    return PathState(
        importance=torch.zeros((16, p), dtype=torch.float32, device=device),
        origin=(z(), z(), z()),
        direction=(z(), z(), z()),
        bounce=z(),
        last_specular=z(),
        accum=(z(), z(), z()),
        count=z(),
        path_no=torch.zeros((p,), dtype=torch.int64, device=device),
        sq=z(),
    )


def camera_matrices(camera, width: int, height: int):
    """(camera2world, screen2camera) push constants as float32 NumPy
    (build_push_constants, raytracer.rs:1098-1120)."""
    view_inv = np.linalg.inv(camera.look_at_rh()).astype(np.float32)
    proj = camera.projection(width, height).copy()
    proj[1, 1] *= -1.0  # Vulkan clip-space flip
    proj_inv = np.linalg.inv(proj).astype(np.float32)
    return view_inv, proj_inv


def resolve_coherent(mode) -> int:
    """'off'/'frame'/'tile' or 0/1/2 -> int."""
    if isinstance(mode, str):
        try:
            mode = {"off": 0, "frame": 1, "tile": 2}[mode]
        except KeyError:
            raise ValueError(
                f"coherent mode {mode!r}: expected off, frame or tile"
            ) from None
    mode = int(mode)
    if mode not in (0, 1, 2):
        raise ValueError("coherent mode must be 0 (off), 1 (frame) or "
                         "2 (tile)")
    return mode


def padded_dims(width: int, height: int):
    pw = -(-width // TILE_W) * TILE_W
    ph = -(-height // TILE_H) * TILE_H
    return pw, ph


def pixel_count(width: int, height: int) -> int:
    pw, ph = padded_dims(width, height)
    return pw * ph


def pixel_coords_np(width: int, height: int):
    """Tile-swizzled (px, py) int32 NumPy coords over the padded grid."""
    pw, ph = padded_dims(width, height)
    i = np.arange(pw * ph, dtype=np.int64)
    tiles_x = pw // TILE_W
    tile = i // (TILE_W * TILE_H)
    within = i % (TILE_W * TILE_H)
    px = (tile % tiles_x) * TILE_W + within % TILE_W
    py = (tile // tiles_x) * TILE_H + within // TILE_W
    return px.astype(np.int32), py.astype(np.int32)


def _pixel_coords_t(width: int, height: int, device):
    """:func:`pixel_coords_np` computed on ``device``: (px, py) int64."""
    pw, ph = padded_dims(width, height)
    i = torch.arange(pw * ph, dtype=torch.int64, device=device)
    tiles_x = pw // TILE_W
    tile = i // (TILE_W * TILE_H)
    within = i % (TILE_W * TILE_H)
    px = (tile % tiles_x) * TILE_W + within % TILE_W
    py = (tile // tiles_x) * TILE_H + within // TILE_W
    return px, py


def pixel_coords(width: int, height: int, device):
    """Tile-swizzled (px, py) float32 lane coordinates, each (P,), built
    on ``device``."""
    px, py = _pixel_coords_t(width, height, device)
    return px.to(torch.float32), py.to(torch.float32)


def camera_rays(ndc_x, ndc_y, cam2world, screen2cam, is_persp: bool):
    """Primary ray origins/directions (path_trace.rgen:47-74), SoA.
    ``cam2world``/``screen2cam``: float32 NumPy 4x4."""
    c = [[float(v) for v in row] for row in np.asarray(cam2world, np.float32)]
    s = [[float(v) for v in row] for row in np.asarray(screen2cam, np.float32)]
    one = torch.ones_like(ndc_x)
    if is_persp:
        origin = (c[0][3] * one, c[1][3] * one, c[2][3] * one)
        tgt = (
            s[0][0] * ndc_x + s[0][1] * ndc_y + s[0][2] + s[0][3],
            s[1][0] * ndc_x + s[1][1] * ndc_y + s[1][2] + s[1][3],
            s[2][0] * ndc_x + s[2][1] * ndc_y + s[2][2] + s[2][3],
        )
    else:
        origin = (
            c[0][0] * ndc_x + c[0][1] * ndc_y + c[0][3],
            c[1][0] * ndc_x + c[1][1] * ndc_y + c[1][3],
            c[2][0] * ndc_x + c[2][1] * ndc_y + c[2][3],
        )
        tgt = tuple(float(np.float32(s[i][2]) + np.float32(s[i][3])) * one
                    for i in range(3))
    tgt = vec.normalize(tgt)
    direction = vec.normalize((
        c[0][0] * tgt[0] + c[0][1] * tgt[1] + c[0][2] * tgt[2],
        c[1][0] * tgt[0] + c[1][1] * tgt[1] + c[1][2] * tgt[2],
        c[2][0] * tgt[0] + c[2][1] * tgt[1] + c[2][2] * tgt[2],
    ))
    return origin, direction


def _sky_radiance(scene, direction):
    """Environment lookup on a miss (path_trace.rgen:76-84) -> (r, g, b)."""
    m = scene.sky_world2obj
    w = vec.normalize((
        m[0, 0] * direction[0] + m[0, 1] * direction[1] + m[0, 2] * direction[2],
        m[1, 0] * direction[0] + m[1, 1] * direction[1] + m[1, 2] * direction[2],
        m[2, 0] * direction[0] + m[2, 1] * direction[1] + m[2, 2] * direction[2],
    ))
    phi = torch.atan2(w[1], w[0])
    theta = torch.acos(torch.clamp(w[2], -1.0, 1.0))
    u = phi * INV_2PI
    v = theta * INV_PI
    tex = torch.broadcast_to(scene.sky_tex, phi.shape)
    return tx.sample_rgb_v(scene.atlas, tex, u, v)


def _interpolate_hit(scene, hit):
    """The closest-hit shader (raytrace_hit.rchit): barycentric attribute
    interpolation + normal mapping, from one fused row gather."""
    tri = torch.clamp(hit["tri"], min=0).long()
    bu = hit["u"]
    bv = hit["v"]
    bw = 1.0 - bu - bv
    a = scene.tri_attr[tri]  # (R, 34)

    def v3_at(col):
        return (a[:, col], a[:, col + 1], a[:, col + 2])

    v0 = v3_at(fl.ATTR_V0)
    e1 = v3_at(fl.ATTR_E1)
    e2 = v3_at(fl.ATTR_E2)
    point = vec.add(v0, vec.add(vec.scale(e1, bu), vec.scale(e2, bv)))

    n0 = v3_at(fl.ATTR_N0)
    n1 = v3_at(fl.ATTR_N1)
    n2 = v3_at(fl.ATTR_N2)
    shading_n = vec.normalize(vec.add(
        vec.scale(n0, bw), vec.add(vec.scale(n1, bu), vec.scale(n2, bv))))
    u = bw * a[:, fl.ATTR_UV0] + bu * a[:, fl.ATTR_UV1] + bv * a[:, fl.ATTR_UV2]
    v = (bw * a[:, fl.ATTR_UV0 + 1] + bu * a[:, fl.ATTR_UV1 + 1]
         + bv * a[:, fl.ATTR_UV2 + 1])

    geom_n = v3_at(fl.ATTR_GN)
    dpdu = v3_at(fl.ATTR_DPDU)
    mat_id = a[:, fl.ATTR_MAT].to(torch.int32)

    # normal mapping (rchit:55-64), only when some material has a map
    if fl.MT_NORMAL in scene.tex_slots:
        normal_tex = scene.mat_tex[mat_id.long()][:, fl.MT_NORMAL]
        has_nm = normal_tex != 0
        tr, tg, tb = tx.sample_rgb_v(scene.atlas, normal_tex, u, v)
        s_old = vec.normalize(dpdu)
        t_old = vec.normalize(vec.cross(shading_n, s_old))
        nx, ny, nz = tr * 2.0 - 1.0, tg * 2.0 - 1.0, tb * 2.0 - 1.0
        mapped = vec.normalize((
            s_old[0] * nx + t_old[0] * ny + shading_n[0] * nz,
            s_old[1] * nx + t_old[1] * ny + shading_n[1] * nz,
            s_old[2] * nx + t_old[2] * ny + shading_n[2] * nz,
        ))
        mapped = vec.scale(mapped, torch.sign(vec.dot(geom_n, mapped)))
        shading_n = vec.where(has_nm, mapped, shading_n)

    return {
        "point": point,
        "shading_normal": shading_n,
        "geom_normal": geom_n,
        "dpdu": dpdu,
        "uv": (u, v),
        "material_id": mat_id,
    }


def _spread3(x):
    """Spreads 5-bit ints so bits land 3 apart (Morton interleave)."""
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    x = (x | (x << 2)) & 0x1249
    return x


def _trace_perm(scene, origin, direction, active=None):
    """Stable coherence sort for a trace phase: [inactive last | direction
    octant | 15-bit origin Morton]. Stability keeps pixel-tile order
    within equal keys. The sort changes only the order rays are traced
    in, never a result."""
    key = ((direction[0] >= 0).to(torch.int32)
           | ((direction[1] >= 0).to(torch.int32) << 1)
           | ((direction[2] >= 0).to(torch.int32) << 2))
    lo = scene.scene_centre - scene.scene_radius
    inv = 31.0 / torch.clamp(2.0 * scene.scene_radius, min=1e-20)
    m = torch.zeros_like(key)
    for i in range(3):
        # clamp in float first: out-of-range float->int casts are undefined
        q = torch.nan_to_num(torch.clamp((origin[i] - lo[i]) * inv, 0.0, 31.0))
        m = m | (_spread3(q.to(torch.int32)) << i)
    key = (key << 15) | m
    if active is not None:
        key = key | torch.where(active, 0, 1 << 19).to(torch.int32)
    return torch.argsort(key, stable=True)


def _inverse_perm(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _perm_rows(perm, arrays):
    """Applies ``perm`` to each (R,) tensor (plain indexing)."""
    return [a[perm] for a in arrays]


def _hit_alpha(scene, hit):
    """Opacity-map alpha at a hit (raytrace_hit.rahit semantics): 1.0 where
    the material has no opacity texture."""
    tri = torch.clamp(hit["tri"], min=0).long()
    a = scene.tri_attr[tri]
    bu = hit["u"]
    bv = hit["v"]
    bw = 1.0 - bu - bv
    u = bw * a[:, fl.ATTR_UV0] + bu * a[:, fl.ATTR_UV1] + bv * a[:, fl.ATTR_UV2]
    v = (bw * a[:, fl.ATTR_UV0 + 1] + bu * a[:, fl.ATTR_UV1 + 1]
         + bv * a[:, fl.ATTR_UV2 + 1])
    mat_id = a[:, fl.ATTR_MAT].to(torch.int64)
    opacity_tex = scene.mat_tex[mat_id][:, fl.MT_OPACITY]
    alpha = tx.sample_r_v(scene.atlas, opacity_tex, u, v)
    return torch.where(opacity_tex != 0, alpha, torch.ones_like(alpha))


def _cap(t_max, like):
    """(R,) float32 cap: ``t_max`` broadcast, or +inf for None."""
    if t_max is None:
        return torch.full(like.shape, float("inf"), dtype=torch.float32,
                          device=like.device)
    return torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=like.device),
        like.shape)


def _cull_beyond(hit, cap):
    """Hits beyond ``cap`` become misses (t = inf, tri = -1)."""
    beyond = hit["t"] > cap
    return {"t": torch.where(beyond, torch.full_like(hit["t"], float("inf")),
                             hit["t"]),
            "tri": torch.where(beyond, torch.full_like(hit["tri"], -1),
                               hit["tri"]),
            "u": hit["u"], "v": hit["v"]}


def _alpha_candidates(scene, origin, direction, cap):
    """Lanes whose segment [T_MIN, cap] can touch alpha-tested geometry:
    slab tests against the (few) MIXED-cluster AABBs
    (``scene.alpha_boxes``). A miss here PROVES the alpha tree is
    irrelevant for the lane."""
    boxes = scene.alpha_boxes
    inv = []
    for i in range(3):
        tiny = torch.abs(direction[i]) < 1e-20
        inv.append(torch.where(
            tiny, torch.full_like(direction[i], 1e20),
            1.0 / torch.where(tiny, torch.ones_like(direction[i]),
                              direction[i])))
    out = torch.zeros(origin[0].shape, dtype=torch.bool,
                      device=origin[0].device)
    for b in range(boxes.shape[0]):
        tn = torch.full(origin[0].shape, 1e-4, dtype=torch.float32,
                        device=origin[0].device)
        tf = cap
        for i in range(3):
            t0 = (boxes[b, i] - origin[i]) * inv[i]
            t1 = (boxes[b, i + 3] - origin[i]) * inv[i]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        out = out | (tn <= tf)
    return out


def _remap_hit(hit, tri_map):
    """Subset-tree slot ids -> full-tree attribute rows (misses stay -1)."""
    tri = hit["tri"]
    g = tri_map[torch.clamp(tri, min=0).long()]
    return dict(hit, tri=torch.where(tri >= 0, g, torch.full_like(g, -1)))


def _miss_hit(r, device):
    z = torch.zeros((r,), dtype=torch.float32, device=device)
    return {"t": torch.full((r,), float("inf"), dtype=torch.float32,
                            device=device),
            "tri": torch.full((r,), -1, dtype=torch.int32, device=device),
            "u": z, "v": z}


def _hit_alpha_attr(scene, attr, hit):
    """Opacity at a masked-walk hit from a fused (rows, 10) int32 table
    (``alpha_attr`` in alpha-tree slot order or ``alpha_attr_full`` in
    full-tree row order): one attribute gather and one atlas quad gather.
    The math is :func:`_hit_alpha`'s (bilinear .r with sRGB decode); uv
    columns are f32 bits, the atlas offset (col 6) a real int32."""
    slot = torch.clamp(hit["tri"], min=0).long()
    a = attr[slot]

    def fcol(i):
        return a[:, i].contiguous().view(torch.float32)

    bu = hit["u"]
    bv = hit["v"]
    bw = 1.0 - bu - bv
    u = bw * fcol(0) + bu * fcol(2) + bv * fcol(4)
    v = bw * fcol(1) + bu * fcol(3) + bv * fcol(5)
    # zero rows (alpha_attr_full's never-tested triangles) are only reached
    # by lanes whose alpha is discarded; clamp the extents so their dead
    # arithmetic stays finite
    wi = torch.clamp(a[:, 7], min=1)
    hi = torch.clamp(a[:, 8], min=1)
    w = wi.to(torch.float32)
    h = hi.to(torch.float32)
    srgb = a[:, 9] > 0
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.remainder(x0.to(torch.int32), wi)
    y0i = torch.remainder(y0.to(torch.int32), hi)
    quad = scene.atlas.texels[(a[:, 6] + y0i * wi + x0i).long()]
    sc = float(np.float32(1.0 / 255.0))

    def tap(k):
        r = (quad[:, k] & 0xFF).to(torch.float32) * sc
        return torch.where(srgb, tx.srgb_to_linear(r), r)

    c00, c10, c01, c11 = tap(0), tap(1), tap(2), tap(3)
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def _alpha_retest_rounds(origin, direction, cap, hit, alpha_rounds: int,
                         walk, alpha_fn):
    """The exact-texture re-test loop over a closest-hit dict: a hit whose
    opacity (``alpha_fn(hit)``) is < 0.5 re-traces with ``walk(o, d,
    cap)`` from just past it. Hits of a masked walk carry ``mixed`` flags
    and only MIXED-cell hits are tested (the baked masks resolved the rest
    in the walk); hits of an unmasked walk are all tested."""
    o = origin
    offset = torch.zeros(origin[0].shape, dtype=torch.float32,
                         device=origin[0].device)
    for _ in range(alpha_rounds):
        alpha = alpha_fn(hit)
        transparent = (hit["tri"] >= 0) & (alpha < 0.5)
        if "mixed" in hit:
            transparent = transparent & hit["mixed"]
        # hit["t"] is a distance from the ORIGINAL origin while ``o`` is
        # already ``offset`` along the ray: step by the remainder only
        step = torch.where(transparent, hit["t"] - offset + 1e-3,
                           torch.zeros_like(offset))
        o = vec.where(transparent, vec.add(o, vec.scale(direction, step)), o)
        offset = offset + torch.where(transparent, step, torch.zeros_like(step))
        # other lanes: cap -1 ends their walk at the root
        re_cap = torch.where(transparent, cap - offset,
                             torch.full_like(offset, -1.0))
        rehit = walk(o, direction, re_cap)
        hit = {k: torch.where(transparent,
                              rehit[k] + offset if k == "t" else rehit[k], h)
               for k, h in hit.items()}
    return hit


def _full_masked_closest(scene, origin, direction, cap, alpha_rounds: int,
                         uncapped: bool = False):
    """Single-walk closest leg over the full masked tree: one masked walk
    plus the exact-texture re-test rounds of MIXED-cell hits through
    ``alpha_attr_full`` (full-tree row order, no slot remap). Returns the
    usual hit dict (inf/-1 on a miss or beyond ``cap``)."""
    hit = accel.closest_hit_soa_masked_auto(
        scene.bvh, origin, direction, None if uncapped else cap)
    hit = _alpha_retest_rounds(
        origin, direction, cap, hit, alpha_rounds,
        walk=lambda o, d, c: accel.closest_hit_soa_masked_auto(
            scene.bvh, o, d, c),
        alpha_fn=lambda h: _hit_alpha_attr(scene, scene.alpha_attr_full, h))
    return _cull_beyond(hit, cap)


def _full_tree_masked(scene, alpha_rounds: int) -> bool:
    """True when the main tree carries baked opacity cells and the scene
    has the full-order alpha rows: the single-walk closest leg."""
    if alpha_rounds <= 0:
        return False
    tri = scene.bvh.tri
    return (tri.dim() == 2 and tri.shape[1] > 9
            and scene.alpha_attr_full is not None)


def _alpha_walk_refined(scene, origin, direction, cap, alpha_rounds: int):
    """Masked alpha-tree walk plus its re-test rounds, both at full width
    (the JAX package's candidate prefix is the full width at its default
    GLAZE_ALPHA_PREFIX = 1.0). Returns a slot-space hit dict (inf/-1
    beyond ``cap`` or on a miss)."""
    hit = accel.closest_hit_soa_masked_auto(scene.bvh_alpha, origin,
                                            direction, cap)
    if scene.alpha_attr is not None:
        def alpha_fn(h):
            return _hit_alpha_attr(scene, scene.alpha_attr, h)
    else:
        def alpha_fn(h):
            return _hit_alpha(scene, _remap_hit(h, scene.bvh_alpha_map))
    hit = _alpha_retest_rounds(
        origin, direction, cap, hit, alpha_rounds,
        walk=lambda o, d, c: accel.closest_hit_soa_masked_auto(
            scene.bvh_alpha, o, d, c),
        alpha_fn=alpha_fn)
    return _cull_beyond(hit, cap)


def _alpha_tree_closest(scene, origin, direction, cap, alpha_rounds: int):
    """Closest ACCEPTED (opacity >= 0.5) hit inside the alpha tree, as
    global tri ids (t = inf / tri = -1 when none within ``cap``)."""
    return _remap_hit(
        _alpha_walk_refined(scene, origin, direction, cap, alpha_rounds),
        scene.bvh_alpha_map)


def _split_closest(scene, origin, direction, cap, capped: bool,
                   alpha_rounds: int, cand=None):
    """The opaque/alpha split: one unmasked walk of the opaque tree, then
    the alpha tree up to just past the opaque hit (the epsilon keeps an
    exactly coincident alpha surface testable). ``cand`` (the sorted
    path's candidate mask) culls lanes that miss every alpha box."""
    r = origin[0].shape[0]
    if scene.bvh_opaque is not None:
        hit_o = accel.closest_hit_soa_auto(scene.bvh_opaque, origin,
                                           direction, cap if capped else None)
        hit_o = _remap_hit(hit_o, scene.bvh_opaque_map)
    else:
        hit_o = _miss_hit(r, origin[0].device)
    cap_a = torch.minimum(cap, hit_o["t"] + 1e-4)
    if cand is not None:
        cap_a = torch.where(cand, cap_a, torch.full_like(cap_a, -1.0))
    hit_a = _alpha_tree_closest(scene, origin, direction, cap_a, alpha_rounds)
    use_a = hit_a["t"] < hit_o["t"]
    hit = {k: torch.where(use_a, hit_a[k], hit_o[k])
           for k in ("t", "tri", "u", "v")}
    return _cull_beyond(hit, cap) if capped else hit


def trace_alpha(scene, origin, direction, t_max=None, alpha_rounds: int = 0):
    """Closest hit with alpha-tested transparency (raytrace_hit.rahit):
    hits whose opacity sample is < 0.5 are skipped, up to ``alpha_rounds``
    re-test rounds. ``alpha_rounds = 0`` (no opacity maps) is a plain
    closest-hit trace. The ``t_max`` cap applies to every trace
    (traceRayEXT tMax, path_trace.rgen:108-110). The branch (full masked
    tree, opaque/alpha split, whole-scene re-trace) follows from what the
    scene carries; see the module docstring."""
    cap = _cap(t_max, origin[0])
    if _full_tree_masked(scene, alpha_rounds):
        return _full_masked_closest(scene, origin, direction, cap,
                                    alpha_rounds, uncapped=t_max is None)
    if alpha_rounds > 0 and scene.bvh_alpha is not None:
        return _split_closest(scene, origin, direction, cap,
                              t_max is not None, alpha_rounds)
    hit = accel.closest_hit_soa_auto(scene.bvh, origin, direction,
                                     None if t_max is None else cap)
    if alpha_rounds <= 0:
        return hit
    hit = _alpha_retest_rounds(
        origin, direction, cap, hit, alpha_rounds,
        walk=lambda o, d, c: accel.closest_hit_soa_auto(scene.bvh, o, d, c),
        alpha_fn=lambda h: _hit_alpha(scene, h))
    return _cull_beyond(hit, cap) if t_max is not None else hit


def trace_alpha_sorted(scene, origin, direction, t_max=None,
                       alpha_rounds: int = 0):
    """:func:`trace_alpha` on Morton-sorted rays, results in input order.
    A negative cap culls a lane. On the split branch, lanes whose segment
    misses every alpha cluster box skip the alpha tree (cap -1)."""
    split = (not _full_tree_masked(scene, alpha_rounds) and alpha_rounds > 0
             and scene.bvh_alpha is not None)
    ins = list(origin) + list(direction)
    act = None
    if t_max is not None:
        cap0 = _cap(t_max, origin[0])
        ins.append(cap0)
        act = cap0 > 0.0
    cand = None
    if split:
        cand = _alpha_candidates(scene, origin, direction, _cap(t_max, origin[0]))
        if act is not None:
            cand = cand & act
        ins.append(cand)
    perm = _trace_perm(scene, origin, direction, active=act)
    inv = _inverse_perm(perm)
    s = _perm_rows(perm, ins)
    o, d = tuple(s[0:3]), tuple(s[3:6])
    cap = s[6] if t_max is not None else None
    if split:
        hit = _split_closest(scene, o, d, _cap(cap, o[0]), t_max is not None,
                             alpha_rounds, cand=s[-1])
    else:
        hit = trace_alpha(scene, o, d, cap, alpha_rounds)
    return {k: v[inv] for k, v in hit.items()}


def _occlusion_sorted(scene, origin, direction, t_max, active,
                      alpha_rounds: int):
    """Alpha-aware shadow occlusion in one coherence-sorted pass.

    Full masked tree: one 3-state masked any-hit walk blocks on OPAQUE
    cells, ignores TRANSPARENT ones and reports MIXED-only lanes pending;
    only those resolve their accepted hit in the alpha tree (or, without
    one, in the full masked tree). Split scenes: any hit on the opaque tree
    plus the alpha tree for unblocked candidates. Neither: the whole-scene
    re-trace of :func:`trace_alpha_sorted`."""
    use_masked = (_full_tree_masked(scene, alpha_rounds)
                  and accel.masked_anyhit_ok(scene.bvh))
    cap = _cap(t_max, origin[0])
    if alpha_rounds <= 0 or (scene.bvh_alpha is None and not use_masked):
        sh = trace_alpha_sorted(
            scene, origin, direction,
            t_max=torch.where(active, cap, torch.full_like(cap, -1.0)),
            alpha_rounds=alpha_rounds)
        return sh["tri"] >= 0
    if use_masked:
        perm = _trace_perm(scene, origin, direction, active=active)
        inv = _inverse_perm(perm)
        s = _perm_rows(perm, list(origin) + list(direction) + [cap, active])
        o, d, cap_s, act = tuple(s[0:3]), tuple(s[3:6]), s[6], s[7]
        blocked, pending = accel.any_hit_soa_masked_auto(
            scene.bvh, o, d, cap_s, active=act)
        probe = act & pending & ~blocked
        cap_a = torch.where(probe, cap_s, torch.full_like(cap_s, -1.0))
        if scene.bvh_alpha is not None:
            # the MIXED triangles all live in the small alpha subset tree
            tri_a = _alpha_walk_refined(scene, o, d, cap_a,
                                        alpha_rounds)["tri"]
        else:
            tri_a = _full_masked_closest(scene, o, d, cap_a,
                                         alpha_rounds)["tri"]
        blocked = blocked | (probe & (tri_a >= 0))
        return blocked[inv]
    cand = _alpha_candidates(
        scene, origin, direction,
        torch.where(active, cap, torch.full_like(cap, -1.0))) & active
    perm = _trace_perm(scene, origin, direction, active=active)
    inv = _inverse_perm(perm)
    s = _perm_rows(perm, list(origin) + list(direction) + [cap, active, cand])
    o, d, cap_s, act, cand_s = (tuple(s[0:3]), tuple(s[3:6]), s[6], s[7],
                                s[8])
    if scene.bvh_opaque is not None:
        blocked = accel.any_hit_soa_auto(scene.bvh_opaque, o, d, cap_s,
                                         active=act)
    else:
        blocked = torch.zeros_like(act)
    probe = act & ~blocked & cand_s
    cap_a = torch.where(probe, cap_s, torch.full_like(cap_s, -1.0))
    tri_a = _alpha_walk_refined(scene, o, d, cap_a, alpha_rounds)["tri"]
    blocked = blocked | (probe & (tri_a >= 0))
    return blocked[inv]


def _any_hit_sorted(scene, origin, direction, t_max, active):
    """Shadow trace on Morton-sorted rays; inactive lanes sort to the tail
    (the kernel retires them at once). Walks the classic any-hit tree of
    a hybrid scene (``bvh_any``) where there is one, else ``bvh``."""
    perm = _trace_perm(scene, origin, direction, active=active)
    inv = _inverse_perm(perm)
    cap = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=origin[0].device),
        origin[0].shape)
    s = _perm_rows(perm, list(origin) + list(direction) + [cap, active])
    tree = scene.bvh_any if scene.bvh_any is not None else scene.bvh
    hit = accel.any_hit_soa_auto(tree, tuple(s[0:3]), tuple(s[3:6]),
                                 s[6], active=s[7])
    return hit[inv]


def _expand_block(a, p: int):
    """Chain width -> lane width: repeat each of the C chain values over
    its contiguous block of p // C lanes. Handles (C,) and (16, C)."""
    c = a.shape[-1]
    if c == p:
        return a
    if c == 1:  # frame-shared chain: a broadcast view, no copy
        return a.expand(*a.shape[:-1], p)
    return torch.repeat_interleave(a, p // c, dim=-1)


def _direct_light(scene, state_rng, wo_w, frame, hit, mat, active,
                  alpha_rounds=0, expand=None):
    """NEE (path_trace.rgen direct_light, :87-117). Advances the rng by 5
    draws unconditionally. Returns (rng, radiance (16, R))."""
    ex = expand if expand is not None else (lambda a: a)
    rng = state_rng
    rng, r_pick = rng_mod.next_f32(rng)
    lights_no = scene.lights_no
    lights_no_f = lights_no.to(torch.float32)
    light_idx = torch.minimum((r_pick * lights_no_f).to(torch.int32),
                              lights_no - 1)
    light_idx = torch.clamp(light_idx, min=0)
    rng, ra = rng_mod.next_f32(rng)
    rng, rb = rng_mod.next_f32(rng)
    rng, rc = rng_mod.next_f32(rng)
    wiw, dist, emission, light_pdf = lights_mod.sample_light(
        scene, light_idx, hit["point"], (ra, rb, rc), expand=expand)
    rng, r_bsdf = rng_mod.next_f32(rng)

    wo = shading.to_shading_space_v(wo_w, frame)
    wi = shading.to_shading_space_v(wiw, frame)
    value, bsdf_pdf = bsdf_mod.bsdf_value(scene, mat, wo, wi, hit["uv"],
                                          ex(r_bsdf))

    usable = (light_pdf > 0.0) & (bsdf_pdf > 0.0)
    if alpha_rounds > 0:
        # transparent surfaces do not shadow (occlusion_tester + rahit)
        shadow_hit = _occlusion_sorted(scene, hit["point"], wiw, dist - 1e-3,
                                       active & usable, alpha_rounds)
    else:
        shadow_hit = _any_hit_sorted(scene, hit["point"], wiw, dist - 1e-3,
                                     active & usable)
    cos_term = torch.abs(vec.dot(wiw, hit["shading_normal"]))
    weight = (usable.to(torch.float32) * (~shadow_hit).to(torch.float32)
              * cos_term / torch.clamp(light_pdf, min=1e-20))
    radiance = value * emission * (weight * lights_no_f)
    return rng, radiance


def launch_step(scene, state: PathState, seed, pixel_offset, cam2world,
                screen2cam, px, py, launch_size, *, is_persp: bool,
                direct_only: bool = False, alpha_rounds: int = 0,
                coherent=1, sampler: str = "pcg",
                lane_active=None) -> PathState:
    """One bounce for all pixels (path_trace.rgen main, :135-239).

    ``seed``: uint32 frame seed (a Python int); ``pixel_offset``: (2,)
    sub-pixel jitter from the WorkScheduler; ``px``/``py``: (P,) float32
    lane pixel coordinates; ``launch_size``: (W, H) of the full image;
    ``cam2world``/``screen2cam``: float32 NumPy matrices. ``coherent``:
    0 = one PCG chain per lane, 1 = one chain for the whole frame,
    2 = one chain per 2048-lane tile."""
    if sampler != "pcg":
        _not_ported(f"sampler {sampler!r}")
    if lane_active is not None:
        _not_ported("adaptive sampling (lane_active)")
    dev = px.device
    p = px.shape[0]
    coh = resolve_coherent(coherent)
    enabled = scene.lights_no > 0  # path_trace.rgen:137-141
    width_f = float(launch_size[0])
    height_f = float(launch_size[1])

    # vec3(uint seed, ...) converts to float
    seed_f = float(np.float32(np.uint32(int(seed) & 0xFFFFFFFF)))
    if coh == 1:
        # frame-shared chain kept at shape (1,): draw-driven table lookups
        # gather one row, broadcast only where per-lane data mixes in
        one = torch.zeros((1,), dtype=torch.float32, device=dev)
        rng = rng_mod.srand_f32x3(one + seed_f, one, one)
    elif coh == 2 and p % (TILE_W * TILE_H) == 0:
        # one chain per 2048-lane tile, kept at shape (n_tiles,)
        blk = TILE_W * TILE_H
        pxb, pyb = px[::blk], py[::blk]
        tiles_x = float(np.ceil(np.float32(width_f) / np.float32(TILE_W)))
        chan = torch.floor(pxb / TILE_W) + torch.floor(pyb / TILE_H) * tiles_x
        rng = rng_mod.srand_f32x3(torch.full_like(pxb, seed_f), chan,
                                  torch.zeros_like(pxb))
    elif coh == 2:
        tiles_x = float(np.ceil(np.float32(width_f) / np.float32(TILE_W)))
        chan = torch.floor(px / TILE_W) + torch.floor(py / TILE_H) * tiles_x
        rng = rng_mod.srand_f32x3(torch.full_like(px, seed_f), chan,
                                  torch.zeros_like(px))
    else:
        rng = rng_mod.srand_f32x3(torch.full_like(px, seed_f), px, py)

    ju = float(np.float32(pixel_offset[0]))
    jv = float(np.float32(pixel_offset[1]))
    ndc_x = -1.0 + 2.0 * (px + ju) / width_f
    ndc_y = -1.0 + 2.0 * (py + jv) / height_f
    cam_origin, cam_dir = camera_rays(ndc_x, ndc_y, cam2world, screen2cam,
                                      is_persp)

    if direct_only:
        regen = torch.ones((p,), dtype=torch.bool, device=dev)
    else:
        regen = state.bounce == 0.0
    count = state.count + enabled.to(torch.float32)
    new_path_no = state.path_no + regen.to(torch.int64)

    origin = vec.where(regen, cam_origin, state.origin)
    direction = vec.where(regen, cam_dir, state.direction)
    importance = torch.where(regen, spectra.one_t(p, dev), state.importance)

    hit = trace_alpha_sorted(scene, origin, direction,
                             alpha_rounds=alpha_rounds)
    missed = hit["tri"] < 0

    # ---- miss: sky radiance only on camera rays / after specular bounces
    sky_visible = (state.bounce == 0.0) | (state.last_specular == 1.0)
    add_sky = missed & sky_visible & (scene.sky_tex > 0)
    sr, sg, sb = _sky_radiance(scene, direction)
    sky_spec = importance * spectra.from_illuminant_color_t(sr, sg, sb)
    mr, mg, mb = spectra.to_rgb_t(sky_spec)
    zero = torch.zeros_like(mr)
    miss_contrib = (torch.where(add_sky, mr, zero),
                    torch.where(add_sky, mg, zero),
                    torch.where(add_sky, mb, zero))

    # ---- hit shading
    surf = _interpolate_hit(scene, hit)
    wo_w = vec.neg(direction)
    frame = shading.new_shading_space_v(surf["dpdu"], surf["shading_normal"])
    mat = bsdf_mod.gather_material(scene, surf["material_id"])
    mat_specular = mat["scalars"][fl.MS_IS_SPECULAR] > 0.5

    nee_active = ~missed & ~mat_specular
    ex = lambda a: _expand_block(a, p)  # noqa: E731
    rng, nee_radiance = _direct_light(scene, rng, wo_w, frame, surf, mat,
                                      nee_active, alpha_rounds=alpha_rounds,
                                      expand=ex)
    nee_radiance = nee_radiance * importance
    nr, ng, nb = spectra.to_rgb_t(nee_radiance)
    nee_contrib = (torch.where(nee_active, nr, zero),
                   torch.where(nee_active, ng, zero),
                   torch.where(nee_active, nb, zero))

    new_specular = torch.where(missed, state.last_specular,
                               mat_specular.to(torch.float32))

    en = enabled.to(torch.float32)
    accum = tuple(state.accum[i] + en * (miss_contrib[i] + nee_contrib[i])
                  for i in range(3))
    c_lum = en * (0.2126 * (miss_contrib[0] + nee_contrib[0])
                  + 0.7152 * (miss_contrib[1] + nee_contrib[1])
                  + 0.0722 * (miss_contrib[2] + nee_contrib[2]))
    sq = state.sq + c_lum * c_lum

    if direct_only:
        return PathState(
            importance=state.importance,
            origin=state.origin,
            direction=state.direction,
            bounce=torch.zeros_like(state.bounce),
            last_specular=torch.where(enabled, new_specular,
                                      state.last_specular),
            accum=accum, count=count, path_no=new_path_no, sq=sq)

    # ---- Russian roulette (path_trace.rgen:196-211)
    rng, rr_roll = rng_mod.next_f32(rng)
    rr_active = state.bounce > RUSSIAN_ROULETTE
    kill_prob = torch.clamp(1.0 - spectra.luminance_t(importance), min=0.05)
    rr_kill = rr_active & (ex(rr_roll) < kill_prob)
    rr_scale = torch.where(rr_active, 1.0 / (1.0 - kill_prob),
                           torch.ones_like(kill_prob))
    importance = importance * rr_scale

    # ---- BSDF sampling (path_trace.rgen:212-228)
    rng, sa = rng_mod.next_f32(rng)
    rng, sb_ = rng_mod.next_f32(rng)
    rng, sc = rng_mod.next_f32(rng)
    wo = shading.to_shading_space_v(wo_w, frame)
    wi, value, pdf = bsdf_mod.bsdf_sample(scene, mat, wo, surf["uv"],
                                          (ex(sa), ex(sb_), ex(sc)))
    wi_w = shading.to_world_space_v(wi, frame)
    sample_dead = pdf <= 0.0
    weight = (torch.abs(vec.dot(wi_w, surf["shading_normal"]))
              / torch.clamp(pdf, min=1e-20))
    next_importance = importance * value * weight

    path_dead = missed | rr_kill | sample_dead
    at_max = state.bounce >= PT_STEPS  # "if bounce < PT_STEPS inc else reset"
    new_bounce = torch.where(path_dead | at_max, torch.zeros_like(state.bounce),
                             state.bounce + 1.0)

    upd = enabled & ~path_dead
    return PathState(
        importance=torch.where(upd, next_importance, state.importance),
        origin=vec.where(upd, surf["point"], state.origin),
        direction=vec.where(upd, wi_w, state.direction),
        bounce=torch.where(enabled, new_bounce, state.bounce),
        last_specular=torch.where(enabled, new_specular, state.last_specular),
        accum=accum, count=count, path_no=new_path_no, sq=sq)


def render_steps(scene, state, seeds, offsets, cam2world, screen2cam, *,
                 width, height, is_persp, direct_only, steps,
                 alpha_rounds=0, sif=1, coherent=1, sampler="pcg",
                 lane_active=None):
    """``steps`` launches as a Python loop over :func:`launch_step`;
    ``seeds`` (steps,) uint32 and ``offsets`` (steps, 2) are NumPy."""
    if sif != 1:
        _not_ported("samples in flight > 1")
    px, py = pixel_coords(width, height, scene.device)
    size = (float(width), float(height))
    for k in range(steps):
        state = launch_step(
            scene, state, int(seeds[k]), offsets[k], cam2world, screen2cam,
            px, py, size, is_persp=is_persp, direct_only=direct_only,
            alpha_rounds=alpha_rounds, coherent=coherent, sampler=sampler,
            lane_active=lane_active)
    return state


def _fold_display(accum, count, exposure):
    """Display conversion: linear rgb * exposure / count, clamped,
    sRGB-encoded, rounded -> (P, 3) uint8."""
    inv = exposure / torch.clamp(count, min=1.0)
    chans = [torch.round(tx.linear_to_srgb(
        torch.clamp(accum[i] * inv, 0.0, 1.0)) * 255.0).to(torch.uint8)
        for i in range(3)]
    return torch.stack(chans, dim=-1)


def render_image(state: PathState, exposure, width: int, height: int):
    """Accumulated sum -> display image (H, W, 3) uint8 NumPy, folded,
    unswizzled and cropped on the state's device; only the cropped image
    crosses to the host."""
    img = _fold_display(state.accum, state.count, exposure)
    px, py = _pixel_coords_t(width, height, img.device)
    pw, ph = padded_dims(width, height)
    full = torch.zeros((ph * pw, 3), dtype=torch.uint8, device=img.device)
    full[py * pw + px] = img
    return full.view(ph, pw, 3)[:height, :width].cpu().numpy()
