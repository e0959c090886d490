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
classic ``scene.bvh_any`` of a hybrid scene, else ``scene.bvh``. The
shade stage (the hit's attributes, the shading frame, the NEE lanes and
the sky on missed lanes), the NEE stage before its shadow rays (the light
sample, the BSDF value, the weight and the contribution) and the BSDF
stage (the accumulation, Russian roulette, the BSDF sample and the new
path state) are :mod:`glaze_tpu_torch.render.shade_cuda`: one kernel
each on the card, the shade kernel's lane floats and the NEE kernel's
texels handed on to the kernels after them, and the plain torch versions
on the CPU.

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

The JAX package's environment switches that change a result are read as
it reads them: ``GLAZE_TILE`` (the tile of the lane swizzle and of
coherent mode 2's chains, below, read once at import), and, elsewhere,
``GLAZE_COHERENT`` and ``GLAZE_ALPHA_ROUNDS`` (the renderer) and
``GLAZE_ALPHA_MASK`` (``scene/flatten.py``), and the renderer's
``GLAZE_SIF``, ``GLAZE_SAMPLER``, ``GLAZE_ADAPTIVE``,
``GLAZE_ADAPTIVE_TAU`` and ``GLAZE_ADAPTIVE_MIN``. The switches that only
reorder work, and so change no result, stay unread: ``GLAZE_SORT`` (the
trace sort key; the port sorts by Morton code, the default),
``GLAZE_ALPHA_PREFIX`` (the candidates-first prefix of the re-test rounds;
the port runs them at full width, the default 1.0) and the VMEM budgets of
the Pallas kernels.

The sampling options of the JAX package: ``sif`` samples in flight per
pixel (:func:`sif_lanes`: sif copies of the pixel grid back to back, so a
launch traces sif x P rays), the ``ld`` sampler (per-pixel Owen-scrambled
Sobol points, :mod:`glaze_tpu_torch.ops.sobol`) and adaptive stopping
(:func:`adaptive_lane_mask`: converged tiles park at their next path
boundary).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from glaze_tpu_torch import accel
from glaze_tpu_torch.ops import rng as rng_mod
from glaze_tpu_torch.ops import sobol as sobol_mod
from glaze_tpu_torch.ops import spectra
from glaze_tpu_torch.ops import texture as tx
from glaze_tpu_torch.ops import vec
from glaze_tpu_torch.render import shade_cuda
from glaze_tpu_torch.scene import flatten as fl
from glaze_tpu_torch.utils import runtime
from glaze_tpu_torch.utils.runtime import span, traced

PT_STEPS = shade_cuda.PT_STEPS  # raytrace_structures.rs:87


def tile_from_env():
    """``(TILE_W, TILE_H)``: 128x16, or ``GLAZE_TILE`` ("WxH") where it is
    set, the JAX package's knob. The product must stay one 2048-lane
    packet, or ValueError."""
    v = os.environ.get("GLAZE_TILE")
    if not v:
        return 128, 16
    w, h = (int(x) for x in v.split("x"))
    if w * h != 2048:  # not assert: must survive python -O
        raise ValueError("GLAZE_TILE must multiply to 2048 (one packet)")
    return w, h


# Lanes are tile-swizzled: each TILE_W x TILE_H block of pixels is 2048
# consecutive lanes (the JAX package's traversal packet), read once at
# import as the JAX package does.
TILE_W, TILE_H = tile_from_env()


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


def init_state(width: int, height: int, device, sif: int = 1) -> PathState:
    """Zero state of a ``sif``-samples-in-flight wavefront: sif copies of
    the swizzled pixel grid back to back (:func:`sif_lanes`)."""
    p = pixel_count(width, height) * sif

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


def sif_lanes(width: int, height: int, sif: int, device):
    """(px, py, rng_py) float32 lane coordinates of a sif-samples-in-flight
    wavefront: sif copies of the swizzled pixel grid back to back, with
    ``rng_py`` offset by copy x the padded height so no two copies share
    an srand chain (None at sif = 1)."""
    px, py = pixel_coords(width, height, device)
    if sif == 1:
        return px, py, None
    p1 = px.shape[0]
    px = px.repeat(sif)
    py = py.repeat(sif)
    _, ph = padded_dims(width, height)
    copy = torch.arange(sif, dtype=torch.float32, device=px.device) * ph
    return px, py, py + torch.repeat_interleave(copy, p1)


def ndc(p, jitter, size):
    """``-1 + 2 (p + jitter) / size``: a lane's normalized device
    coordinate from its pixel coordinate ``p`` (a tensor), its sub-pixel
    ``jitter`` and the image ``size``. The division is by a tensor on
    ``p``'s device, so it rounds alike on every device (CUDA multiplies by
    the reciprocal of a Python scalar divisor, the CPU divides)."""
    return -1.0 + 2.0 * (p + jitter) / p.new_full((), float(size))


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


def _spread3(x):
    """Spreads 5-bit ints so bits land 3 apart (Morton interleave)."""
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    x = (x | (x << 2)) & 0x1249
    return x


def _trace_perm(scene, origin, direction, active=None, key=None):
    """Stable coherence sort for a trace phase by :func:`_trace_key` (or
    by ``key``, that key computed already). Stability keeps pixel-tile
    order within equal keys. The sort changes only the order rays are
    traced in, never a result."""
    if key is None:
        key = _trace_key(scene, origin, direction, active)
    return torch.argsort(key, stable=True)


def _trace_key(scene, origin, direction, active=None):
    """The coherence sort key of a trace phase, (R,) int32: [inactive
    last | direction octant | 15-bit origin Morton]. The NEE kernel
    computes the shadow rays' (csrc/shade_lane.cuh trace_key)."""
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
    return key


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
    """True when the main tree carries baked opacity cells (a forest's
    first chunk, as the JAX package probes it) and the scene has the
    full-order alpha rows: the single-walk closest leg."""
    if alpha_rounds <= 0:
        return False
    tree = scene.bvh
    chunks = getattr(tree, "chunks", None)
    tri = (chunks[0] if chunks else tree).tri
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
                      alpha_rounds: int, key=None):
    """Alpha-aware shadow occlusion in one coherence-sorted pass
    (``key``: the rays' :func:`_trace_key`, where computed already).

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
        perm = _trace_perm(scene, origin, direction, active=active, key=key)
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
    perm = _trace_perm(scene, origin, direction, active=active, key=key)
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


def _any_hit_sorted(scene, origin, direction, t_max, active, key=None):
    """Shadow trace on Morton-sorted rays; inactive lanes sort to the tail
    (the kernel retires them at once). Walks the classic any-hit tree of
    a hybrid scene (``bvh_any``) where there is one, else ``bvh``.
    ``key``: the rays' :func:`_trace_key`, where computed already."""
    perm = _trace_perm(scene, origin, direction, active=active, key=key)
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


def _direct_light(scene, state_rng, wo_w, frame, hit, mat, importance,
                  active, alpha_rounds=0, expand=None, draws=None):
    """NEE (path_trace.rgen direct_light, :87-117). Advances the rng by 5
    draws unconditionally. Returns (rng, rgb (3, R), texels): the linear
    RGB contribution of the lanes of ``active`` whose shadow ray is not
    blocked, 0 elsewhere, and the texels the NEE kernel fetched for the
    BSDF stage (None on the CPU).

    The light sample, the BSDF value, the weight and the contribution come
    from :func:`glaze_tpu_torch.render.shade_cuda.nee` (one kernel on the
    card), the shadow test from the coherence-sorted walks.

    ``draws``: optional 5-tuple of lane-width uniforms (pick, a, b, c,
    bsdf) that replaces the chain's draws, the ``ld`` sampler's points.
    The chain still advances, so the pcg and ld streams stay aligned."""
    ex = expand if expand is not None else (lambda a: a)
    rng = state_rng
    chain = []
    for _ in range(5):
        rng, r = rng_mod.next_f32(rng)
        chain.append(r)
    out = shade_cuda.nee(scene, hit, wo_w, frame, mat, importance, active,
                         tuple(chain) if draws is None else tuple(draws), ex)
    if alpha_rounds > 0:
        # transparent surfaces do not shadow (occlusion_tester + rahit)
        blocked = _occlusion_sorted(scene, hit["point"], out["wiw"],
                                    out["cap"], out["active"], alpha_rounds,
                                    key=out["key"])
    else:
        blocked = _any_hit_sorted(scene, hit["point"], out["wiw"], out["cap"],
                                  out["active"], key=out["key"])
    return (rng, torch.where(active & ~blocked, out["rgb"], 0.0),
            out["texels"])


@traced("integrator.launch")
def launch_step(scene, state: PathState, seed, pixel_offset, cam2world,
                screen2cam, px, py, launch_size, *, is_persp: bool,
                direct_only: bool = False, alpha_rounds: int = 0,
                rng_py=None, coherent=1, sampler: str = "pcg",
                sampler_seed=None, lane_active=None,
                want_first_hit: bool = False):
    """One bounce for all pixels (path_trace.rgen main, :135-239).

    ``seed``: uint32 frame seed (a Python int); ``pixel_offset``: (2,)
    sub-pixel jitter from the WorkScheduler, or a pair of (P,) per-lane
    tensors when several samples are in flight; ``px``/``py``: (P,)
    float32 lane pixel coordinates; ``launch_size``: (W, H) of the full
    image; ``cam2world``/``screen2cam``: float32 NumPy matrices.
    ``rng_py`` (:func:`sif_lanes`) decorrelates the chains of in-flight
    copies that share (px, py); None means ``py``. ``coherent``: 0 = one
    PCG chain per lane, 1 = one chain for the whole frame (one per copy
    with samples in flight), 2 = one chain per 2048-lane tile.

    ``sampler='ld'``: the sub-pixel jitter comes from each pixel's
    Owen-scrambled Sobol stream indexed by the lane's path count, and
    with coherent 0 every path decision of bounce b from domains
    1 + 9*b + slot of it. ``sampler_seed``: a uint32 (Python int)
    decorrelating renders.

    ``lane_active``: optional (P,) bool, the adaptive tile mask. Lanes
    of converged tiles park at their next path boundary: no camera ray,
    no count, no contribution, and their closest trace is culled.

    ``want_first_hit``: return ``(state, fh)``, where ``fh`` holds this
    launch's traced rays and their hit attributes (``missed``, ``t``,
    ``origin``, ``direction``, ``shading_normal``, ``material_id``,
    ``uv``). After a restart every lane traces a camera ray, so ``fh`` is
    the frame's G-buffer input without a second primary trace.

    The span ``integrator.launch`` (the counter ``integrator.launches``)
    and its stages: ``integrator.camera`` (the chains, the jitter, the
    camera rays and the regeneration), ``.trace`` (the path rays' closest
    hits), ``.shade`` (the sky, the hit's attributes and frame, the NEE
    lanes), ``.nee`` (direct light with its shadow rays, the
    contribution) and ``.bsdf`` (roulette, the BSDF sample, the new
    state)."""
    runtime.count("integrator.launches")
    with span("integrator.camera"):
        dev = px.device
        p = px.shape[0]
        coh = resolve_coherent(coherent)
        enabled = scene.lights_no > 0  # path_trace.rgen:137-141
        width_f = float(launch_size[0])
        height_f = float(launch_size[1])

        # vec3(uint seed, ...) converts to float
        seed_f = float(np.float32(np.uint32(int(seed) & 0xFFFFFFFF)))
        if coh == 1 and rng_py is None:
            # frame-shared chain kept at shape (1,): draw-driven table lookups
            # gather one row, broadcast only where per-lane data mixes in
            one = torch.zeros((1,), dtype=torch.float32, device=dev)
            rng = rng_mod.srand_f32x3(one + seed_f, one, one)
        elif coh == 2 and p % (TILE_W * TILE_H) == 0:
            # one chain per 2048-lane tile, kept at shape (n_tiles,); in-flight
            # copies are whole tiles, each with its copy offset
            blk = TILE_W * TILE_H
            pxb, pyb = px[::blk], py[::blk]
            copy_b = (torch.zeros_like(pxb) if rng_py is None
                      else (rng_py - py)[::blk])
            tiles_x = float(np.ceil(np.float32(width_f) / np.float32(TILE_W)))
            chan = (torch.floor(pxb / TILE_W)
                    + torch.floor(pyb / TILE_H) * tiles_x)
            rng = rng_mod.srand_f32x3(torch.full_like(pxb, seed_f), chan,
                                      copy_b)
        elif coh:
            # rng_py - py is the per-copy offset of sif_lanes: copies stay
            # decorrelated while the lanes of one copy share draws
            copy = torch.zeros_like(px) if rng_py is None else rng_py - py
            if coh == 2:
                tiles_x = float(np.ceil(np.float32(width_f)
                                        / np.float32(TILE_W)))
                chan = (torch.floor(px / TILE_W)
                        + torch.floor(py / TILE_H) * tiles_x)
            else:
                chan = copy
            rng = rng_mod.srand_f32x3(torch.full_like(px, seed_f), chan, copy)
        else:
            rng = rng_mod.srand_f32x3(torch.full_like(px, seed_f), px,
                                      py if rng_py is None else rng_py)

        pk = None
        if sampler == "ld":
            # per-pixel stratified jitter: the lane's path count indexes its
            # own Owen-Sobol stream (the WorkScheduler offset is unused)
            pk = (px.to(torch.int64)
                  + (py if rng_py is None else rng_py).to(torch.int64) * 65536)
            if sampler_seed is not None:
                pk = pk ^ (int(sampler_seed) & sobol_mod.M32)
            pk = pk & sobol_mod.M32
            ju, jv = sobol_mod.sobol02(state.path_no, pk, 0)
        elif isinstance(pixel_offset[0], torch.Tensor):
            ju, jv = pixel_offset
        else:
            ju = float(np.float32(pixel_offset[0]))
            jv = float(np.float32(pixel_offset[1]))
        cam_origin, cam_dir = camera_rays(ndc(px, ju, width_f),
                                          ndc(py, jv, height_f), cam2world,
                                          screen2cam, is_persp)

        if direct_only:
            regen = torch.ones((p,), dtype=torch.bool, device=dev)
        else:
            regen = state.bounce == 0.0
        if lane_active is not None:
            # adaptive stop: converged tiles park at the path boundary
            parked = regen & ~lane_active
            regen = regen & lane_active
        else:
            parked = None
        live = enabled if parked is None else enabled & ~parked
        count = state.count + live.to(torch.float32)
        new_path_no = (state.path_no + regen.to(torch.int64)) & sobol_mod.M32

        # ld with coherent 0: every decision of bounce b of a pixel's path i
        # comes from domain 1 + 9*b + slot of its stream at index i. Lanes
        # regenerating this launch start path ``path_no``; continuing lanes
        # extend path ``path_no - 1``
        ld_draws = None
        if sampler == "ld" and coh == 0:
            samp_idx = torch.where(regen, state.path_no,
                                   (state.path_no - 1) & sobol_mod.M32)
            b_dom = 1 + 9 * state.bounce.to(torch.int64)
            d_pick = sobol_mod.sobol1(samp_idx, pk, b_dom)
            d_la, d_lb = sobol_mod.sobol02(samp_idx, pk, b_dom + 1)
            d_lc = sobol_mod.sobol1(samp_idx, pk, b_dom + 3)
            d_bv = sobol_mod.sobol1(samp_idx, pk, b_dom + 4)
            d_rr = sobol_mod.sobol1(samp_idx, pk, b_dom + 5)
            d_sa, d_sb = sobol_mod.sobol02(samp_idx, pk, b_dom + 6)
            d_sc = sobol_mod.sobol1(samp_idx, pk, b_dom + 8)
            ld_draws = (d_pick, d_la, d_lb, d_lc, d_bv, d_rr, d_sa, d_sb, d_sc)

        origin = vec.where(regen, cam_origin, state.origin)
        direction = vec.where(regen, cam_dir, state.direction)
        importance = torch.where(regen, spectra.one_t(p, dev),
                                 state.importance)

    with span("integrator.trace"):
        if parked is None:
            hit = trace_alpha_sorted(scene, origin, direction,
                                     alpha_rounds=alpha_rounds)
        else:
            # parked lanes: cap -1 culls their walk (they sort to the tail)
            hit = trace_alpha_sorted(
                scene, origin, direction,
                t_max=torch.where(parked, -1.0, float("inf")),
            alpha_rounds=alpha_rounds)
    with span("integrator.shade"):
        shaded = shade_cuda.surface(scene, hit, direction, state, importance,
                                    parked)
        surf, wo_w, frame = shaded["surf"], shaded["wo_w"], shaded["frame"]
        mat, missed = shaded["mat"], shaded["missed"]
    ex = lambda a: _expand_block(a, p)  # noqa: E731
    with span("integrator.nee"):
        rng, nee_contrib, texels = _direct_light(
            scene, rng, wo_w, frame, surf, mat, importance,
            shaded["nee_active"], alpha_rounds=alpha_rounds, expand=ex,
            draws=None if ld_draws is None else ld_draws[:5])

    with span("integrator.bsdf"):
        fh = None
        if want_first_hit:
            fh = {"missed": missed, "t": hit["t"], "origin": origin,
                  "direction": direction,
                  "shading_normal": surf["shading_normal"],
                  "material_id": surf["material_id"], "uv": surf["uv"]}

        # the roulette's draw, then the BSDF sample's three
        draws = None
        if direct_only:
            pass
        elif ld_draws is not None:
            draws = ld_draws[5:9]
        else:
            draws = []
            for _ in range(4):
                rng, r = rng_mod.next_f32(rng)
                draws.append(r)
        # a mesh slot's state may be a lane slice of the whole state's
        state = state._replace(importance=state.importance.contiguous())
        new = shade_cuda.bsdf(scene, state, surf, missed, wo_w, frame, mat,
                              importance, shaded["miss_rgb"], nee_contrib,
                              draws, ex, direct_only, texels)
        st = PathState(count=count, path_no=new_path_no, **new)
        return (st, fh) if want_first_hit else st


def render_steps(scene, state, seeds, offsets, cam2world, screen2cam, *,
                 width, height, is_persp, direct_only, steps,
                 alpha_rounds=0, sif=1, coherent=1, sampler="pcg",
                 sampler_seed=None, lane_active=None, after_launch=None,
                 want_first_hit=False):
    """``steps`` launches as a Python loop over :func:`launch_step`;
    ``seeds`` (steps,) uint32 and ``offsets`` are NumPy: (steps, 2), or
    (steps, sif, 2) with ``sif`` > 1 samples in flight (state from
    ``init_state(..., sif=sif)``, one jitter per copy).
    ``after_launch(k, state)``, where given, runs after launch k (the
    renderer's ``GLAZE_DEBUG`` NaN check). ``want_first_hit``: return
    ``(state, fh)`` with launch 0's first-hit attributes
    (:func:`launch_step`)."""
    px, py, rng_py = sif_lanes(width, height, sif, scene.device)
    size = (float(width), float(height))
    p1 = pixel_count(width, height)
    fh = None
    for k in range(steps):
        offset = offsets[k]
        if sif > 1:  # (sif, 2) -> per-lane jitter
            off = torch.from_numpy(np.asarray(offset, np.float32)).to(px.device)
            offset = (torch.repeat_interleave(off[:, 0], p1),
                      torch.repeat_interleave(off[:, 1], p1))
        state = launch_step(
            scene, state, int(seeds[k]), offset, cam2world, screen2cam,
            px, py, size, is_persp=is_persp, direct_only=direct_only,
            alpha_rounds=alpha_rounds, rng_py=rng_py, coherent=coherent,
            sampler=sampler, sampler_seed=sampler_seed,
            lane_active=lane_active, want_first_hit=want_first_hit and k == 0)
        if want_first_hit and k == 0:
            state, fh = state
        if after_launch is not None:
            after_launch(k, state)
    return (state, fh) if want_first_hit else state


def named_leaves(state: PathState):
    """(name, tensor) pairs of every PathState leaf, the tuple leaves as
    ``origin[0]`` ...; the names :func:`utils.check_nans` reports."""
    out = []
    for name, leaf in zip(PathState._fields, state):
        if isinstance(leaf, tuple):
            out += [(f"{name}[{i}]", t) for i, t in enumerate(leaf)]
        else:
            out.append((name, leaf))
    return out


def _fold_sif(accum, count, sif: int):
    """Sums the sif in-flight copies per pixel (estimate = sum(accum) /
    sum(count))."""
    if sif == 1:
        return accum, count
    p = count.shape[0] // sif
    return (tuple(a.reshape(sif, p).sum(0) for a in accum),
            count.reshape(sif, p).sum(0))


def _fold_display(accum, count, exposure):
    """Display conversion: linear rgb * exposure / count, clamped,
    sRGB-encoded, rounded -> (P, 3) uint8."""
    inv = exposure / torch.clamp(count, min=1.0)
    chans = [torch.round(tx.linear_to_srgb(
        torch.clamp(accum[i] * inv, 0.0, 1.0)) * 255.0).to(torch.uint8)
        for i in range(3)]
    return torch.stack(chans, dim=-1)


def render_steps_with_image(scene, state, seeds, offsets, cam2world,
                            screen2cam, exposure, *, width, height, is_persp,
                            direct_only, steps, alpha_rounds=0, sif=1,
                            coherent=1, sampler="pcg", sampler_seed=None,
                            after_launch=None):
    """:func:`render_steps` and the display conversion: returns (state,
    (P', 3) uint8 on the state's device, in the swizzled lane order)."""
    state = render_steps(
        scene, state, seeds, offsets, cam2world, screen2cam, width=width,
        height=height, is_persp=is_persp, direct_only=direct_only,
        steps=steps, alpha_rounds=alpha_rounds, sif=sif, coherent=coherent,
        sampler=sampler, sampler_seed=sampler_seed, after_launch=after_launch)
    return state, _fold_display(*_fold_sif(state.accum, state.count, sif),
                                exposure)


def render_image(state: PathState, exposure, width: int, height: int,
                 sif: int = 1):
    """Accumulated sum -> display image (H, W, 3) uint8 NumPy, folded over
    the ``sif`` in-flight copies, unswizzled and cropped on the state's
    device; only the cropped image crosses to the host."""
    return lanes_to_image(
        _fold_display(*_fold_sif(state.accum, state.count, sif), exposure),
        width, height)


def unswizzle(img, width: int, height: int):
    """(P', 3) display lanes -> the (H, W, 3) image, unswizzled and
    cropped on the lanes' device."""
    px, py = _pixel_coords_t(width, height, img.device)
    pw, ph = padded_dims(width, height)
    full = torch.zeros((ph * pw, 3), dtype=img.dtype, device=img.device)
    full[py * pw + px] = img
    return full.view(ph, pw, 3)[:height, :width]


def lanes_to_image(img, width: int, height: int):
    """(P', 3) uint8 display lanes -> (H, W, 3) uint8 NumPy: unswizzled
    and cropped on the lanes' device; only the cropped image crosses to
    the host."""
    return unswizzle(img, width, height).cpu().numpy()


# ---------------------------------------------------------------------------
# Adaptive sample allocation: per-tile stopping from the running moments.
# A tile (one 2048-lane packet) whose pixels' relative standard errors are
# small parks (launch_step ``lane_active``); each pixel keeps its own count
# and stops only at path boundaries, so the estimates stay unbiased.


def tile_error(state: PathState, sif: int = 1):
    """Per-tile relative standard error of the luminance estimate: (T,)
    float32, T = lanes / 2048 of one copy, the tile mean of se_p /
    (mean_p + 1e-3) with se_p = sqrt(var_p / n) from (accum, sq, count).
    The sif in-flight copies of a pixel fold into one estimate first."""
    accum, count = _fold_sif(state.accum, state.count, sif)
    if sif == 1:
        sq = state.sq
    else:
        sq = state.sq.reshape(sif, state.count.shape[0] // sif).sum(0)
    n = torch.clamp(count, min=1.0)
    lum = 0.2126 * accum[0] + 0.7152 * accum[1] + 0.0722 * accum[2]
    mean = lum / n
    var = (torch.clamp(sq / n - mean * mean, min=0.0)
           * (n / torch.clamp(n - 1.0, min=1.0)))
    se = torch.sqrt(var / n)
    rel = se / (mean + 1e-3)
    return rel.reshape(-1, TILE_W * TILE_H).mean(dim=1)


def adaptive_lane_mask(state: PathState, sif: int = 1, tau: float = 0.01,
                       min_count: float = 64.0):
    """(P,) bool ``lane_active`` mask: True while the lane's tile still
    needs samples, i.e. until every pixel of the tile has ``min_count``
    launches and the tile's mean relative standard error is at most
    ``tau``."""
    err = tile_error(state, sif)
    _, count = _fold_sif(state.accum, state.count, sif)
    blk = TILE_W * TILE_H
    min_n = count.reshape(-1, blk).amin(dim=1)
    active_t = (err > tau) | (min_n < min_count)
    per_pixel = torch.repeat_interleave(active_t, blk)
    return per_pixel if sif == 1 else per_pixel.repeat(sif)
