"""Fat-leaf BVH: few large leaves, each tested as one coefficient slab.

torch port of :mod:`glaze_tpu.accel.fat`. The tree is the classic one
built with leaves of ``LEAF_SIZE_FAT`` triangles (128 by default,
``GLAZE_FAT_LEAF``), in the same eight octant orders; a leaf's meta is its
LEAF INDEX (triangle slots ``[leaf*T, leaf*T + T)``, padding slots
degenerate). Möller–Trumbore is multilinear in the ray features
``x = [o x d, o, d, 1]``, so each triangle is a 16x4 coefficient block
that maps x to ``(det, u*det, v*det, t*det)``, and a leaf is one
``(16, 4T)`` slab, ``leafmat`` (bit-exact to the JAX package's, the
row-10 base index included).

Tables:
  nodes    (M, 8) f32 octant-0 plain rows (meta = leaf index, skip)
  tri      (L*T, 9) f32 leaf-aligned (v0, e1, e2) rows
  nodes16  (8*M16, 128) f32 all-octant packing, as the classic tree's
  leafmat  (L*16, 4T) f32 coefficient slabs [det | u*det | v*det | t*det]
  coef     (L*T, 20) f32, built on the tree's device from ``leafmat``: the
           19 coefficients of each slot that can be non-zero (det: rows
           6..8; u and v: rows 0..2 and 6..8; t: rows 3..5 and 9), padded
           to 20 floats, so a column is five 16-byte loads

:func:`closest_hit_fat` / :func:`any_hit_fat` are the PLAIN versions of the
CUDA kernels ``closest_kernel_fat`` / ``anyhit_kernel_fat``
(:mod:`glaze_tpu_torch.accel.traverse_cuda`): the function of the Pallas
kernels (``glaze_tpu/accel/traverse_fat.py``), each column resolved in the
det-scaled form, with every block's sum taken as the 19 terms in ascending
row order, one multiply then one add each, as the kernels do (built with
``--fmad=false``): the two agree bit for bit. Against the JAX package's
XLA fallback (scalar Möller–Trumbore on ``tri``) they differ by rounding
only (ROADMAP F10).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from glaze_tpu_torch.accel.bvh import (
    T_MIN,
    WalkStats,
    _node_table,
    _pack_lane_dense,
    _pad_rows8,
    _slab_test,
    float_table_to,
    safe_inv,
    sorted_tri_rows,
)

LEAF_SIZE_FAT = int(os.environ.get("GLAZE_FAT_LEAF", "128"))
F = 16  # feature rows (10 used: o x d, o, d, 1)
DET_EPS = 1e-12

# (block, feature row) of each coefficient kept in ``coef``, in table
# order: blocks det, u*det, v*det, t*det, rows ascending within a block
COEF_TERMS = ((0, 6), (0, 7), (0, 8),
              (1, 0), (1, 1), (1, 2), (1, 6), (1, 7), (1, 8),
              (2, 0), (2, 1), (2, 2), (2, 6), (2, 7), (2, 8),
              (3, 3), (3, 4), (3, 5), (3, 9))
COEF_W = 20  # floats per slot: the 19 terms and one zero

# lanes whose leaf columns the plain walkers test at once: a step's (lanes,
# T, COEF_W) gather stays near 340 MB at T = 128
LEAF_CHUNK = 32768

FAT_KEYS = ("nodes", "tri", "nodes16", "leafmat", "n_nodes", "n_tris",
            "leaf_size")


def coef_table(leafmat: torch.Tensor, leaf_size: int) -> torch.Tensor:
    """(L*16, 4T) slabs -> (L*T, COEF_W) per-slot coefficient rows, a pure
    gather on ``leafmat``'s device (the last column is zero)."""
    t = leaf_size
    slabs = leafmat.reshape(-1, F, 4, t)  # (L, row, block, column)
    cols = [slabs[:, row, blk, :] for blk, row in COEF_TERMS]
    cols.append(torch.zeros_like(cols[0]))
    return torch.stack(cols, dim=-1).reshape(-1, COEF_W).contiguous()


class FatBVH:
    """Device fat-leaf BVH: the tables above and the host ints ``n_nodes``
    (M), ``n_tris`` (0 for an empty scene) and ``leaf_size`` (T)."""

    def __init__(self, nodes, tri, nodes16, leafmat, n_nodes: int,
                 n_tris: int, leaf_size: int):
        self.nodes = nodes
        self.tri = tri
        self.nodes16 = nodes16
        self.leafmat = leafmat
        self.n_nodes = int(n_nodes)
        self.n_tris = int(n_tris)
        self.leaf_size = int(leaf_size)
        self.coef = coef_table(leafmat, self.leaf_size)

    def to(self, device) -> "FatBVH":
        return FatBVH(self.nodes.to(device), self.tri.to(device),
                      self.nodes16.to(device), self.leafmat.to(device),
                      self.n_nodes, self.n_tris, self.leaf_size)


def leaf_matrices(tri_rows: np.ndarray, leaf_size: int) -> np.ndarray:
    """(L*T, 9) leaf-aligned (v0, e1, e2) rows -> (L*16, 4T) f32 slabs,
    computed in float64 (padding rows give all-zero columns: det 0, never
    valid). Slabs are uncentred (world-space v0), so a ray's features do
    not depend on the leaf. Row 10 (feature 10 is 0) carries the leaf's
    base triangle index in column 0."""
    t = leaf_size
    n = tri_rows.shape[0]
    if n % t:
        raise ValueError(f"{n} rows are not whole leaves of {t}")
    L = n // t
    r = tri_rows.reshape(L, t, 9).astype(np.float64)
    v0, e1, e2 = r[..., 0:3], r[..., 3:6], r[..., 6:9]
    real = (np.abs(e1).sum(-1) + np.abs(e2).sum(-1)) > 0  # (L, T)
    n12 = np.cross(e1, e2)
    m = np.zeros((L, F, 4 * t), np.float64)
    m[:, 6:9, 0 * t:1 * t] = np.cross(e2, e1).transpose(0, 2, 1)
    m[:, 0:3, 1 * t:2 * t] = e2.transpose(0, 2, 1)
    m[:, 6:9, 1 * t:2 * t] = -np.cross(e2, v0).transpose(0, 2, 1)
    m[:, 0:3, 2 * t:3 * t] = -e1.transpose(0, 2, 1)
    m[:, 6:9, 2 * t:3 * t] = -np.cross(v0, e1).transpose(0, 2, 1)
    m[:, 3:6, 3 * t:4 * t] = n12.transpose(0, 2, 1)
    m[:, 9, 3 * t:4 * t] = -(v0 * n12).sum(-1)
    for blk in range(4):  # padding columns exactly zero
        mm = m[:, :, blk * t:(blk + 1) * t]
        mm[np.broadcast_to(~real[:, None, :], mm.shape)] = 0.0
    m[:, 10, 0] = np.arange(L, dtype=np.float64) * t
    return m.reshape(L * F, 4 * t).astype(np.float32)


def _pack_octant_nodes_fat(oct_tables: dict, m: int, leaf_size: int):
    """The 8 octant layouts with leaf meta = leaf index (first // T),
    stacked to (8*M16, 128); plus the octant-0 (M, 8) plain table."""
    packed = []
    nodes0 = None
    for o in range(8):
        nodes = np.zeros((m, 8), np.float32)
        nodes[:, 0:3] = oct_tables["bmin"][o]
        nodes[:, 3:6] = oct_tables["bmax"][o]
        is_leaf = oct_tables["first"][o] >= 0
        meta = np.where(is_leaf, oct_tables["first"][o] // leaf_size,
                        -1).astype(np.int32)
        skip = np.where(oct_tables["skip"][o] < 0, m,
                        oct_tables["skip"][o]).astype(np.int32)
        nodes[:, 6] = meta.view(np.float32)
        nodes[:, 7] = skip.view(np.float32)
        packed.append(_pad_rows8(_pack_lane_dense(nodes, 16, 8)))
        if o == 0:
            nodes0 = nodes
    return np.concatenate(packed, axis=0), nodes0


def build_bvh_fat_np(tri_verts: np.ndarray, leaf_size: int | None = None):
    """Host build over (N, 3, 3) world-space triangles. Returns ``(fields,
    tri_order)``: the NumPy tables under :data:`FAT_KEYS` and the padded
    leaf-aligned permutation (uint32, SENTINEL = padding)."""
    if leaf_size is None:
        leaf_size = LEAF_SIZE_FAT
    tri_verts = np.ascontiguousarray(tri_verts, np.float32)
    n = tri_verts.shape[0]
    if n == 0:
        tri0 = np.zeros((leaf_size, 9), np.float32)
        nodes = np.zeros((1, 8), np.float32)
        meta = np.zeros((1, 2), np.int32)
        meta[0] = [0, 1]  # leaf 0, skip 1
        nodes[:, 6:8] = meta.view(np.float32)
        n16 = _pad_rows8(_pack_lane_dense(nodes, 16, 8))
        fields = dict(nodes=nodes, tri=tri0, nodes16=np.tile(n16, (8, 1)),
                      leafmat=leaf_matrices(tri0, leaf_size), n_nodes=1,
                      n_tris=0, leaf_size=leaf_size)
        return fields, np.zeros(0, np.uint32)
    from glaze_tpu_torch import native

    oct_tables = native.get_lib().bvh_build_octants(tri_verts, leaf_size)
    m = oct_tables["bmin"].shape[1]
    order = oct_tables["tri_order"]
    tri = sorted_tri_rows(tri_verts, order)
    nodes16, nodes0 = _pack_octant_nodes_fat(oct_tables, m, leaf_size)
    fields = dict(nodes=nodes0, tri=tri, nodes16=nodes16,
                  leafmat=leaf_matrices(tri, leaf_size), n_nodes=int(m),
                  n_tris=int(n), leaf_size=leaf_size)
    return fields, order


def fat_from_np(fields: dict, device) -> FatBVH:
    """A :class:`FatBVH` on ``device`` from host tables (:data:`FAT_KEYS`);
    the coefficient table is gathered there."""
    return FatBVH(float_table_to(fields["nodes"], device),
                  float_table_to(fields["tri"], device),
                  float_table_to(fields["nodes16"], device),
                  float_table_to(fields["leafmat"], device),
                  int(fields["n_nodes"]), int(fields["n_tris"]),
                  int(fields["leaf_size"]))


def build_bvh_fat(tri_verts: np.ndarray, device, leaf_size: int | None = None):
    """Builds a :class:`FatBVH` on ``device``; returns ``(bvh,
    tri_order)`` (see :func:`build_bvh_fat_np`)."""
    fields, order = build_bvh_fat_np(tri_verts, leaf_size)
    return fat_from_np(fields, device), order


# ---------------------------------------------------------------------------
# Plain walkers
# ---------------------------------------------------------------------------


def _ray_features(o, d):
    """(R, 10) features [o x d, o, d, 1] of rays (R, 3), o x d as
    ``a*b - c*d`` per component (the kernels' order)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    return torch.stack([oy * dz - oz * dy, oz * dx - ox * dz,
                        ox * dy - oy * dx, ox, oy, oz, dx, dy, dz,
                        torch.ones_like(ox)], dim=1)


def _leaf_columns(coef, slots, feat):
    """Resolves the leaf columns ``slots`` ((K, T) slot ids) for rays with
    features ``feat`` (K, 10). Returns ``(valid, t, inv, ud, vd)``, each
    (K, T): ``valid`` is the det-scaled inside test (traverse_fat.py
    :145-149) without the t bounds; the hit's barycentrics are ``ud*inv``
    and ``vd*inv``."""
    c = coef[slots]  # (K, T, COEF_W)
    sums = [None] * 4
    for i, (blk, row) in enumerate(COEF_TERMS):
        term = c[..., i] * feat[:, row, None]
        sums[blk] = term if sums[blk] is None else sums[blk] + term
    det, ud, vd, td = sums
    ok = torch.abs(det) >= DET_EPS
    inv = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    t = td * inv
    valid = (ok & (ud * det >= 0.0) & (vd * det >= 0.0)
             & ((ud + vd) * det <= det * det))
    return valid, t, inv, ud, vd


def closest_column(valid, t, cap):
    """The closest hit among a leaf's columns ((K, T) ``valid`` and ``t``)
    for rays whose best so far is ``cap`` (K,): ``(tmin, kmin, better)``,
    where ``better`` marks rays with a column in (T_MIN, cap) and ``kmin``
    is the lowest column of the least t (``torch.min`` returns the first
    index of a tie, the sequential scan's strict ``<``)."""
    keep = valid & (t > T_MIN) & (t < cap[:, None])
    tt = torch.where(keep, t, torch.full_like(t, float("inf")))
    tmin, kmin = torch.min(tt, dim=1)
    return tmin, kmin, tmin < cap


def _walk(bvh: FatBVH, origin, direction, cap, t_min, active,
          stats: WalkStats | None, closest: bool):
    """The walk both plain walkers share, each ray in its own octant's
    order of ``nodes16``, finished lanes compacted out. Closest hit: every
    column of an entered leaf is tested against the best t so far (the
    lowest column wins a tie of t, as in the kernel's ordered scan).
    Any hit: a lane stops at its first column with t in (t_min, cap); its
    ``col_tests`` count the columns up to that one, as the kernel scans."""
    dev = origin.device
    origin = origin.to(torch.float32)
    direction = direction.to(torch.float32)
    table, base = _node_table(bvh, direction)
    r = origin.shape[0]
    m = bvh.n_nodes
    T = bvh.leaf_size
    cols = torch.arange(T, device=dev)
    best_t = cap.clone()
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((r,), dtype=torch.float32, device=dev)
    blocked = torch.zeros((r,), dtype=torch.bool, device=dev)
    lane = torch.arange(r, device=dev)
    if active is not None:
        lane = lane[active]
    o, d = origin[lane], direction[lane]
    inv, feat, base = safe_inv(d), _ray_features(o, d), base[lane]
    bt = best_t[lane]
    btri, bu, bv = best_tri[lane], best_u[lane], best_v[lane]
    ptr = torch.zeros(lane.shape, dtype=torch.int64, device=dev)
    while lane.numel():
        row = table[base + ptr]
        meta = row[:, 6].contiguous().view(torch.int32)
        skip = row[:, 7].contiguous().view(torch.int32).long()
        box_hit = _slab_test(row, o, inv, bt)
        is_leaf = meta >= 0
        if stats is not None:
            stats.node_visits += lane.numel()
            stats.touch("nodes", base + ptr, table.shape[0])
            stats.count_lanes(lane, box_hit & is_leaf, r)
        stop = torch.zeros_like(box_hit)
        li = torch.nonzero(box_hit & is_leaf).squeeze(1)
        for s in range(0, li.numel(), LEAF_CHUNK):
            idx = li[s:s + LEAF_CHUNK]
            slots = meta[idx].long()[:, None] * T + cols
            valid, t, tinv, ud, vd = _leaf_columns(bvh.coef, slots, feat[idx])
            if closest:
                tmin, kmin, better = closest_column(valid, t, bt[idx])
                bi = idx[better]
                kb = kmin[better][:, None]
                bt[bi] = tmin[better]
                btri[bi] = torch.gather(slots[better], 1, kb)[:, 0].to(torch.int32)
                inv_w = torch.gather(tinv[better], 1, kb)[:, 0]
                bu[bi] = torch.gather(ud[better], 1, kb)[:, 0] * inv_w
                bv[bi] = torch.gather(vd[better], 1, kb)[:, 0] * inv_w
                tested = torch.ones_like(valid)
            else:
                keep = valid & (t > t_min) & (t < bt[idx, None])
                found = keep.any(dim=1)
                stop[idx] = found
                first = torch.where(found, keep.to(torch.int8).argmax(dim=1),
                                    torch.full_like(idx, T - 1))
                tested = cols[None, :] <= first[:, None]
            if stats is not None:
                stats.col_tests += int(tested.sum())
                stats.touch("coef", slots[tested], bvh.coef.shape[0])
        ptr = torch.where(box_hit & ~is_leaf, ptr + 1, skip)
        alive = (ptr < m) & ~stop
        blocked[lane[stop]] = True
        done = lane[~alive]
        if done.numel():
            if closest:
                best_t[done] = bt[~alive]
                best_tri[done] = btri[~alive]
                best_u[done] = bu[~alive]
                best_v[done] = bv[~alive]
            lane, ptr, base = lane[alive], ptr[alive], base[alive]
            o, d, inv, feat = o[alive], d[alive], inv[alive], feat[alive]
            bt, btri, bu, bv = bt[alive], btri[alive], bu[alive], bv[alive]
    if not closest:
        return blocked
    found = best_tri >= 0
    t = torch.where(found, best_t, torch.full_like(best_t, float("inf")))
    return {"t": t, "tri": best_tri, "u": best_u, "v": best_v}


def closest_hit_fat(bvh: FatBVH, origin, direction, t_max=None,
                    stats: WalkStats | None = None):
    """Closest-hit trace of (R, 3) rays on a fat tree, the contract of
    :func:`glaze_tpu_torch.accel.bvh.closest_hit`: a dict of (R,) ``t``
    (inf on a miss), ``tri`` (int32 slot, -1 on a miss), ``u``, ``v``;
    hits in (T_MIN, t_max). An empty scene's placeholder leaf has only
    zero columns, so it reports misses by construction."""
    r = origin.shape[0]
    if t_max is None:
        cap = torch.full((r,), float("inf"), dtype=torch.float32,
                         device=origin.device)
    else:
        cap = torch.broadcast_to(torch.as_tensor(
            t_max, dtype=torch.float32, device=origin.device), (r,))
    return _walk(bvh, origin, direction, cap, None, None, stats, closest=True)


def any_hit_fat(bvh: FatBVH, origin, direction, t_max, t_min=1e-3,
                active=None, stats: WalkStats | None = None):
    """Shadow-ray trace on a fat tree: True where a triangle lies in
    (t_min, t_max); lanes where ``active`` is False never walk and report
    False."""
    cap = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=origin.device), (origin.shape[0],))
    return _walk(bvh, origin, direction, cap, float(t_min), active, stats,
                 closest=False)


__all__ = ["FatBVH", "LEAF_SIZE_FAT", "F", "DET_EPS", "COEF_TERMS",
           "COEF_W", "FAT_KEYS", "coef_table", "leaf_matrices",
           "build_bvh_fat_np", "build_bvh_fat", "fat_from_np",
           "closest_hit_fat", "any_hit_fat"]
