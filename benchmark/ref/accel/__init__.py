# Frozen copy of glaze_tpu_torch/accel/__init__.py for the benchmark's plain
# reference: the classic tree alone (the benchmark's configurations render
# on it), and the CUDA kernels replaced by plain walks.
"""Acceleration structures of the reference: the classic SAH tree (a
forest beyond ``bvh.CHUNK_MAX_TRIS``) and two plain ways to walk it.

Few rays (at most :data:`BLOCK_WALK_MAX_RAYS`) take :mod:`.blocks`, which
tests each ray against every triangle row of the leaf blocks whose boxes
it crosses; more take the frozen plain walkers of :mod:`.bvh`. Both give
the hits the port's walks give: the closest accepted hit, any hit, and the
opacity cells of a tree that carries them. Where two triangles tie exactly
on t they may name different ones.
"""

import torch

from benchmark.ref.accel import blocks
from benchmark.ref.accel.bvh import (
    BVH,
    ChunkedBVH,
    any_hit,
    any_hit_masked,
    build_bvh_chunked_np,
    bvh_from_np,
    closest_hit,
    closest_hit_masked,
    has_payload,
)

BLOCK_WALK_MAX_RAYS = 65536


def build_bvh_auto_np(tri_verts, leaf_size=None):
    """``(fields, tri_order, None)``: the classic tree's host tables
    (chunked beyond CHUNK_MAX_TRIS)."""
    fields, order = build_bvh_chunked_np(tri_verts)
    return fields, order, None


def tree_from_np(fields: dict, device):
    return bvh_from_np(fields, device)


def _few(origin3) -> bool:
    return origin3[0].shape[0] <= BLOCK_WALK_MAX_RAYS


def _merge_closest(hit, h, off):
    better = h["tri"] >= 0
    out = {k: torch.where(better, h[k], hit[k]) for k in hit}
    out["tri"] = torch.where(better, h["tri"] + off, hit["tri"])
    return out


def _chunked_closest(bvh, trace_one, t_max):
    hit = None
    for chunk, off in zip(bvh.chunks, bvh.offsets):
        if hit is None:
            cap = t_max
        elif t_max is None:
            cap = hit["t"]
        else:
            cap = torch.minimum(hit["t"], torch.as_tensor(
                t_max, dtype=torch.float32, device=hit["t"].device))
        h = trace_one(chunk, cap)
        if hit is None:
            hit = dict(h, tri=torch.where(h["tri"] >= 0, h["tri"] + off,
                                          h["tri"]))
        else:
            hit = _merge_closest(hit, h, off)
    return hit


def _chunked_any(bvh, trace_one, active):
    res = None
    for chunk in bvh.chunks:
        if res is None:
            a = active
        else:
            a = ~res if active is None else active & ~res
        r = trace_one(chunk, a)
        res = r if res is None else res | r
    return res


def _chunked_any_masked(bvh, trace_one, active):
    blocked = pending = None
    for chunk in bvh.chunks:
        if blocked is None:
            a = active
        else:
            a = ~blocked if active is None else active & ~blocked
        b, p = trace_one(chunk, a)
        blocked = b if blocked is None else blocked | b
        pending = p if pending is None else pending | p
    return blocked, pending & ~blocked


def closest_hit_soa_auto(bvh, origin3, direction3, t_max=None):
    if isinstance(bvh, ChunkedBVH):
        return _chunked_closest(
            bvh, lambda c, cap: closest_hit_soa_auto(c, origin3, direction3,
                                                     cap), t_max)
    if _few(origin3):
        return blocks.closest(bvh, origin3, direction3, t_max, masked=False)
    return closest_hit(bvh, torch.stack(origin3, -1),
                       torch.stack(direction3, -1), t_max)


def any_hit_soa_auto(bvh, origin3, direction3, t_max, t_min=1e-3, active=None):
    if isinstance(bvh, ChunkedBVH):
        return _chunked_any(
            bvh, lambda c, a: any_hit_soa_auto(c, origin3, direction3, t_max,
                                               t_min=t_min, active=a), active)
    if _few(origin3):
        return blocks.any_hit(bvh, origin3, direction3, t_max, t_min, active,
                              masked=False)
    return any_hit(bvh, torch.stack(origin3, -1), torch.stack(direction3, -1),
                   t_max, t_min=t_min, active=active)


def closest_hit_soa_masked_auto(bvh, origin3, direction3, t_max=None):
    if not has_payload(bvh):
        out = closest_hit_soa_auto(bvh, origin3, direction3, t_max)
        return dict(out, mixed=out["tri"] >= 0)
    if isinstance(bvh, ChunkedBVH):
        return _chunked_closest(
            bvh, lambda c, cap: closest_hit_soa_masked_auto(
                c, origin3, direction3, cap), t_max)
    if _few(origin3):
        return blocks.closest(bvh, origin3, direction3, t_max, masked=True)
    return closest_hit_masked(bvh, torch.stack(origin3, -1),
                              torch.stack(direction3, -1), t_max)


def masked_anyhit_ok(bvh) -> bool:
    return has_payload(bvh)


def any_hit_soa_masked_auto(bvh, origin3, direction3, t_max, t_min=1e-3,
                            active=None):
    if not has_payload(bvh):
        blocked = any_hit_soa_auto(bvh, origin3, direction3, t_max,
                                   t_min=t_min, active=active)
        return torch.zeros_like(blocked), blocked
    if isinstance(bvh, ChunkedBVH):
        return _chunked_any_masked(
            bvh, lambda c, a: any_hit_soa_masked_auto(
                c, origin3, direction3, t_max, t_min=t_min, active=a), active)
    if _few(origin3):
        return blocks.any_hit(bvh, origin3, direction3, t_max, t_min, active,
                              masked=True)
    return any_hit_masked(bvh, torch.stack(origin3, -1),
                          torch.stack(direction3, -1), t_max, t_min=t_min,
                          active=active)
