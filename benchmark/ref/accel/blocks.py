"""Plain walks for a few rays: each ray against every triangle row of the
leaf blocks whose boxes it crosses.

A tree's triangle rows (``bvh.tri``, in leaf order) are cut into blocks of
:data:`BLOCK` consecutive rows, each with a box around its triangles,
widened a little so that no hit the Moller-Trumbore test finds lies
outside it. A ray tests the triangles of every block its segment crosses
with the frozen walkers' own intersection (:func:`bvh._tri_intersect`),
so a hit's t, u and v are the bits the port's walks report. The closest
hit is the least t, and among equal t the lowest row. The accept rules
are those of :mod:`benchmark.ref.accel.bvh`: hits in (T_MIN, cap), an
any hit in (t_min, cap) of an active ray, and in a tree with opacity
cells TRANSPARENT cells skipped, OPAQUE cells blocking and MIXED ones
pending.

It needs no tree walk, so its cost is a few dozen tensor operations a
call whatever the tree's depth: the reference's walks over its sampled
lanes.
"""

from __future__ import annotations

import torch

from benchmark.ref.accel.bvh import (
    ALPHA_MASK_WORDS,
    T_MIN,
    TRI_PAYLOAD_BASE,
    _mask_bits,
    _tri_intersect,
    safe_inv,
)

BLOCK = 64
PAIRS_PER_PASS = 32768  # (ray, block) pairs tested at once
RAYS_PER_BOX_PASS = 4096


class _Blocks:
    def __init__(self, tri):
        rows = tri[:, :9].contiguous()
        n = rows.shape[0]
        nb = -(-n // BLOCK)
        pad = nb * BLOCK - n
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad, 9))])
        v0 = rows[:, 0:3]
        v1 = v0 + rows[:, 3:6]
        v2 = v0 + rows[:, 6:9]
        real = (rows[:, 3:9] != 0).any(dim=1)
        big = torch.full_like(v0, float("inf"))
        lo = torch.minimum(torch.minimum(v0, v1), v2)
        hi = torch.maximum(torch.maximum(v0, v1), v2)
        lo = torch.where(real[:, None], lo, big).view(nb, BLOCK, 3).amin(1)
        hi = torch.where(real[:, None], hi, -big).view(nb, BLOCK, 3).amax(1)
        empty = ~torch.isfinite(lo).all(dim=1)
        lo = torch.where(empty[:, None], torch.zeros_like(lo), lo)
        hi = torch.where(empty[:, None], torch.full_like(hi, -1.0), hi)
        widen = 1e-4 + 1e-5 * torch.maximum(lo.abs(), hi.abs())
        self.lo = lo - widen
        self.hi = hi + widen
        self.rows = rows
        self.n = n
        self.payload = None
        if tri.shape[1] >= TRI_PAYLOAD_BASE + ALPHA_MASK_WORDS:
            self.payload = tri.view(torch.int32)[
                :, TRI_PAYLOAD_BASE:TRI_PAYLOAD_BASE + ALPHA_MASK_WORDS]


def _blocks(bvh) -> _Blocks:
    b = getattr(bvh, "_ref_blocks", None)
    if b is None:
        b = _Blocks(bvh.tri)
        bvh._ref_blocks = b
    return b


def _cap(t_max, r, device):
    if t_max is None:
        return torch.full((r,), float("inf"), dtype=torch.float32,
                          device=device)
    return torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=device), (r,)).contiguous()


def _pairs(blk: _Blocks, o, d, cap, lanes):
    """(ray, block) pairs whose slab test passes for the rays ``lanes``,
    as two int64 tensors."""
    rays, bls = [], []
    inv = safe_inv(d)
    for s in range(0, lanes.shape[0], RAYS_PER_BOX_PASS):
        li = lanes[s:s + RAYS_PER_BOX_PASS]
        oo, ii, cc = o[li][:, None, :], inv[li][:, None, :], cap[li][:, None]
        t0 = (blk.lo[None] - oo) * ii
        t1 = (blk.hi[None] - oo) * ii
        tenter = torch.minimum(t0, t1).amax(dim=2)
        texit = torch.maximum(t0, t1).amin(dim=2)
        ok = (tenter <= texit) & (texit >= T_MIN) & (tenter <= cc)
        ri, bi = torch.nonzero(ok, as_tuple=True)
        rays.append(li[ri])
        bls.append(bi)
    if not rays:  # no lane to walk
        none = torch.zeros((0,), dtype=torch.int64, device=o.device)
        return none, none
    return torch.cat(rays), torch.cat(bls)


def _tests(blk: _Blocks, o, d, rays, bls):
    """Moller-Trumbore of every row of the blocks ``bls`` against the rays
    ``rays``, in passes: yields (ray ids (K, 1), row ids (K, BLOCK), t, u,
    v, hit)."""
    k = torch.arange(BLOCK, device=o.device)
    for s in range(0, rays.shape[0], PAIRS_PER_PASS):
        ri = rays[s:s + PAIRS_PER_PASS]
        ids = bls[s:s + PAIRS_PER_PASS, None] * BLOCK + k[None, :]
        t, u, v, hit = _tri_intersect(blk.rows[ids], o[ri][:, None, :],
                                      d[ri][:, None, :])
        yield ri[:, None], ids, t, u, v, hit & (ids < blk.n)


def _cells(blk: _Blocks, ids, u, v, hit):
    return _mask_bits(blk.payload[ids.clamp(max=blk.n - 1)], u, v, hit)


def closest(bvh, origin3, direction3, t_max=None, masked: bool = False):
    """The closest accepted hit of SoA rays: a dict of (R,) ``t`` (inf on
    a miss), ``tri`` (int32, -1), ``u``, ``v`` (0 on a miss) and, with
    ``masked``, ``mixed``."""
    blk = _blocks(bvh)
    o = torch.stack(origin3, -1).to(torch.float32)
    d = torch.stack(direction3, -1).to(torch.float32)
    r = o.shape[0]
    dev = o.device
    cap = _cap(t_max, r, dev)
    masked = masked and blk.payload is not None
    none = torch.iinfo(torch.int64).max
    best = torch.full((r,), none, dtype=torch.int64, device=dev)
    rays, bls = _pairs(blk, o, d, cap, torch.arange(r, device=dev))
    for ri, ids, t, u, v, hit in _tests(blk, o, d, rays, bls):
        keep = hit & (t < cap[ri])
        if masked:
            keep = keep & (_cells(blk, ids, u, v, keep) != 2)
        # (t, row) ordered as one int64: t > 0, so its bits order as it does
        key = (t.contiguous().view(torch.int32).to(torch.int64) << 32) | ids
        key = torch.where(keep, key, torch.full_like(key, none))
        best.scatter_reduce_(0, ri.expand_as(key).reshape(-1),
                             key.reshape(-1), reduce="amin")
    found = best != none
    row = torch.where(found, best & 0xFFFFFFFF, torch.zeros_like(best))
    t, u, v, _ = _tri_intersect(blk.rows[row][:, None, :], o[:, None, :],
                                d[:, None, :])
    t, u, v = t[:, 0], u[:, 0], v[:, 0]
    zero = torch.zeros_like(t)
    out = {"t": torch.where(found, t, torch.full_like(t, float("inf"))),
           "tri": torch.where(found, row, torch.full_like(row, -1)).to(
               torch.int32),
           "u": torch.where(found, u, zero), "v": torch.where(found, v, zero)}
    if masked:
        out["mixed"] = found & (_cells(blk, row[:, None], u[:, None],
                                       v[:, None], found[:, None])[:, 0] == 0)
    return out


def any_hit(bvh, origin3, direction3, t_max, t_min=1e-3, active=None,
            masked: bool = False):
    """Any hit of SoA rays in (t_min, t_max): (R,) bool, or with
    ``masked`` and opacity cells ``(blocked, pending)``."""
    blk = _blocks(bvh)
    o = torch.stack(origin3, -1).to(torch.float32)
    d = torch.stack(direction3, -1).to(torch.float32)
    r = o.shape[0]
    dev = o.device
    cap = _cap(t_max, r, dev)
    masked = masked and blk.payload is not None
    lanes = torch.arange(r, device=dev)
    if active is not None:
        lanes = lanes[active]
    blocked = torch.zeros((r,), dtype=torch.int32, device=dev)
    pending = torch.zeros((r,), dtype=torch.int32, device=dev)
    rays, bls = _pairs(blk, o, d, cap, lanes)
    for ri, ids, t, u, v, hit in _tests(blk, o, d, rays, bls):
        new = hit & (t > t_min) & (t < cap[ri])
        idx = ri.expand_as(new).reshape(-1)
        if masked:
            bits = _cells(blk, ids, u, v, new)
            pending.scatter_reduce_(0, idx, (new & (bits == 0)).to(
                torch.int32).reshape(-1), reduce="amax")
            new = new & (bits == 1)
        blocked.scatter_reduce_(0, idx, new.to(torch.int32).reshape(-1),
                                reduce="amax")
    blocked = blocked > 0
    if masked:
        return blocked, (pending > 0) & ~blocked
    return blocked
