"""Fat-leaf drain probe (T1): the leaf test of the fat tree on tensor cores.

Moller-Trumbore is multilinear in the per-ray features x = [o' x d, o',
d, 1] (o' = o - leaf centre): per triangle a 16x4 coefficient block maps
x to (det, u*det, v*det, t*det), so one product of a leaf's (16, 4T)
matrix, transposed, with the (16, 128) features of 128 rays tests a whole
T-triangle leaf against them. This probe runs that drain on the card:

  1. agreement with the exact scalar Moller-Trumbore (float64 NumPy) at
     each precision: ``highest`` (3xTF32 on mma.sync) and ``default``
     (one bf16 pass);
  2. time per (row, leaf) drain at T in {16, 32, 64, 128}, for one block
     of 128 rays and for one block per SM (distinct rays, the same leaf
     order), in ns and in cycles at the SM clock nvidia-smi reports.

The kernel is ``drain_kernel`` in ``csrc/probes.cu``; ``drain_probe_plain``
is its plain torch version, which reproduces the card's operand rounding
(TF32 round-to-nearest-away by integer rounding of the f32 bits, bf16
round-to-nearest-even) and sums the exact products in float64.

Usage: python -m glaze_tpu_torch.tools.bench_mxu [T ...] [highest|default ...]
       [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from glaze_tpu_torch.device import resolve_device
from glaze_tpu_torch.tools import common, probes_cuda

T_MIN = 1e-4
DET_EPS = 1e-12
F = probes_cuda.F  # feature rows (10 used)
TS = probes_cuda.TS
PRECISIONS = ("highest", "default")
TIMING_REPS = (8192, 24576)


def leaf_matrices(tri_verts, T):
    """(N,3,3) world triangles -> (L, 16, W) leaf matrices + (L,3) centres,
    W = 4T rounded up to a multiple of 128.

    Column layout within 4T: [det | u*det | v*det | t*det] blocks of T.
    Padding triangles (all-zero rows) produce det=0 -> never valid.
    """
    n = tri_verts.shape[0]
    L = -(-n // T)
    pad = L * T - n
    tv = np.concatenate([tri_verts,
                         np.zeros((pad, 3, 3), np.float32)]) if pad else tri_verts
    tv = tv.reshape(L, T, 3, 3).astype(np.float64)
    # leaf centre from REAL tris only
    counts = np.minimum(np.maximum(n - np.arange(L) * T, 1), T)
    centre = np.stack([tv[l, :counts[l], 0].mean(0) for l in range(L)])
    v0 = tv[:, :, 0] - centre[:, None]
    e1 = tv[:, :, 1] - tv[:, :, 0]
    e2 = tv[:, :, 2] - tv[:, :, 0]
    n12 = np.cross(e1, e2)
    m = np.zeros((L, F, 4 * T), np.float64)
    # det
    m[:, 6:9, 0 * T:1 * T] = np.cross(e2, e1).transpose(0, 2, 1)
    # u*det
    m[:, 0:3, 1 * T:2 * T] = e2.transpose(0, 2, 1)
    m[:, 6:9, 1 * T:2 * T] = -np.cross(e2, v0).transpose(0, 2, 1)
    # v*det
    m[:, 0:3, 2 * T:3 * T] = -e1.transpose(0, 2, 1)
    m[:, 6:9, 2 * T:3 * T] = -np.cross(v0, e1).transpose(0, 2, 1)
    # t*det
    m[:, 3:6, 3 * T:4 * T] = n12.transpose(0, 2, 1)
    m[:, 9, 3 * T:4 * T] = -(v0 * n12).sum(-1)
    # the lane dimension is padded to a multiple of 128, as the tool's
    w = -(-4 * T // 128) * 128
    if w != 4 * T:
        m = np.concatenate([m, np.zeros((L, F, w - 4 * T))], axis=2)
    return m.astype(np.float32), centre.astype(np.float32)


def np_reference(tri_verts, o, d, t_cap):
    """Exact scalar MT over all tris; returns (t, tri) per ray."""
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    best_t = np.full(o.shape[0], np.inf)
    best_i = np.full(o.shape[0], -1)
    for i in range(len(v0)):
        p = np.cross(d, e2[i])
        det = p @ e1[i]
        ok = np.abs(det) >= DET_EPS
        inv = np.where(ok, 1.0 / np.where(det == 0, 1, det), 0.0)
        tv = o - v0[i]
        u = (tv * p).sum(-1) * inv
        q = np.cross(tv, e1[i])
        v = (d * q).sum(-1) * inv
        t = (q @ e2[i]) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN) & \
            (t < np.minimum(best_t, t_cap))
        best_t = np.where(hit, t, best_t)
        best_i = np.where(hit, i, best_i)
    return best_t, best_i


# ---------------------------------------------------------------------------
# the card's operand rounding and the plain products


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 to 10 mantissa bits, to nearest with ties
    away from zero (integer rounding of the bits); inf and NaN pass."""
    b = x.contiguous().view(torch.int32)
    r = ((b + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``__float2bfloat16_rn``: to nearest even bf16, back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def operand_parts(a, b, precision):
    """The (A, B) operand pairs whose products the tensor cores sum for
    ``precision``: 3xTF32 (hi*hi, hi*lo, lo*hi) for ``highest``, one bf16
    pass for ``default``, the bf16 hi/lo split for ``split3``."""
    if precision == "default":
        return [(bf16_round(a), bf16_round(b))]
    rnd = {"highest": tf32_round, "split3": bf16_round}[precision]
    ah, bh = rnd(a), rnd(b)
    al, bl = rnd(a - ah), rnd(b - bh)
    return [(ah, bh), (ah, bl), (al, bh)]


def product_plain(a, b, precision):
    """(16, M)^T (16, N) -> (M, N) float32 at ``precision``: the exact
    products of the rounded operand parts summed in float64, then rounded
    once (the kernel sums them in its f32 accumulator, in another order).
    Plain torch, no matrix-product call."""
    out = 0.0
    for pa, pb in operand_parts(a, b, precision):
        out = out + (pa.double()[:, :, None] * pb.double()[:, None, :]).sum(0)
    return out.float()


def resolve_plain(out, T):
    """The det-scaled closest-hit resolve of one leaf's (4T, R) product
    with no t cap: per ray the least valid t, its lowest column (T where
    none is valid), and u, v of that column."""
    det, ud, vd, td = (out[i * T:(i + 1) * T] for i in range(4))
    ok = det.abs() >= DET_EPS
    one = torch.ones_like(det)
    inv = torch.where(ok, one / torch.where(det == 0.0, one, det),
                      torch.zeros_like(det))
    t = td * inv
    valid = (ok & (ud * det >= 0.0) & (vd * det >= 0.0)
             & ((ud + vd) * det <= det * det) & (t > T_MIN))
    tt = torch.where(valid, t, torch.full_like(t, float("inf")))
    tmin = tt.amin(0)
    iota = torch.arange(T, device=out.device)[:, None].expand_as(tt)
    col = torch.where(valid & (tt <= tmin), iota,
                      torch.full_like(iota, T)).amin(0)
    at = col.clamp(max=T - 1)[None]
    u = (ud * inv).gather(0, at)[0]
    v = (vd * inv).gather(0, at)[0]
    return tmin, col, u, v


def ray_features(o, d, centre):
    """(16, R) features [o' x d, o', d, 1, 0 ...] of rays o, d (3, R)
    about a leaf centre (3,), in the kernel's order of operations."""
    px, py, pz = o[0] - centre[0], o[1] - centre[1], o[2] - centre[2]
    dx, dy, dz = d[0], d[1], d[2]
    one = torch.ones_like(px)
    zero = torch.zeros_like(px)
    return torch.stack([py * dz - pz * dy, pz * dx - px * dz,
                        px * dy - py * dx, px, py, pz, dx, dy, dz, one]
                       + [zero] * (F - 10))


def as_rows(res, t_init=float("inf")):
    """(R,) t/tri/u/v -> the tool's (8, R) outputs: row 0 the result, the
    other rows as the kernel initialised them."""
    r = res["t"].shape[0]
    dev = res["t"].device
    t = torch.full((8, r), t_init, dtype=torch.float32, device=dev)
    tri = torch.full((8, r), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((8, r), dtype=torch.float32, device=dev)
    v = torch.zeros((8, r), dtype=torch.float32, device=dev)
    t[0], tri[0], u[0], v[0] = res["t"], res["tri"], res["u"], res["v"]
    return t, tri, u, v


def no_hits(r, device, t_init=float("inf")):
    """The drain's initial best of ``r`` rays: t_init, tri -1, u = v = 0."""
    return {"t": torch.full((r,), t_init, dtype=torch.float32, device=device),
            "tri": torch.full((r,), -1, dtype=torch.int32, device=device),
            "u": torch.zeros((r,), dtype=torch.float32, device=device),
            "v": torch.zeros((r,), dtype=torch.float32, device=device)}


def fold_leaf(best, leaf, T, tmin, col, u, v):
    """A leaf's resolve replaces ``best`` where its tmin is strictly less.
    Returns the new best and that mask."""
    better = tmin < best["t"]
    return {"t": torch.where(better, tmin, best["t"]),
            "tri": torch.where(better, (leaf * T + col).to(torch.int32),
                               best["tri"]),
            "u": torch.where(better, u, best["u"]),
            "v": torch.where(better, v, best["v"])}, better


def drain_probe_plain(mats, centres, rays, order, T, precision="highest"):
    """Plain torch version of :func:`drain_probe` (any device): every
    step of ``order`` drains its leaf, as the kernel does (a repeated leaf
    changes nothing, since only a strictly smaller t replaces the best)."""
    L = mats.shape[0] // F
    slabs = mats.reshape(L, F, -1)[:, :, :4 * T]
    o, d = rays[0:3], rays[3:6]
    best = no_hits(rays.shape[1], rays.device)
    for leaf in order.tolist():
        best, _ = fold_leaf(best, leaf, T, *resolve_plain(product_plain(
            slabs[leaf], ray_features(o, d, centres[leaf]), precision), T))
    return as_rows(best)


def drain_probe(mats, centres, rays, order, T, precision="highest"):
    """T1 drain: blocks of 128 rays visit the leaves of ``order`` and
    resolve the closest hit. ``mats`` (L*16, W) leaf matrices, ``centres``
    (L, 3), ``rays`` (8, R) (rows 0-2 origins, 3-5 directions; R a
    multiple of 128), ``order`` (reps,) int32. Returns (8, R) t (inf: no
    hit), tri (int32, -1), u, v in row 0. A CPU tensor takes the plain
    version; a CUDA tensor the kernel (or raises)."""
    if rays.device.type == "cpu":
        return drain_probe_plain(mats, centres, rays, order, T, precision)
    o3 = tuple(rays[i] for i in range(3))
    d3 = tuple(rays[i] for i in range(3, 6))
    return as_rows(probes_cuda.fat_drain(mats, centres, order, o3, d3, T,
                                         precision))


def probe_inputs(T, n_blocks=1):
    """The tool's inputs (rng 11): a cloud of 8T triangles ~40 units wide
    (Sponza-like magnitudes), its leaf matrices and centres, and the
    (8, 128) rays; with ``n_blocks`` > 1 another 127 x 128 ... rays (rng
    12) follow the tool's block. Returns a dict of NumPy arrays and the rng
    the tool draws its timing orders from."""
    rng = np.random.default_rng(11)
    n_tri = 8 * T
    base = rng.uniform(-20, 20, (n_tri, 1, 3))
    tri = (base + rng.uniform(-0.6, 0.6, (n_tri, 3, 3))).astype(np.float32)
    mats, centres = leaf_matrices(tri, T)
    L = mats.shape[0]
    o = rng.uniform(-22, 22, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if n_blocks > 1:
        extra = np.random.default_rng(12)
        o2 = extra.uniform(-22, 22, (128 * (n_blocks - 1), 3)).astype(np.float32)
        d2 = extra.normal(size=(128 * (n_blocks - 1), 3)).astype(np.float32)
        d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
        o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    rays = np.zeros((8, o.shape[0]), np.float32)
    rays[0:3] = o.T
    rays[3:6] = d.T
    return dict(tri=tri, mats=mats.reshape(L * F, mats.shape[2]),
                centres=centres, rays=rays, o=o, d=d, L=L), rng


AIMED_BLOCKS = 16


def aimed_rays(T, n_blocks=AIMED_BLOCKS, seed=13):
    """(8, n_blocks * 128) rays from the tool's box aimed at centroids of
    the tool's triangle cloud (:func:`probe_inputs`), so that most hit."""
    tri = probe_inputs(T)[0]["tri"]
    rng = np.random.default_rng(seed)
    n = n_blocks * 128
    o = rng.uniform(-22, 22, (n, 3)).astype(np.float32)
    d = (tri.mean(1)[rng.integers(0, tri.shape[0], n)] - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.zeros((8, n), np.float32)
    rays[0:3] = o.T
    rays[3:6] = d.T
    return rays


def tie_pairs(T):
    """The (column, copy) pairs of :func:`tie_inputs`: a triangle and its
    copy in rows g and g + 8 of one m16 tile (columns c, c + 8), in two
    m16 tiles (c, c + 16) and in the first and last tile (2, T - 1)."""
    pairs = [(c, c + 8) for c in range(4)]
    if T >= 32:
        pairs += [(c, c + 16) for c in range(4, 8)] + [(2, T - 1)]
    return pairs


TIE_LEAVES = 4
TIE_ORDER = (1, 0, 2, 3, 0, 1, 3)


def tie_inputs(T, n_rays=2048, seed=17):
    """A drain input of exact ties (rng ``seed``): a cloud of
    ``TIE_LEAVES`` leaves of T triangles in which every leaf repeats
    triangles in the columns of :func:`tie_pairs` and leaf 1 repeats leaf 0
    whole, so equal columns give bit-equal t within a step and the two
    leaves between steps; ``n_rays`` rays aimed at the centroids of the
    repeated triangles from 2-15 units away, within about 30 degrees of
    the normal (a grazing ray's t is ill-conditioned in 3xTF32, which the
    aimed rays of ``chip_smoke.py`` cover; here the point is the tie).
    Returns a dict of NumPy arrays: ``mats`` (L*16, W),
    ``centres``, ``rays`` (8, n_rays), ``order`` (:data:`TIE_ORDER`) and
    ``tied`` (L*T,) bool, the triangle ids that have a copy."""
    rng = np.random.default_rng(seed)
    n = TIE_LEAVES * T
    base = rng.uniform(-20, 20, (n, 1, 3))
    tri = (base + rng.uniform(-0.6, 0.6, (n, 3, 3))).astype(np.float32)
    tri = tri.reshape(TIE_LEAVES, T, 3, 3)
    tied = np.zeros((TIE_LEAVES, T), bool)
    for c, copy in tie_pairs(T):
        tri[:, copy] = tri[:, c]
        tied[:, [c, copy]] = True
    tri[1] = tri[0]
    tri = tri.reshape(n, 3, 3)
    mats, centres = leaf_matrices(tri, T)
    hit = tri[rng.choice(np.flatnonzero(tied.reshape(-1)), n_rays)]
    cen = hit.mean(1)
    nrm = np.cross(hit[:, 1] - hit[:, 0], hit[:, 2] - hit[:, 0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    side = nrm * rng.choice([-1.0, 1.0], (n_rays, 1))
    off = side + rng.uniform(-0.3, 0.3, (n_rays, 3))
    off /= np.linalg.norm(off, axis=-1, keepdims=True)
    o = (cen + off * rng.uniform(2.0, 15.0, (n_rays, 1))).astype(np.float32)
    d = (cen - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.zeros((8, n_rays), np.float32)
    rays[0:3] = o.T
    rays[3:6] = d.T
    return dict(mats=mats.reshape(-1, mats.shape[2]), centres=centres,
                rays=rays, order=np.asarray(TIE_ORDER, np.int32),
                tied=tied.reshape(-1))


def run(T, precision="highest", device=None, check=True,
        timing_reps=TIMING_REPS):
    """The tool's run: the check drain (each leaf once) against the exact
    reference, then (on the card) the timed drains. Prints the tool's
    lines and returns a dict: ``hit_agree``, ``id_agree``, ``rel_t_err``
    (with ``check``), ``outputs`` (t, tri, u, v of the check drain),
    ``inputs`` and, on the card, ``times`` {(reps, blocks): ms} with the
    timed ``orders`` {reps: order} and the ``wide_rays`` of one block per
    SM."""
    device = resolve_device(device)
    inp, rng = probe_inputs(T)
    L = inp["L"]
    mats = torch.from_numpy(inp["mats"]).to(device)
    centres = torch.from_numpy(inp["centres"]).to(device)
    rays = torch.from_numpy(inp["rays"]).to(device)
    order = torch.arange(L, dtype=torch.int32, device=device)
    t, tri_id, u, v = drain_probe(mats, centres, rays, order, T, precision)
    res = dict(T=T, precision=precision, device=str(device),
               inputs=(mats, centres, rays, order), outputs=(t, tri_id, u, v),
               times={})
    if check:
        tk = t[0].cpu().numpy()
        ik = tri_id[0].cpu().numpy()
        rt, ri = np_reference(inp["tri"].astype(np.float64),
                              inp["o"].astype(np.float64),
                              inp["d"].astype(np.float64), np.inf)
        hit_match = float(((ik >= 0) == (ri >= 0)).mean())
        both = (ik >= 0) & (ri >= 0)
        t_err = np.abs(tk[both] - rt[both]) / np.maximum(rt[both], 1e-6)
        id_match = float((ik[both] == ri[both]).mean()) if both.any() else 1.0
        rel = float(t_err.max()) if both.any() else 0.0
        print(f"T={T} prec={precision}: hit agree {hit_match:.4f}, "
              f"id agree {id_match:.4f}, rel t err max {rel:.2e}")
        res.update(hit_agree=hit_match, id_agree=id_match, rel_t_err=rel,
                   hits=int((ri >= 0).sum()))
    if device.type != "cuda" or not timing_reps:
        return res
    sms = common.sm_count(device)
    wide = torch.from_numpy(probe_inputs(T, sms)[0]["rays"]).to(device)
    clock_now, clock_max = common.sm_clocks_mhz()
    res.update(clock_mhz=clock_max, clock_now_mhz=clock_now, sms=sms,
               wide_rays=wide, orders={})
    for reps in timing_reps:
        order = torch.from_numpy(
            rng.integers(0, L, reps).astype(np.int32)).to(device)
        res["orders"][reps] = order
        for blocks, r in ((1, rays), (sms, wide)):
            ms = common.cuda_ms(lambda: drain_probe(mats, centres, r, order,
                                                    T, precision), runs=2)
            ns = ms * 1e6 / reps
            cyc = ns * clock_max / 1e3
            res["times"][(reps, blocks)] = ms
            print(f"  reps={reps} blocks={blocks}: {ms:.2f} ms -> {cyc:.0f} "
                  f"cyc/(row,leaf) = {cyc / T:.2f} cyc/tri-row ({ns:.0f} ns "
                  f"per (row, leaf) on one SM; cycles at clocks.max.sm "
                  f"{clock_max:.0f} MHz, clocks.sm {clock_now:.0f} MHz when "
                  "read)")
    return res


def measure(device=None, ts=TS, precisions=PRECISIONS):
    """The tool's main: :func:`run` for every leaf size and precision.
    Returns the list of results."""
    for p in precisions:
        if p not in PRECISIONS:
            raise ValueError(f"unknown precision {p!r}: {PRECISIONS}")
    return [run(T, p, device) for T in ts for p in precisions]


def main(argv=None):
    device, args = common.split_device(sys.argv[1:] if argv is None else argv)
    ts = [int(a) for a in args if a.isdigit()] or TS
    precs = [a for a in args if not a.isdigit()] or PRECISIONS
    measure(device, ts, precs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
