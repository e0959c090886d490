"""Small scenes and ray sets that stress the warp-synchronous walks.

Every traversal kernel (``csrc/traverse.cu``: the closest hits K1, the
masked K2 and the fat-leaf K7c; the any hits K3, the masked K4 and the
fat-leaf K7a) parks each lane at a leaf until every lane of its warp is
parked or finished, and the fat kernels split a leaf's columns across
lanes. These cases hold a kernel against its plain walker where that is
most likely to go wrong, and each must agree bit for bit (``t``, ``tri``,
``u``, ``v``, ``mixed``; any hit: ``hit``, or ``blocked`` and
``pending``), exact-``t`` ties included:

- ``duplicates``: every triangle three times over, so a hit ties exactly
  with its copies (the first triangle of the leaf, or the lowest column,
  wins in both; in the masked any hit, copies with different cell codes
  make rays that end blocked, pending, or blocked after a MIXED cell);
- ``long_lane``: a row of leaves that a few rays walk from end to end
  (and hit the wall behind them) while every other ray of their warp
  leaves the root box at once; the any-hit rays add lanes that block in
  their first leaf, so finished lanes sit among walking ones;
- each ray set cut to 1, 31, 33 and 257 rays: a ragged last warp and a
  lone parked lane; every any-hit case also has every third ray inactive
  and a t_min of its own.

The fat trees use T = 20 columns, not a multiple of most subgroup widths.
:func:`closest_mismatches` and :func:`any_mismatches` run every case on a
device; the tests and the chip smoke call them with the kernel wrappers on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

RAY_COUNTS = (1, 31, 33, 257)
FAT_LEAF = 20
LONG_EVERY = 37  # one long lane in each warp of the long-lane rays


def duplicate_soup(n: int = 96, copies: int = 3, n_rays: int = 257,
                   seed: int = 60):
    """``(tri, o, d)``: ``n`` random triangles, each repeated ``copies``
    times in a row, and rays aimed at points of them (nearly all hit)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-6.0, 6.0, (n, 3, 3)).astype(np.float32)
    tri = np.repeat(base, copies, axis=0)
    k = rng.integers(0, len(tri), n_rays)
    w = rng.dirichlet(np.ones(3), n_rays).astype(np.float32)
    target = np.einsum("nk,nkc->nc", w, tri[k])
    o = rng.uniform(-12.0, 12.0, (n_rays, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tri, o, d.astype(np.float32)


def long_lane_soup(n_steps: int = 160, n_rays: int = 257,
                   long_every: int = LONG_EVERY):
    """``(tri, o, d)``: pairs of triangles across the x axis, in the planes
    x = k and x = k + 0.5, whose boxes hold the line y = z = 0 but which
    lie off it (y + z >= 0.2 and y + z <= -0.2), so that a ray along the
    line enters every leaf box and hits none of them; then a wall at the
    far end. Rays ``0, long_every, 2*long_every, ...`` run along the line
    and hit the wall (or stop at their cap); every other ray starts beside
    them and points away from the scene, out of the root box in one
    step."""
    tri = []
    for k in range(n_steps):
        x = float(k)
        tri.append([[x, -0.8, 1.0], [x, 1.0, 1.0], [x, 1.0, -0.8]])
        tri.append([[x + 0.5, 0.8, -1.0], [x + 0.5, -1.0, -1.0],
                    [x + 0.5, -1.0, 0.8]])
    far = float(n_steps + 1)
    tri.append([[far, -4.0, -4.0], [far, 4.0, -4.0], [far, 0.0, 4.0]])
    tri = np.asarray(tri, np.float32)
    idx = np.arange(n_rays)
    lanes = idx % long_every == 0
    o = np.zeros((n_rays, 3), np.float32)
    o[:, 0] = -1.0
    o[:, 1] = np.where(lanes, 0.0, 0.01 * (idx % 7))
    o[:, 2] = np.where(lanes, 0.001 * (idx % 5), 0.0)
    d = np.zeros((n_rays, 3), np.float32)
    d[:, 0] = np.where(lanes, 1.0, -1.0)
    return tri, o, d


def long_lane_any_rays(n_steps: int = 160, n_rays: int = 257,
                       long_every: int = LONG_EVERY, block_every: int = 4):
    """``(o, d, t_max)``: rays through :func:`long_lane_soup`'s scene for
    the any-hit walks. Rays ``0, long_every, ...`` run along the line y =
    z = 0 through every leaf of the row: capped at 200 (every second one)
    they block at the wall behind it, capped at 100 they end unblocked in
    the middle. Rays ``1, 1 + block_every, ...`` (the rest of them) run
    parallel to it at y = z ~ 0.6, through the first triangle of every
    pair, so they block in their first leaf on an unmasked tree. Every
    other ray points away from the scene, out of the root box in one
    step. Caps of the short rays lie in [2, 40)."""
    idx = np.arange(n_rays)
    long_ = idx % long_every == 0
    block = ~long_ & (idx % block_every == 1)
    o = np.zeros((n_rays, 3), np.float32)
    o[:, 0] = -1.0
    o[:, 1] = np.where(long_, 0.0, np.where(block, 0.6 + 0.01 * (idx % 7),
                                             0.01 * (idx % 7)))
    o[:, 2] = np.where(long_, 0.001 * (idx % 5), np.where(block, 0.6, 0.0))
    d = np.zeros((n_rays, 3), np.float32)
    d[:, 0] = np.where(long_ | block, 1.0, -1.0)
    cap = np.random.default_rng(64).uniform(2.0, 40.0, n_rays)
    cap = np.where(long_, np.where(idx % (2 * long_every) == 0, 200.0, 100.0),
                   cap)
    return o, d, cap.astype(np.float32)


def _payload_tree(tri, device, seed, p=None):
    """The classic tree of ``tri`` with random cell codes (0, 1, 2) in its
    opacity payload, drawn with probabilities ``p`` (uniform by
    default)."""
    from glaze_tpu_torch.accel import bvh as B

    fields, _ = B.build_bvh_np(tri)
    rng = np.random.default_rng(seed)
    codes = rng.choice(3, (fields["tri"].shape[0], 64), p=p).astype(np.int8)
    return B.bvh_from_np(B.attach_tri_payload(fields, B.pack_alpha_masks(codes)),
                         device)


def cases(device):
    """Yields ``(label, kind, tree, o, d, t_max)`` for every scene, ray
    count and walk kind (``closest``, ``masked``, ``fat``), rays as (R, 3)
    tensors on ``device``; each kind is capped at every second ray
    count."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import fat

    for name, (tri, o, d) in (("duplicates", duplicate_soup()),
                              ("long_lane", long_lane_soup())):
        trees = {"closest": B.build_bvh(tri, device)[0],
                 "masked": _payload_tree(tri, device, seed=62),
                 "fat": fat.build_bvh_fat(tri, device, FAT_LEAF)[0]}
        cap = np.random.default_rng(63).uniform(2.0, 40.0, len(o))
        for m, n in enumerate(RAY_COUNTS):
            ot = torch.from_numpy(o[:n]).to(device)
            dt = torch.from_numpy(d[:n]).to(device)
            for j, (kind, tree) in enumerate(trees.items()):
                t_max = None
                if (m + j) % 2:
                    t_max = torch.from_numpy(cap[:n].astype(np.float32)).to(device)
                yield f"{name} {kind} {n} rays", kind, tree, ot, dt, t_max


ANY_T_MIN = {"duplicates": 0.5, "long_lane": 1e-3}
# cell codes of the masked any-hit trees: MIXED, OPAQUE, TRANSPARENT. Few
# OPAQUE cells, so that many rays cross MIXED cells and end pending
ANY_CODE_P = (0.3, 0.15, 0.55)


def any_cases(device):
    """Yields ``(label, kind, tree, o, d, t_max, t_min, active)`` for every
    scene, ray count and any-hit kind (``any``, ``any_masked``,
    ``any_fat``): rays as (R, 3) tensors on ``device``, ``t_max`` (R,),
    ``active`` (R,) bool with every third ray (2, 5, 8, ...) off, except
    the long lanes of ``long_lane``, which stay on."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import fat

    tri_d, o_d, d_d = duplicate_soup()
    cap_d = np.random.default_rng(63).uniform(2.0, 40.0, len(o_d))
    o_l, d_l, cap_l = long_lane_any_rays()
    for name, tri, o, d, cap in (
            ("duplicates", tri_d, o_d, d_d, cap_d.astype(np.float32)),
            ("long_lane", long_lane_soup()[0], o_l, d_l, cap_l)):
        trees = {"any": B.build_bvh(tri, device)[0],
                 "any_masked": _payload_tree(tri, device, seed=65,
                                             p=ANY_CODE_P),
                 "any_fat": fat.build_bvh_fat(tri, device, FAT_LEAF)[0]}
        idx = np.arange(len(o))
        active = ((idx % 3 != 2)
                  | ((idx % LONG_EVERY == 0) & (name == "long_lane")))
        for n in RAY_COUNTS:
            ot = torch.from_numpy(o[:n]).to(device)
            dt = torch.from_numpy(d[:n]).to(device)
            cap_t = torch.from_numpy(cap[:n]).to(device)
            act_t = torch.from_numpy(active[:n]).to(device)
            for kind, tree in trees.items():
                yield (f"{name} {kind} {n} rays", kind, tree, ot, dt, cap_t,
                       ANY_T_MIN[name], act_t)


def any_mismatches(device, kernels: dict, log=None) -> int:
    """Runs each case of :func:`any_cases` whose kind ``kernels`` names
    through ``kernels[kind]`` (a wrapper taking ``(tree, o3, d3, t_max,
    t_min=, active=)`` SoA tuples) and its plain walker; returns the number
    of rays whose flags differ (0 expected) and calls ``log(label, rays,
    blocked, pending, bad)`` per case."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import fat

    plain = {"any": B.any_hit, "any_masked": B.any_hit_masked,
             "any_fat": fat.any_hit_fat}
    total = 0
    for label, kind, tree, o, d, t_max, t_min, active in any_cases(device):
        if kind not in kernels:
            continue
        o3 = tuple(o[:, i].contiguous() for i in range(3))
        d3 = tuple(d[:, i].contiguous() for i in range(3))
        k = kernels[kind](tree, o3, d3, t_max, t_min=t_min, active=active)
        p = plain[kind](tree, o, d, t_max, t_min=t_min, active=active)
        if kind != "any_masked":
            k, p = (k, torch.zeros_like(k)), (p, torch.zeros_like(p))
        bad = (k[0] != p[0]) | (k[1] != p[1])
        n_bad = int(bad.sum())
        total += n_bad
        if log is not None:
            log(label, o.shape[0], int(p[0].sum()), int(p[1].sum()), n_bad)
    return total


def closest_mismatches(device, kernels: dict, log=None) -> int:
    """Runs each case of :func:`cases` whose kind ``kernels`` names
    through ``kernels[kind]`` (a wrapper taking ``(tree, o3, d3, t_max)``
    SoA tuples) and its plain walker; returns the number of rays whose
    outputs differ in any bit (0 expected) and calls ``log(label, rays,
    hits, bad)`` per case."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import fat

    plain = {"closest": B.closest_hit, "masked": B.closest_hit_masked,
             "fat": fat.closest_hit_fat}
    total = 0
    for label, kind, tree, o, d, t_max in cases(device):
        if kind not in kernels:
            continue
        o3 = tuple(o[:, i].contiguous() for i in range(3))
        d3 = tuple(d[:, i].contiguous() for i in range(3))
        k = kernels[kind](tree, o3, d3, t_max)
        p = plain[kind](tree, o, d, t_max)
        bad = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for key in p:
            a, b = k[key], p[key]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            bad |= a != b
        n_bad = int(bad.sum())
        total += n_bad
        if log is not None:
            log(label, o.shape[0], int((p["tri"] >= 0).sum()), n_bad)
    return total
