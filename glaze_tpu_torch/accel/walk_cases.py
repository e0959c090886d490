"""Small scenes and ray sets that stress the warp-synchronous closest walks.

The closest-hit kernels (``csrc/traverse.cu``: K1, the masked K2 and the
fat-leaf K7c) park each lane at a leaf until every lane of its warp is
parked or finished, and K7c splits a leaf's columns across lanes. These
cases hold a kernel against its plain walker where that is most likely to
go wrong, and each must agree bit for bit (``t``, ``tri``, ``u``, ``v``,
``mixed``), exact-``t`` ties included:

- ``duplicates``: every triangle three times over, so a hit ties exactly
  with its copies (the first triangle of the leaf, or the lowest column,
  wins in both);
- ``long_lane``: a row of leaves that a few rays walk from end to end
  (and hit the wall behind them) while every other ray of their warp
  leaves the root box at once;
- each ray set cut to 1, 31, 33 and 257 rays: a ragged last warp and a
  lone parked lane.

The fat trees use T = 20 columns, not a multiple of most subgroup widths.
:func:`closest_mismatches` runs every case on a device; the tests and the
chip smoke call it with the kernel wrappers on the card.
"""

from __future__ import annotations

import numpy as np
import torch

RAY_COUNTS = (1, 31, 33, 257)
FAT_LEAF = 20


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


def long_lane_soup(n_steps: int = 160, n_rays: int = 257, long_every: int = 37):
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


def _payload_tree(tri, device, seed):
    """The classic tree of ``tri`` with random cell codes (0, 1, 2) in its
    opacity payload."""
    from glaze_tpu_torch.accel import bvh as B

    fields, _ = B.build_bvh_np(tri)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 3, (fields["tri"].shape[0], 64)).astype(np.int8)
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
