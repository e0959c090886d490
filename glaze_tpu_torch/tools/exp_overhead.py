"""Walk-loop overhead probe (T2): what one iteration of the traversal
while-loop costs.

Variants (all walk octant 0 of the classic tree over the same rays with
NO t-pruning, so the walk does not depend on hits found):
  A full   : leaf branch + the full 8-triangle Moller-Trumbore leaf body
  B when   : leaf branch + a trivial leaf body (+1 per leaf)
  C nowhen : no branch: load + slab + packet vote + descend
  D nosync : like C but the descent is data-independent (p % 3 != 2), so
             there is no vote in the loop at all
Time(A) - Time(B) = leaf body; B - C = branch; C - D = vote; D = loop floor.

A packet of rays descends where any of its rays hits the node box. Packet
2048 is the tool's (one block of 256 threads, eight rays each, a
block-wide vote); packet 32 is one warp, the card's natural packet. The
kernel counts each packet's iterations, so cycles per iteration come from
the measured walk lengths. The rays are the primary pixel-centre rays of the
Sponza-class scene (``scenes.SponzaScene``, 262,440 triangles) at
1920x1080, 2,088,960 lanes, through the port's camera, as the tool takes
them on mattest.

Kernel: ``walk_overhead_kernel`` in ``csrc/probes.cu``;
``walk_overhead_plain`` is its plain torch version.

Usage: python -m glaze_tpu_torch.tools.exp_overhead [A B C D] [--rays N]
       [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from glaze_tpu_torch.accel.bvh import T_MIN, _tri_intersect
from glaze_tpu_torch.device import resolve_device
from glaze_tpu_torch.tools import common, probes_cuda

VARIANTS = probes_cuda.VARIANTS
PACKETS = probes_cuda.PACKETS
RES = (1920, 1080)
LEAF_SIZE = 8
# elements of (packet, ray) or (packet, triangle, ray) work per plain step
_CHUNK = 1 << 19


def pallas_inv(d):
    """The Pallas kernels' reciprocal (traverse_pallas._safe_inv): every
    |d| < 1e-20 maps to +1e20."""
    tiny = d.abs() < 1e-20
    return torch.where(tiny, torch.full_like(d, 1e20),
                       1.0 / torch.where(tiny, torch.ones_like(d), d))


def octant0_nodes(bvh):
    """(M, 8) float32 node rows of octant 0 of ``nodes16`` (what the kernel
    walks) and their meta / skip as int64."""
    m16 = bvh.nodes16.shape[0] // 8
    nodes = bvh.nodes16[:m16].reshape(-1, 8)[:bvh.n_nodes].contiguous()
    bits = nodes.view(torch.int32)
    return nodes, bits[:, 6].long(), bits[:, 7].long()


def _slab(node, o, inv):
    """_slab with no t cap: node rows (P, 8) against rays (P, K, 3)."""
    bmin, bmax = node[:, None, 0:3], node[:, None, 3:6]
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tn = torch.maximum(torch.maximum(torch.minimum(t0[..., 0], t1[..., 0]),
                                     torch.minimum(t0[..., 1], t1[..., 1])),
                       torch.minimum(t0[..., 2], t1[..., 2]))
    tf = torch.minimum(torch.minimum(torch.maximum(t0[..., 0], t1[..., 0]),
                                     torch.maximum(t0[..., 1], t1[..., 1])),
                       torch.maximum(t0[..., 2], t1[..., 2]))
    return (tn <= tf) & (tf >= T_MIN) & (tn <= float("inf"))


def _leaf_bodies(bvh, acc, sel, first, o, d, hit):
    """Variant A's leaf body for the packets ``sel``: per ray that hits the
    leaf box, the t of every Moller-Trumbore hit among the 8 triangles of
    the leaf's tri8 row, added in order."""
    k = torch.arange(LEAF_SIZE, device=first.device)
    rows = bvh.tri[:, :9][first[:, None] + k[None, :]]          # (S, 8, 9)
    t, _, _, h = _tri_intersect(rows[:, :, None, :], o[:, None], d[:, None])
    h = h & hit[:, None, :]
    a = acc[sel]
    for j in range(LEAF_SIZE):
        a = a + torch.where(h[:, j], t[:, j], torch.zeros_like(a))
    acc[sel] = a


def walk_overhead_plain(bvh, o3, d3, variant, packet, stats=None):
    """Plain torch version of :func:`walk_overhead` (any device): all
    packets walk together, one node each per step. ``stats``, a dict,
    receives ``leaf_bodies`` (per packet, variants A and B),
    ``leaf_ray_hits`` (variants A and B: over the leaf bodies, the rays
    whose leaf-box test passed, the rays whose triangles A tests) and the
    distinct ``nodes_read`` and (variant A) ``tri_rows_read``."""
    nodes, meta, skip = octant0_nodes(bvh)
    n_nodes = bvh.n_nodes
    r = o3[0].shape[0]
    n_packets = r // packet
    o = torch.stack(o3, -1).reshape(n_packets, packet, 3)
    d = torch.stack(d3, -1).reshape(n_packets, packet, 3)
    inv = pallas_inv(d)
    dev = o.device
    acc = torch.zeros((n_packets, packet), dtype=torch.float32, device=dev)
    iters = torch.zeros((n_packets,), dtype=torch.int32, device=dev)
    bodies = torch.zeros((n_packets,), dtype=torch.int64, device=dev)
    ray_hits = 0
    nodes_read = torch.zeros((n_nodes,), dtype=torch.bool, device=dev)
    rows_read = torch.zeros((bvh.tri8.shape[0],), dtype=torch.bool, device=dev)
    live = torch.arange(n_packets, device=dev)
    ptr = torch.zeros((n_packets,), dtype=torch.int64, device=dev)
    while live.numel():
        iters[live] += 1
        nodes_read[ptr] = True
        is_leaf = meta[ptr] >= 0
        if variant == "D":
            nxt = torch.where((ptr % 3 != 2) & ~is_leaf, ptr + 1, skip[ptr])
        else:
            hit = torch.cat([_slab(nodes[ptr[s:s + step]], o[live[s:s + step]],
                                   inv[live[s:s + step]])
                             for s, step in _chunks(live.numel(), packet)])
            any_hit = hit.any(1)
            body = any_hit & is_leaf
            if variant in ("A", "B"):
                bodies[live[body]] += 1
                ray_hits += int(hit[body].sum())
            if variant == "B":
                acc[live[body]] += 1.0
            elif variant == "A":
                idx = torch.nonzero(body).flatten()
                rows_read[meta[ptr[idx]] >> 6] = True
                for s, step in _chunks(idx.numel(), packet * LEAF_SIZE):
                    part = idx[s:s + step]
                    sel = live[part]
                    _leaf_bodies(bvh, acc, sel, (meta[ptr[part]] >> 3) & ~7,
                                 o[sel], d[sel], hit[part])
            nxt = torch.where(any_hit & ~is_leaf, ptr + 1, skip[ptr])
        keep = nxt < n_nodes
        live, ptr = live[keep], nxt[keep]
    if stats is not None:
        stats.update(leaf_bodies=bodies, leaf_ray_hits=ray_hits,
                     nodes_read=int(nodes_read.sum()),
                     tri_rows_read=int(rows_read.sum()))
    return acc.reshape(-1), iters


def _chunks(n, per_item):
    """(start, count) slices of ``n`` items of ``per_item`` elements each,
    a bounded number of elements per slice."""
    step = max(1, _CHUNK // per_item)
    return [(s, min(step, n - s)) for s in range(0, n, step)]


def walk_overhead(bvh, o3, d3, variant, packet):
    """T2: packets of ``packet`` consecutive rays walk octant 0 of the
    classic tree ``bvh`` by ``variant`` (A-D). Returns ``(t, iters)``:
    (R,) float32 (the sum of leaf hits' t for A, leaves entered for B, 0
    for C and D) and the (R / packet,) int32 iterations of each packet. A
    CPU tensor takes the plain version; a CUDA tensor the kernel (or
    raises)."""
    if o3[0].device.type == "cpu":
        return walk_overhead_plain(bvh, o3, d3, variant, packet)
    return probes_cuda.walk_overhead(bvh.nodes16, bvh.tri8, bvh.n_nodes,
                                     o3, d3, variant, packet)


def d_walk_length(bvh) -> int:
    """Variant D's walk length, by the tool's host loop (:128-136)."""
    nodes = bvh.nodes.cpu().contiguous()
    meta = nodes[:, 6].clone().view(torch.int32).numpy()
    skp = nodes[:, 7].clone().view(torch.int32).numpy()
    n_nodes = nodes.shape[0]
    ptr = 0
    d_iters = 0
    while 0 <= ptr < n_nodes:
        d_iters += 1
        ptr = ptr + 1 if (ptr % 3 != 2 and meta[ptr] < 0) else int(skp[ptr])
    return d_iters


def scene_tree_and_rays(device, n_rays=None):
    """The classic tree of the Sponza-class scene and its primary
    pixel-centre rays at 1920x1080 in the launch's lane order (the first
    ``n_rays`` of them, if given): ``(bvh, o3, d3)``."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.accel.bvh import build_bvh
    from glaze_tpu_torch.render import integrator as integ

    scene = ps.SponzaScene()
    pos = scene.vertices_np()[0]
    tris = np.concatenate([pos[np.asarray(m.indices, np.int64).reshape(-1, 3)]
                           for m in scene.meshes()]).astype(np.float32)
    bvh, _ = build_bvh(tris, device)
    w, h = RES
    px, py = integ.pixel_coords(w, h, device)
    c2w, s2c = integ.camera_matrices(scene.cameras()[0], w, h)
    ndc_x = -1.0 + 2.0 * (px + 0.5) / w
    ndc_y = -1.0 + 2.0 * (py + 0.5) / h
    o3, d3 = integ.camera_rays(ndc_x, ndc_y, c2w, s2c, True)
    if n_rays is not None:
        o3 = tuple(c[:n_rays].contiguous() for c in o3)
        d3 = tuple(c[:n_rays].contiguous() for c in d3)
    return bvh, o3, d3


def run(bvh, o3, d3, variant, packet, device=None):
    """One variant and packet: outputs, iteration counts and, on the card,
    ms per call and SM cycles per packet iteration (ms x clocks.max.sm x
    SMs / the sum of all packets' iterations)."""
    device = resolve_device(device)
    t, iters = walk_overhead(bvh, o3, d3, variant, packet)
    total = int(iters.sum())
    res = dict(variant=variant, packet=packet, t=t, iters=iters,
               iterations=total, mean_iters=total / iters.numel())
    label = f"variant {variant} packet {packet:4d}"
    if device.type != "cuda":
        print(f"{label}: {res['mean_iters']:.1f} iterations per packet "
              "(time: not measured on the CPU)")
        return res
    ms = common.cuda_ms(lambda: walk_overhead(bvh, o3, d3, variant, packet))
    clock = common.max_sm_clock_mhz()
    cyc = ms * 1e-3 * clock * 1e6 * common.sm_count(device) / total
    res.update(ms=ms, cycles_per_iter=cyc, clock_mhz=clock)
    print(f"{label}: {ms:7.2f} ms/call  ~{cyc:6.0f} SM cycles/iter "
          f"(clocks.max.sm {clock:.0f} MHz, {res['mean_iters']:.1f} iters per "
          f"packet, {iters.numel()} packets)")
    return res


def measure(device=None, n_rays=None, variants=VARIANTS):
    """The tool's main on the Sponza-class scene: every variant at both
    packets. Returns ``(bvh, o3, d3, results)``."""
    device = resolve_device(device)
    bvh, o3, d3 = scene_tree_and_rays(device, n_rays)
    print(f"D walk iterations: {d_walk_length(bvh)}; {o3[0].shape[0]} rays, "
          f"{bvh.n_nodes} nodes")
    results = [run(bvh, o3, d3, v, packet, device)
               for packet in PACKETS for v in variants]
    return bvh, o3, d3, results


def main(argv=None):
    device, args = common.split_device(sys.argv[1:] if argv is None else argv)
    n_rays = int(args[args.index("--rays") + 1]) if "--rays" in args else None
    measure(device, n_rays, [a for a in args if a in VARIANTS] or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
