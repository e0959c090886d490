"""Chip smoke test of glaze_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout and holds each
against its plain PyTorch version on the rays of a real 1920x1080 launch:
the closest-hit and any-hit walks (K1, K3) on the Sponza-class scene
(262k triangles) with its curtain's opacity map removed, and the masked
walks (K2 on the full tree and on the alpha subset tree, K4) on the whole
scene, lace curtains included. It renders both scenes through the port's
CLI at 1920x1080, 2 spp, checks that exactly the expected kernels served
each render, and renders the golden scene against the stored golden. Any
failed phase raises, so the script exits non-zero and prints no result.
Without CUDA (or without the package beside it) it exits non-zero too.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it is the card's name and power limit as nvidia-smi
reports them, and before that a ``{"kernels": [...]}`` line with each
kernel's launches on the main path, agreement with its plain version,
times and bound.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

RES = (1920, 1080)
SPP = 2
SEED = 7
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
T_MIN = 1e-4  # no hit lies at t <= T_MIN (glaze_tpu_torch.accel.bvh)
# float operations per plain-walker step: slab test (6 sub, 6 mul, 6
# min/max, 4 min/max, 3 compares) and Moller-Trumbore (9 mul + 3 sub
# cross, 3 mul + 2 add det, 1 div, 3 sub, 3x(3 mul + 2 add + 1 mul) for
# u/v/t, 6 mul + 3 sub second cross, 6 compares); a cell lookup of an
# accepted hit in the masked walks (2 mul, 2 casts, 2 min, 1 mul-add for
# the cell, 1 shift and 1 compare for the word, 1 shift, 1 and, 1 compare)
OPS_PER_NODE = 25
OPS_PER_TRI = 56
OPS_PER_MASK = 12
# bytes of one distinct table row a walk needs: a node (bmin, bmax, meta,
# skip), a triangle's v0/e1/e2, one payload word of a cell lookup
BYTES_PER_NODE = 32
BYTES_PER_TRI = 36
BYTES_PER_MASK_WORD = 4
# traversal kernel launches of one 2-spp render (6 launches per sample):
# opaque scene: one closest hit and one any hit per launch. Full scene
# (alpha_rounds = 1, MIXED triangles present): per launch the closest
# trace runs K2 twice (_full_masked_closest: the walk and one re-test
# round) and the NEE occlusion runs K4 once plus K2 twice on the alpha tree
# (_alpha_walk_refined: the walk and one re-test round)
LAUNCHES = SPP * 6
EXPECTED_OPAQUE = {"closest_hit": LAUNCHES, "any_hit": LAUNCHES,
                   "closest_hit_masked": 0, "any_hit_masked": 0}
EXPECTED_FULL = {"closest_hit": 0, "any_hit": 0,
                 "closest_hit_masked": 4 * LAUNCHES,
                 "any_hit_masked": LAUNCHES}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_time(fn, runs: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``runs`` timed calls (CUDA
    events, after ``warmup`` untimed calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ulp_diff(a, b):
    """|a - b| in float32 units in the last place (finite, same-sign)."""
    ai = a.contiguous().view(torch.int32).to(torch.int64)
    bi = b.contiguous().view(torch.int32).to(torch.int64)
    return (ai - bi).abs()


# ---------------------------------------------------------------------------


def phase_build():
    from glaze_tpu_torch.accel import traverse_cuda as tc
    from glaze_tpu_torch import native

    t0 = time.perf_counter()
    tc.build()
    native.get_lib()
    log(f"[build] traverse.cu + native host library in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in tc.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")


def phase_scene(workdir):
    """Writes the Sponza-class scene whole and without its opacity map."""
    import glaze_tpu_torch.scenes as ps

    class SponzaNoOpacity:
        """The Sponza-class scene with its curtain opacity map removed:
        the opaque path (K1/K3)."""

        def __init__(self):
            self._base = ps.SponzaScene()

        def __getattr__(self, name):
            return getattr(self._base, name)

        def materials(self):
            mats = self._base.materials()
            for m in mats:
                m.opacity = 0
            return mats

    paths = {}
    for label, scene in (("full", ps.SponzaScene()),
                         ("opaque", SponzaNoOpacity())):
        t0 = time.perf_counter()
        path = os.path.join(workdir, f"sponza_{label}.glaze")
        ps.write_glaze(scene, path)
        n_tris = sum(len(m.indices) for m in scene.meshes()) // 3
        maps = [m.name for m in scene.materials() if m.opacity != 0]
        log(f"[scene] {label}: {n_tris} triangles, opacity-mapped materials "
            f"{maps}, written to {path} in {time.perf_counter() - t0:.1f} s")
        if n_tris < 250_000:
            raise RuntimeError(f"scene has only {n_tris} triangles")
        if (label == "full") != bool(maps):
            raise RuntimeError(f"{label} scene has opacity maps {maps}")
        paths[label] = path
    return paths


class Capture:
    """Records the rays the integrator traces (wrappers around the four
    dispatchers of glaze_tpu_torch.accel for one short render). Each
    record keeps the tree, the rays, and (closest hits) the number of
    any-hit calls made before it, which tells the launch it belongs to."""

    NAMES = ("closest_hit_soa_auto", "any_hit_soa_auto",
             "closest_hit_soa_masked_auto", "any_hit_soa_masked_auto")

    def __init__(self):
        import glaze_tpu_torch.accel as accel

        self.accel = accel
        self.calls = {name: [] for name in self.NAMES}
        self._orig = {name: getattr(accel, name) for name in self.NAMES}

    def _anyhits(self):
        return (len(self.calls["any_hit_soa_auto"])
                + len(self.calls["any_hit_soa_masked_auto"]))

    def __enter__(self):
        def wrap(name):
            orig = self._orig[name]

            def closest(bvh, o3, d3, t_max=None):
                self.calls[name].append(dict(
                    bvh=bvh, anyhits_before=self._anyhits(),
                    o3=tuple(x.clone() for x in o3),
                    d3=tuple(x.clone() for x in d3),
                    t_max=None if t_max is None else t_max.clone()))
                return orig(bvh, o3, d3, t_max)

            def anyhit(bvh, o3, d3, t_max, t_min=1e-3, active=None):
                self.calls[name].append(dict(
                    bvh=bvh, o3=tuple(x.clone() for x in o3),
                    d3=tuple(x.clone() for x in d3), t_max=t_max.clone(),
                    t_min=t_min, active=active.clone()))
                return orig(bvh, o3, d3, t_max, t_min=t_min, active=active)

            return closest if name.startswith("closest") else anyhit

        for name in self.NAMES:
            setattr(self.accel, name, wrap(name))
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            setattr(self.accel, name, self._orig[name])


def _table_bytes(stats):
    """The table bytes this run's rays need: each distinct node row,
    triangle and payload word that the walk in the kernel's own order read
    (bvh.WalkStats), once."""
    return (stats.distinct("nodes") * BYTES_PER_NODE
            + stats.distinct("tris") * BYTES_PER_TRI
            + stats.distinct("mask_words") * BYTES_PER_MASK_WORD)


def _bytes_closest(stats, r, cap, masked):
    """Closest hit: the tables, the cap of every lane (when capped), the 6
    ray floats of the live lanes only (a lane whose cap is <= T_MIN can
    hit nothing), t/tri/u/v (and the mixed byte) out. Returns the bytes
    and the live lanes."""
    live = r if cap is None else int((cap > T_MIN).sum())
    ray_in = live * 6 * 4 + (0 if cap is None else r * 4)
    return _table_bytes(stats) + ray_in + r * (16 + int(masked)), live


def _bytes_anyhit(stats, r, cap, active, t_min, masked):
    """Any hit: the tables, the active byte of every lane, the cap of the
    active lanes, the 6 ray floats of the live ones (active, cap above
    t_min and T_MIN), the hit byte (and the pending byte) out. Returns the
    bytes and the live lanes."""
    n_act = int(active.sum())
    live = int((active & (cap > max(t_min, T_MIN))).sum())
    ray_in = r + n_act * 4 + live * 6 * 4
    return _table_bytes(stats) + ray_in + r * (1 + int(masked)), live


def _bound(nbytes, stats):
    """Least time for the work: the larger of bytes over the HBM rate and
    the walk's float operations (node visits, triangle tests and cell
    lookups in the kernel's order) over the f32 peak."""
    ops = (stats.node_visits * OPS_PER_NODE + stats.tri_tests * OPS_PER_TRI
           + stats.mask_tests * OPS_PER_MASK)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _check_closest(entry, label, bvh, s, masked):
    """One closest-hit kernel (K1, or K2 when ``masked``) against its plain
    walker, walking the kernel's own octant order, on the captured rays
    ``s``: tri (and mixed) exact except where two triangles tie exactly on
    t (counted), t/u/v within 1 ulp. Adds the set's numbers to
    ``entry``."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import traverse_cuda as tc

    kern_fn = tc.closest_hit_soa_masked if masked else tc.closest_hit_soa
    plain_fn = B.closest_hit_masked if masked else B.closest_hit
    o3, d3, cap_ = s["o3"], s["d3"], s["t_max"]
    kern = kern_fn(bvh, o3, d3, cap_)
    stats = B.WalkStats()
    t0 = time.perf_counter()
    plain = plain_fn(bvh, torch.stack(o3, -1), torch.stack(d3, -1), cap_,
                     stats=stats)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    same = kern["tri"] == plain["tri"]
    tie = ~same & (kern["t"] == plain["t"])
    n_tie = int(tie.sum())
    hit = same & (plain["tri"] >= 0)
    ulps = max(int(ulp_diff(kern[k][hit], plain[k][hit]).max().item())
               if bool(hit.any()) else 0 for k in ("t", "u", "v"))
    err = max(float((kern[k][hit] - plain[k][hit]).abs().max().item())
              if bool(hit.any()) else 0.0 for k in ("t", "u", "v"))
    extra = ""
    bad = ~same & ~tie
    n_bad = int(bad.sum())
    if masked:
        bad = bad | (same & (kern["mixed"] != plain["mixed"]))
        n_bad = int(bad.sum())
        extra = f", {int(plain['mixed'].sum())} mixed"
    for i in torch.nonzero(bad).flatten()[:8].tolist():
        log(f"[kernels]   ray {i}: kernel " + ", ".join(
            f"{k} {kern[k][i].item()!r}" for k in kern) + "; plain " + ", ".join(
            f"{k} {plain[k][i].item()!r}" for k in plain))
    r = o3[0].shape[0]
    nbytes, live = _bytes_closest(stats, r, cap_, masked)
    if live == 0:
        raise RuntimeError(f"{entry['name']} {label}: no live lane to compare")
    log(f"[kernels] {entry['name']} {label}: {int((plain['tri'] >= 0).sum())} "
        f"hits of {r} rays ({live} live){extra}, {n_bad} mismatches, "
        f"{n_tie} exact-t ties (excluded), max {ulps} ulp, max abs err "
        f"{err:g}, plain walk {plain_wall:.1f} s")
    if n_bad or ulps > 1:
        raise RuntimeError(f"{entry['name']} kernel disagrees on {label} rays")
    k_ms = cuda_time(lambda: kern_fn(bvh, o3, d3, cap_), 5)
    p_ms = cuda_time(lambda: plain_fn(
        bvh, torch.stack(o3, -1), torch.stack(d3, -1), cap_), 1, warmup=0)
    b_ms, b_by = _bound(nbytes, stats)
    entry["sets"][label] = dict(
        rays=r, live=live, mismatches=n_bad, ties=n_tie, max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        **_work(stats))


def _check_anyhit(entry, label, bvh, s, masked):
    """One any-hit kernel (K3, or K4 when ``masked``) against its plain
    walker, walking the kernel's own octant order, on the captured rays
    ``s``: every flag exact."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import traverse_cuda as tc

    kern_fn = tc.any_hit_soa_masked if masked else tc.any_hit_soa
    plain_fn = B.any_hit_masked if masked else B.any_hit
    o3, d3, tm, act, t_min = s["o3"], s["d3"], s["t_max"], s["active"], s["t_min"]
    kern = kern_fn(bvh, o3, d3, tm, t_min=t_min, active=act)
    stats = B.WalkStats()
    t0 = time.perf_counter()
    plain = plain_fn(bvh, torch.stack(o3, -1), torch.stack(d3, -1), tm,
                     t_min=t_min, active=act, stats=stats)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    if masked:
        n_bad = int((kern[0] != plain[0]).sum() + (kern[1] != plain[1]).sum())
        what = f"{int(plain[0].sum())} blocked, {int(plain[1].sum())} pending"
    else:
        n_bad = int((kern != plain).sum())
        what = f"{int(plain.sum())} blocked"
    r = o3[0].shape[0]
    nbytes, live = _bytes_anyhit(stats, r, tm, act, t_min, masked)
    log(f"[kernels] {entry['name']} {label}: {int(act.sum())} active of "
        f"{r} rays ({live} live), {what}, {n_bad} mismatches, plain walk "
        f"{plain_wall:.1f} s")
    if n_bad:
        raise RuntimeError(f"{entry['name']} kernel disagrees on {label} rays")
    k_ms = cuda_time(lambda: kern_fn(bvh, o3, d3, tm, t_min=t_min,
                                     active=act), 5)
    p_ms = cuda_time(lambda: plain_fn(
        bvh, torch.stack(o3, -1), torch.stack(d3, -1), tm, t_min=t_min,
        active=act), 1, warmup=0)
    b_ms, b_by = _bound(nbytes, stats)
    entry["sets"][label] = dict(
        rays=r, active=int(act.sum()), live=live, mismatches=n_bad,
        max_abs_err=float(n_bad), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, bytes=nbytes, **_work(stats))


def _work(stats):
    """A set's work counters: visits and tests with repeats, distinct rows
    read."""
    return dict(node_visits=stats.node_visits, tri_tests=stats.tri_tests,
                mask_tests=stats.mask_tests,
                distinct_nodes=stats.distinct("nodes"),
                distinct_tris=stats.distinct("tris"),
                distinct_mask_words=stats.distinct("mask_words"))


def _kernel_entry(name, replaces):
    return dict(name=name, route="cuda",
                source="glaze_tpu_torch/csrc/traverse.cu", replaces=replaces,
                library_ms=None, sets={})


def _summarize(entry, headline):
    """Headline numbers of a kernel: the mean over the sets ``headline``
    (the per-set numbers stay under ``sets``); the worst error of all."""
    sets = [entry["sets"][k] for k in headline]
    entry.update(
        max_abs_err=max(v["max_abs_err"] for v in entry["sets"].values()),
        ms=statistics.mean(v["ms"] for v in sets),
        plain_ms=statistics.mean(v["plain_ms"] for v in sets),
        bound_ms=statistics.mean(v["bound_ms"] for v in sets),
        bound_by=sets[-1]["bound_by"])
    log(f"[kernels] {entry['name']}: kernel {entry['ms']:.3f} ms, plain "
        f"{entry['plain_ms']:.1f} ms, bound {entry['bound_ms']:.4f} ms "
        f"({entry['bound_by']}) per launch, mean of {list(headline)}")


def _capture_sample(path):
    """A 1920x1080 renderer of the scene at ``path`` and the rays of one
    sample (6 launches) of it."""
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    r = RayTraceRenderer(parse(path), width=RES[0], height=RES[1], seed=SEED,
                         device=torch.device("cuda"))
    with Capture() as cap:
        r.draw(1, return_image=False)
    torch.cuda.synchronize()
    return r, cap


def phase_kernels(path):
    """K1/K3 against their plain versions on the rays of the first two
    launches of a 1920x1080 render of the opaque scene."""
    r, cap = _capture_sample(path)
    bvh = r.scene.bvh
    closest = cap.calls["closest_hit_soa_auto"]
    anyhit = cap.calls["any_hit_soa_auto"]
    log(f"[kernels] captured {closest[0]['o3'][0].shape[0]} lanes per launch")
    k1 = _kernel_entry("closest_hit", "glaze_tpu/accel/traverse_pallas.py:579")
    for label, s in (("camera", closest[0]), ("bounce", closest[1])):
        _check_closest(k1, label, bvh, s, masked=False)
    _summarize(k1, ("camera", "bounce"))
    k3 = _kernel_entry("any_hit", "glaze_tpu/accel/traverse_pallas.py:817")
    for label, s in (("shadow_camera_hits", anyhit[0]),
                     ("shadow_bounce_hits", anyhit[1])):
        _check_anyhit(k3, label, bvh, s, masked=False)
    _summarize(k3, ("shadow_camera_hits", "shadow_bounce_hits"))
    del r, cap
    torch.cuda.empty_cache()
    return {"closest_hit": k1, "any_hit": k3}


def phase_masked_kernels(path):
    """K2/K4 against their plain versions on the rays of the first two
    launches of a 1920x1080 render of the full scene: K2 on the full tree
    (camera and bounce rays) and on the alpha subset tree (the pending
    shadow rays that _alpha_walk_refined resolves), K4 on the shadow
    rays."""
    r, cap = _capture_sample(path)
    scene = r.scene
    if not (scene.bvh.tri.shape[1] == 13 and scene.bvh_alpha is not None):
        raise RuntimeError("the full scene has no masked tree / alpha tree")
    if cap.calls["closest_hit_soa_auto"] or cap.calls["any_hit_soa_auto"]:
        raise RuntimeError("the full scene took the unmasked dispatchers")
    closest = cap.calls["closest_hit_soa_masked_auto"]
    anyhit = cap.calls["any_hit_soa_masked_auto"]
    full = [c for c in closest if c["bvh"] is scene.bvh and c["t_max"] is None]
    # the walk of each launch's alpha-tree resolution (its re-test round,
    # the second call of the launch, has every lane culled but those a
    # MIXED hit made transparent); launch n's follows n + 1 any-hit calls.
    # Only the pending lanes of K4 walk (the rest carry cap -1), so the
    # sets are the first two launches that have any
    alpha = {}
    for c in closest:
        if c["bvh"] is scene.bvh_alpha:
            alpha.setdefault(c["anyhits_before"] - 1, c)
    alpha_sets = [(f"alpha_tree_launch{n}", c) for n, c in sorted(alpha.items())
                  if bool((c["t_max"] > T_MIN).any())][:2]
    if len(alpha_sets) < 2:
        raise RuntimeError(f"only {len(alpha_sets)} launches of the sample "
                           "resolve pending shadow rays in the alpha tree")
    log(f"[kernels] full scene: {len(closest)} masked closest calls, "
        f"{len(anyhit)} masked any-hit calls in one sample; {scene.bvh.n_tris} "
        f"triangles, alpha tree {scene.bvh_alpha.n_tris}, opaque tree "
        f"{scene.bvh_opaque.n_tris}")
    k2 = _kernel_entry("closest_hit_masked",
                       "glaze_tpu/accel/traverse_pallas.py:1517")
    for label, tree, s in (("camera", scene.bvh, full[0]),
                           ("bounce", scene.bvh, full[1]),
                           *((lab, scene.bvh_alpha, c) for lab, c in alpha_sets)):
        _check_closest(k2, label, tree, s, masked=True)
    _summarize(k2, ("camera", "bounce"))
    k4 = _kernel_entry("any_hit_masked",
                       "glaze_tpu/accel/traverse_pallas.py:1733")
    for label, s in (("shadow_camera_hits", anyhit[0]),
                     ("shadow_bounce_hits", anyhit[1])):
        _check_anyhit(k4, label, scene.bvh, s, masked=True)
    _summarize(k4, ("shadow_camera_hits", "shadow_bounce_hits"))
    del r, cap
    torch.cuda.empty_cache()
    return {"closest_hit_masked": k2, "any_hit_masked": k4}


def phase_main_path(label, path, workdir, report, expected):
    """The port's CLI on a scene at 1920x1080, 2 spp, on the card; every
    kernel counter is set to 0 just before and read just after, and must
    equal ``expected``."""
    from PIL import Image

    from glaze_tpu_torch import cli
    from glaze_tpu_torch.accel import traverse_cuda as tc

    out = os.path.join(workdir, f"sponza_{label}.png")
    tc.reset_launch_counts()
    code, renderer, times = cli.run([
        path, out, "--res", f"{RES[0]}x{RES[1]}", "--spp", str(SPP),
        "--seed", str(SEED)])
    launches = {"closest_hit": tc.closest_hit_soa.launches,
                "any_hit": tc.any_hit_soa.launches,
                "closest_hit_masked": tc.closest_hit_soa_masked.launches,
                "any_hit_masked": tc.any_hit_soa_masked.launches}
    if code != 0:
        raise RuntimeError(f"CLI exited {code}")
    log(f"[main:{label}] kernel launches during the render: {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise RuntimeError(f"{label} render launched {launches}, expected "
                           f"{expected}")
    for name, n in launches.items():
        if expected[name]:
            report[name]["launches"] = n
    st = renderer._state
    accum = torch.stack(st.accum)
    if not bool(torch.isfinite(accum).all()):
        raise RuntimeError("non-finite radiance in the render")
    img = np.asarray(Image.open(out))
    if img.shape != (RES[1], RES[0], 3):
        raise RuntimeError(f"PNG has shape {img.shape}")
    if img.mean() < 5.0 or img.std() < 2.0:
        raise RuntimeError(f"PNG looks black or flat: mean {img.mean():.1f}")
    rays = RES[0] * RES[1] * times["launches"]
    ms_launch = times["render"] / times["launches"]
    log(f"[main:{label}] {out}: mean {img.mean():.1f}; setup "
        f"{times['setup']:.0f} ms, render {times['render']:.0f} ms = "
        f"{ms_launch:.1f} ms per launch, {rays / times['render'] / 1e3:.3f} "
        f"Mrays/s ({RES[0]}x{RES[1]} rays per launch)")
    numbers = {"ms_per_launch": ms_launch,
               "mrays_per_s": rays / times["render"] / 1e3,
               "setup_ms": times["setup"], "render_ms": times["render"],
               "image_mean": float(img.mean()), "launches": launches}
    numbers["profile"] = profile_sample(renderer, label)
    del renderer
    torch.cuda.empty_cache()
    return numbers


def profile_sample(renderer, label):
    """Where one sample's time goes (6 launches of the main path, after
    the render above). Wall time is taken unprofiled; device time by
    kernel comes from torch.profiler (CUPTI). Reports, not checks: if the
    profiler records no device time the numbers read "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.draw(1, return_image=False)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        renderer.draw(1, return_image=False)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        k = kernels.setdefault(e.key[:90], [0.0, 0])
        k[0] += us / 1e3
        k[1] += e.count
    busy_ms = sum(v[0] for v in kernels.values())
    if busy_ms <= 0.0:
        log(f"[profile:{label}] the profiler recorded no device time: not "
            "measured")
        return {"wall_ms_per_sample": wall_ms, "device_busy_ms": "not measured"}
    trav = sum(v[0] for k, v in kernels.items()
               if "closest_kernel" in k or "anyhit_kernel" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"[profile:{label}] one sample (6 launches): wall {wall_ms:.1f} ms unprofiled, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f}% of wall), "
        f"traversal kernels {trav:.2f} ms ({100 * trav / busy_ms:.1f}% of busy), "
        f"{sum(v[1] for v in kernels.values())} kernel launches")
    for name, (ms, n) in top:
        log(f"[profile:{label}]   {ms:8.2f} ms  {n:6d}x  {name}")
    return {"wall_ms_per_sample": wall_ms, "device_busy_ms": busy_ms,
            "traversal_ms": trav,
            "kernel_launches": sum(v[1] for v in kernels.values()),
            "top": [[name, ms, n] for name, (ms, n) in top]}


def phase_golden():
    """The golden scene at 96x48, coherent 1, 8 spp against the stored
    golden of the JAX package (exact count, MAD within the MC bound)."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    g = np.load(os.path.join(HERE, "tests", "goldens", "matrow_coh1.npz"))
    r = RayTraceRenderer(ps.MatRowScene(), width=ps.GOLDEN_W,
                         height=ps.GOLDEN_H, seed=ps.GOLDEN_SEED, coherent=1,
                         device="cuda")
    r.draw(ps.GOLDEN_SPP, return_image=False)
    accum = torch.stack(r._state.accum, -1).cpu().numpy()
    count = r._state.count.cpu().numpy()
    if not np.array_equal(count, g["count"]):
        raise RuntimeError("golden count differs")
    if not np.isfinite(accum).all():
        raise RuntimeError("golden render has non-finite radiance")
    ca = np.clip(accum / np.maximum(count, 1.0)[:, None], 0.0, 1.0)
    cg = np.clip(g["accum"] / np.maximum(g["count"], 1.0)[:, None], 0.0, 1.0)
    mad = float(np.abs(ca - cg).mean())
    dmean = abs(ca.mean() - cg.mean())
    log(f"[golden] count exact, per-pixel MAD {mad:.3g} (bound 0.06), "
        f"image mean {ca.mean():.5f} vs {cg.mean():.5f}")
    if mad >= 0.06 or dmean >= 0.03 * max(cg.mean(), 1e-6):
        raise RuntimeError("golden render outside the MC bound")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import glaze_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    workdir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    phase_build()
    paths = phase_scene(workdir)
    report = phase_kernels(paths["opaque"])
    report.update(phase_masked_kernels(paths["full"]))
    main_numbers = {
        "full": phase_main_path("full", paths["full"], workdir, report,
                                EXPECTED_FULL),
        "opaque": phase_main_path("opaque", paths["opaque"], workdir, report,
                                  EXPECTED_OPAQUE),
    }
    phase_golden()
    kernels = []
    for k in report.values():
        kernels.append({key: k[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "sets")})
    log(f"[done] {time.perf_counter() - t_start:.0f} s in all")
    print(json.dumps({"main_path": main_numbers, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
