"""Chip smoke test of glaze_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout (one nvcc for
each library, started together) and measures the issue rate of each
instruction class that the bounds charge ([rates]). It drives the probe
tools of
glaze_tpu_torch.tools (the fat-leaf drain T1, the walk-overhead walk T2,
the product chains T3a/T3b and the slab-rate loop T4) through their entry
points at the tools' sizes, T2 on the 1080p camera rays of the
Sponza-class scene, and holds each probe kernel against its plain
version. Then it holds each traversal kernel against its plain PyTorch
version on the rays of a real 1920x1080 launch:
the closest-hit and any-hit walks (K1, K3) on the Sponza-class scene
(262k triangles) with its curtain's opacity map removed, the masked
walks (K2 on the full tree and on the alpha subset tree, K4) on the whole
scene, lace curtains included, and the fat-leaf walks (K7c, K7a) on the
opaque scene uploaded with GLAZE_TREE=fat, and the shade, NEE and BSDF
kernels (csrc/shade.cu) against their plain versions on the inputs of the
full scene's first two 1080p launches, with their times and bounds
([surface], [nee], [bsdf]). Every render below must launch the shade, NEE
and BSDF kernels once a launch each, beside the walks it expects. It renders
the scenes through the port's CLI at 1920x1080, 2 spp (full and opaque
on the classic tree, then opaque with GLAZE_TREE=fat and =hybrid, and
full with GLAZE_TREE=fat), checks that exactly the expected kernels
served each render, and renders the golden scene against the stored
golden. It
renders the full scene with two samples in flight, the ld sampler,
coherent off and adaptive stopping, holds K2 and K4 against their plain
walkers on that render's own rays (parked lanes included) and the golden
scene with those options on the card against the CPU ([sampling]), and
resumes a checkpointed render in a second process against a straight
one, resumes a CPU-written checkpoint on the card and writes a --profile
trace ([resume]), and renders the full scene with --denoise against the
same render without it, holding the display filter and its G-buffer on
the card against the CPU ([denoise]). It writes the Sponza-class scene as
Wavefront OBJ with PNG textures and renders the .obj through the CLI,
converter included, holding K2 and K4 against their plain walkers on its
rays ([convert]), and edits a renderer's materials on the classic and the
fat tree, removing the curtain's opacity map and putting it back, with a
render after each edit and the rebuilt tables against a fresh renderer's
([edit]). It runs the interactive app (python -m glaze_tpu_torch.app) on
the full scene at 1920x1080 with a script of still frames, camera drags,
the temporal denoiser, the flat preview and a material edit: ms per
frame of each kind, the launch counters of the frames drawn, each kind
profiled, K2 and K4 against their plain walkers on a tile-coherent drag
launch, pipelined frames against blocking ones, the preview and a
temporal drag frame on the card against the CPU ([interactive]); and the
browser viewer on port 0 at scale 0.5: frames, stats, a camera control,
the render thread joined ([viewer]). It renders a 1,049,760-triangle
grid of four Sponza-class atria through the CLI on a 2-chunk forest,
holds K2 and K4 against their plain walkers chunk by chunk on that
render's rays and on those of a view from outside the grid, where the
chunks' hits merge, and the forest against one tree of the same scene;
and the 262k scene with a 100,000-triangle chunk limit on the classic and
hybrid trees against the unchunked renders ([chunked]). It builds the 1M
scene's trees in two processes, cold and from the BVH disk cache
([cache]); renders with --mesh, and in the pixel, spp and 2d modes over
2 and 4 slots of the one card, against the unsharded renders bit for bit,
with checkpoints across the mesh ([mesh]); and runs pod_launch under
torch's launcher as two ranks on the card, straight and interrupted and
resumed, against the one-process CLI's checkpoint bit for bit
([distributed]). Any failed phase raises, so the
script exits non-zero and prints no result. Without CUDA (or without the
package beside it) it exits non-zero too.

Bounds: bytes over the HBM rate, tensor FLOPs over the tensor peaks, and
other operations by instruction class over the rates of their pipes and
over the issue rate, at the card's maximum SM clock (see SM_HZ); [rates]
measures those rates first (scripts/issue_rates.py) and fails if a class
runs above the rate its bounds charge.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it is the card's name and power limit as nvidia-smi
reports them, and before that a ``{"kernels": [...]}`` line with each
kernel's launches on the main path, agreement with its plain version,
times and bound.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
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
# H100 SXM HBM bytes/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12
# Non-tensor operations are charged by instruction class
# (glaze_tpu_torch.tools.common.RATES and ops_clocks): each pipe's classes
# over its rate, and all of them over the issue rate (one warp instruction
# per sub-partition a clock), the larger term binding, at the card's
# maximum SM clock (nvidia-smi clocks.max.sm, read in main()). The kernels
# are built with --fmad=false (glaze_tpu_torch/cuda_build.py) so that they
# match their plain versions bit for bit: no add and mul fuse into an FMA.
SM_HZ = None
T_MIN = 1e-4  # no hit lies at t <= T_MIN (glaze_tpu_torch.accel.bvh)
# the instructions of one walk step by class, as the sm_90a loops issue
# them (python scripts/sass_loops.py traverse closest_kernel): a node's
# slab test; a Moller-Trumbore triangle test (27 FMUL, 18 FADD, 6 compares,
# 3 selects of the best hit, and an IEEE division: MUFU.RCP, 2 FFMA, 1
# FADD.FTZ and its range compare); a cell lookup of an accepted hit in the
# masked walks (2 mul, 2 min, and 8 integer instructions: 2 casts, 1
# mul-add for the cell, 1 shift and 1 compare for the word, 1 shift, 1 and,
# 1 compare, charged at the issue rate); a fat-leaf column in K7c/K7a
# (csrc/traverse.cu fat_column: 25 FMUL, 16 FADD, 5 compares, and the
# division of t as above)
NODE_OPS = {"FADD": 6, "FMUL": 6, "FMNMX": 10, "FSETP": 3}
TRI_OPS = {"FMUL": 27, "FADD": 19, "FSETP": 7, "FSEL": 3, "MUFU": 1,
           "FFMA": 2}
MASK_OPS = {"FMUL": 2, "FMNMX": 2, "other": 8}
COLUMN_OPS = {"FMUL": 25, "FADD": 17, "FSETP": 6, "MUFU": 1, "FFMA": 2}
BYTES_PER_NODE = 32
BYTES_PER_TRI = 36
BYTES_PER_MASK_WORD = 4
BYTES_PER_COEF_ROW = 76
# traversal kernel launches of one 2-spp render (6 launches per sample):
# opaque scene: one closest hit and one any hit per launch. Full scene
# (alpha_rounds = 1, MIXED triangles present): per launch the closest
# trace runs K2 twice (_full_masked_closest: the walk and one re-test
# round) and the NEE occlusion runs K4 once plus K2 twice on the alpha tree
# (_alpha_walk_refined: the walk and one re-test round). GLAZE_TREE=fat:
# the opaque scene's closest hit and shadow ray take K7c and K7a; hybrid
# takes K7c and K3 on bvh_any (_any_hit_sorted). The full scene under
# GLAZE_TREE=fat never walks its fat tree: a fat tree carries no cell
# masks, so _full_tree_masked is False and both traces take the
# opaque/alpha split. Per launch: the closest trace (_split_closest) runs K1
# on the opaque tree and K2 twice on the alpha tree (_alpha_walk_refined),
# and the occlusion (_occlusion_sorted's candidate path) K3 on the opaque
# tree and K2 twice on the alpha tree.
# Every path launches the shade, NEE and BSDF kernels (render/shade_cuda.py)
# once a launch.
LAUNCHES = SPP * 6
KERNELS = ("closest_hit", "any_hit", "closest_hit_masked", "any_hit_masked",
           "closest_hit_fat", "any_hit_fat", "nee", "bsdf", "surface")
SHADE_KERNELS = ("nee", "bsdf", "surface")


def _expected(launches, **walks):
    """Launch counts by KERNELS name: ``launches`` shade, NEE and BSDF
    kernel launches (one each a launch) and the walks named in ``walks``,
    the others 0."""
    return {k: launches if k in SHADE_KERNELS else walks.get(k, 0)
            for k in KERNELS}


EXPECTED_OPAQUE = _expected(LAUNCHES, closest_hit=LAUNCHES, any_hit=LAUNCHES)
EXPECTED_FULL = _expected(LAUNCHES, closest_hit_masked=4 * LAUNCHES,
                          any_hit_masked=LAUNCHES)
EXPECTED_FAT = _expected(LAUNCHES, closest_hit_fat=LAUNCHES,
                         any_hit_fat=LAUNCHES)
EXPECTED_HYBRID = _expected(LAUNCHES, closest_hit_fat=LAUNCHES,
                            any_hit=LAUNCHES)
EXPECTED_FAT_FULL = _expected(LAUNCHES, closest_hit=LAUNCHES, any_hit=LAUNCHES,
                              closest_hit_masked=4 * LAUNCHES)

# The probe kernels' bounds: the dense tensor rates of TF32 and bf16 (NVIDIA
# H100 SXM data sheet; they count a multiply-add as two FLOPs, and so do
# the tensor FLOP counts below) and the non-tensor rates above. A kernel
# that runs on fewer blocks than SMs gets that share of each peak.
PEAK_TF32 = 495e12
PEAK_BF16_TC = 989e12
SMS = 132


def scaled(ops, n):
    """The class counts ``ops`` of one step times ``n`` steps."""
    return {cls: k * n for cls, k in ops.items()}


def summed(*counts):
    """Class counts added class by class."""
    out = {}
    for c in counts:
        for cls, k in c.items():
            out[cls] = out.get(cls, 0) + k
    return out


def ops_ms(counts, blocks=SMS):
    """Least milliseconds of the non-tensor instructions ``counts`` (class
    -> thread instructions of the whole launch) on ``blocks`` blocks (one
    SM each, at most all SMs): (ms, the term that binds)."""
    from glaze_tpu_torch.tools.common import ops_clocks

    clocks, term = ops_clocks(counts)
    return clocks / (min(blocks, SMS) * SM_HZ) * 1e3, term


# f32 operations of a drain: per (triangle, ray) resolve (|det| and its
# compare, 1/det, t, ud*det, vd*det, ud+vd and its product, det*det, 5
# compares); per ray and leaf the features (3 sub for o', 6 mul + 3 sub
# for o' x d). They are not split by class (the tensor term binds the
# drains and chains by far): charged at the issue rate.
OPS_RESOLVE = 14
OPS_FEATURES = 12
SHORT_CHAIN = 16     # T3a/T3b kernel-against-plain chains
T_RTOL = 1e-4        # drain t, relative (summation order of exact products)
UV_ATOL = 5e-3       # drain u/v: ud, vd agree to a few ulps of terms ~20,
#                      divided by a grazing det of ~0.01
CHAIN_RTOL = 1e-5    # chain sums, relative to their largest magnitude
PROBES = (("fat_drain", "tools/bench_mxu.py:95"),
          ("walk_overhead", "tools/exp_overhead.py:50"),
          ("dot_chain", "tools/bench_dot.py:29"),
          ("resolve_chain", "tools/bench_dot.py:112"),
          ("slab_rate", "tools/bench_bf16_slab.py:38"))


def log(msg):
    print(msg, flush=True)


def _set_tree(mode):
    if mode is None:
        os.environ.pop("GLAZE_TREE", None)
    else:
        os.environ["GLAZE_TREE"] = mode


@contextlib.contextmanager
def tree_env(mode):
    """GLAZE_TREE set to ``mode`` (None: unset) inside the block, restored
    after: the tree is chosen when a scene is uploaded."""
    saved = os.environ.get("GLAZE_TREE")
    _set_tree(mode)
    try:
        yield
    finally:
        _set_tree(saved)


def ulp_diff(a, b):
    """|a - b| in float32 units in the last place (finite, same-sign)."""
    ai = a.contiguous().view(torch.int32).to(torch.int64)
    bi = b.contiguous().view(torch.int32).to(torch.int64)
    return (ai - bi).abs()


# ---------------------------------------------------------------------------


def _script(name):
    """scripts/<name>.py, a measurement script beside the package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_build():
    """Builds traverse.cu, probes.cu, scripts/issue_rates.cu and the native
    host library at once (one compiler process each) and prints each
    ptxas report."""
    from concurrent.futures import ThreadPoolExecutor

    from glaze_tpu_torch import native
    from glaze_tpu_torch.accel import traverse_cuda as tc
    from glaze_tpu_torch.render import shade_cuda as shade
    from glaze_tpu_torch.tools import probes_cuda as pc

    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        jobs = [pool.submit(f) for f in (tc.build, pc.build, shade.build,
                                         native.get_lib,
                                         _script("issue_rates").build)]
        for job in jobs:
            job.result()
    log(f"[build] traverse.cu + probes.cu + shade.cu + issue_rates.cu + "
        f"native host library in {time.perf_counter() - t0:.2f} s")
    for lib, text in (("traverse", tc.build_log), ("probes", pc.build_log),
                      ("shade", shade.build_log)):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"[build] {lib} ptxas: {line.strip()}")
    attrs = tc.kernel_attrs()
    for name in SHADE_KERNELS:
        attrs[name] = shade.kernel_attrs(name)
    at = {"drain": ", at T = 128", "chain": ", at W = 512"}
    for name, a in (*attrs.items(), *pc.kernel_attrs().items()):
        where = (", at W = 2048" if name.endswith("w2048")
                 else at.get(name.split("_")[0], ""))
        log(f"[build] {name}: {a['registers']} registers, {a['local_bytes']} "
            f"local bytes per thread, {a['blocks_per_sm']} blocks of "
            f"{a['threads_per_block']} per SM (occupancy {a['occupancy']:.2f}"
            f"{where})")
    return attrs


def phase_rates():
    """The issue rate of each instruction class on this card
    (scripts/issue_rates.py: one loop a class and mixed loops, each
    loop's SASS checked) against the rates and pipes the bounds charge
    (glaze_tpu_torch.tools.common.RATES): raises if a class runs more than
    5% above its charged rate, a mixed loop faster than the charged pipes
    allow, or a loop is not the opcode it names. Returns the rates."""
    ir = _script("issue_rates")
    t0 = time.perf_counter()
    results, failures = ir.run_all(
        report=lambda r: log(f"[rates] {ir.describe(r)}"))
    log(f"[rates] {len(results)} loops in {time.perf_counter() - t0:.1f} s")
    if failures:
        raise RuntimeError(f"issue rates: {failures}")
    return {name: {k: r[k] for k in ("classes", "sampled_mhz", "max_mhz",
                                      "per_sm_clock", "one_pipe", "two_pipes",
                                      "overlap", "charged") if k in r}
            for name, r in results.items()}


def _probe_bound(nbytes, tc_flops=0.0, tc_peak=PEAK_TF32, ops=None,
                 blocks=SMS):
    """Least time of a probe's work on ``blocks`` blocks (one SM each, at
    most all SMs): the largest of bytes over the HBM rate, tensor-core
    FLOPs over ``tc_peak`` and the non-tensor instructions ``ops`` (class
    -> count, :func:`ops_ms`), each peak cut to the SMs the blocks occupy.
    Returns (ms, bound_by)."""
    share = min(blocks, SMS) / SMS
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(tc_flops / (tc_peak * share) * 1e3,
                ops_ms(ops or {}, blocks)[0])
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _drain_diff(kern, plain, label):
    """T1/T3b outputs ((8, R) t, tri, u, v) of kernel and plain: tri exact
    except where both hit and t agrees within T_RTOL (a near tie of two
    columns, counted); t within T_RTOL, u/v within UV_ATOL. Returns the
    numbers; raises on a disagreement."""
    (tk, ik, uk, vk), (tp, ip, up, vp) = kern, plain
    same = ik == ip
    both = (ik >= 0) & (ip >= 0)
    near = both & ((tk - tp).abs() <= T_RTOL * tp.abs())
    ties = int((~same & near).sum())
    bad = int((~same & ~near).sum())
    hit = same & (ip >= 0)
    rel = float(((tk - tp).abs() / tp.abs())[hit].max()) if bool(hit.any()) else 0.0
    duv = max(float((uk - up)[hit].abs().max()), float((vk - vp)[hit].abs().max())) \
        if bool(hit.any()) else 0.0
    err = max(float((tk - tp)[hit].abs().max()), duv) if bool(hit.any()) else 0.0
    miss_same = bool(torch.equal(tk[~(ip >= 0)], tp[~(ip >= 0)]))
    log(f"[probes] {label}: {int((ip[0] >= 0).sum())} hits of {ip.shape[1]} "
        f"rays, {bad} mismatches, {ties} near ties (t within {T_RTOL:g}), "
        f"rel t err {rel:.2e}, u/v err {duv:.2e}")
    if bad or rel > T_RTOL or duv > UV_ATOL or not miss_same:
        raise RuntimeError(f"{label}: kernel disagrees with the plain drain")
    return dict(mismatches=bad, ties=ties, rel_t_err=rel, uv_err=duv,
                max_abs_err=err)


def _tie_check(T, prec, device):
    """T1 on bench_mxu.tie_inputs (triangles repeated in rows g and g + 8 of
    one m16 tile, in two tiles, and a leaf repeated between steps): tri
    must equal the plain drain's exactly on every ray, the lower column and
    the earlier step winning each exact tie."""
    from glaze_tpu_torch.tools import bench_mxu as bm

    inp = bm.tie_inputs(T)
    args = [torch.from_numpy(inp[k]).to(device)
            for k in ("mats", "centres", "rays", "order")] + [T, prec]
    kern = bm.drain_probe(*args)
    plain = bm.drain_probe_plain(*args)
    s = _drain_diff(kern, plain, f"T1 T={T} {prec} exact ties")
    tri_p = plain[1][0].cpu().numpy()
    on_tied = (tri_p >= 0) & inp["tied"][np.maximum(tri_p, 0)]
    differ = int((kern[1] != plain[1]).sum())
    log(f"[probes] T1 T={T} {prec} exact ties: {int(on_tied.sum())} rays "
        f"end on a repeated triangle, {differ} tri differ")
    if differ or on_tied.sum() < 1024:
        raise RuntimeError(f"T1 T={T} {prec}: exact ties resolved unlike "
                           "the plain drain")
    return dict(on_tied=int(on_tied.sum()), tri_differ=differ,
                rel_t_err=s["rel_t_err"], uv_err=s["uv_err"],
                max_abs_err=s["max_abs_err"])


def probes_t1(entry, results):
    """T1: each (T, precision) run's check drain against the plain drain,
    the tool's agreement with f64, times and bounds per (reps, blocks)."""
    from glaze_tpu_torch.tools import bench_mxu as bm
    from glaze_tpu_torch.tools.common import timed_call

    for res in results:
        T, prec = res["T"], res["precision"]
        mats, centres, rays, order = res["inputs"]
        plain, p_ms = timed_call(lambda: bm.drain_probe_plain(
            mats, centres, rays, order, T, prec))
        s = _drain_diff(res["outputs"], plain, f"T1 T={T} {prec}")
        aimed = torch.from_numpy(bm.aimed_rays(T)).to(mats.device)
        kern = bm.drain_probe(mats, centres, aimed, order, T, prec)
        hits = _drain_diff(kern, bm.drain_probe_plain(
            mats, centres, aimed, order, T, prec), f"T1 T={T} {prec} aimed")
        ties = _tie_check(T, prec, mats.device)
        s.update(hit_agree_f64=res["hit_agree"], id_agree_f64=res["id_agree"],
                 rel_t_err_f64=res["rel_t_err"], check_plain_ms=p_ms,
                 aimed={k: hits[k] for k in ("mismatches", "ties",
                                             "rel_t_err", "uv_err")},
                 exact_ties=ties, clock_mhz=res["clock_mhz"], timings={})
        s["max_abs_err"] = max(s["max_abs_err"], hits["max_abs_err"],
                               ties["max_abs_err"])
        L, w = mats.shape[0] // 16, mats.shape[1]
        passes = 3 if prec == "highest" else 1
        peak = PEAK_TF32 if prec == "highest" else PEAK_BF16_TC
        for (reps, blocks), ms in res["times"].items():
            r = 128 * blocks
            nbytes = L * 16 * w * 4 + L * 12 + reps * 4 + r * 6 * 4 + r * 16
            b_ms, b_by = _probe_bound(
                nbytes, passes * 2 * 4 * T * 128 * 16 * reps * blocks, peak,
                {"other": reps * blocks * 128
                 * (OPS_FEATURES + OPS_RESOLVE * T)}, blocks=blocks)
            ns = ms * 1e6 / reps
            s["timings"][f"reps{reps}_blocks{blocks}"] = dict(
                ms=ms, bound_ms=b_ms, bound_by=b_by, ns_per_row_leaf=ns,
                cycles_per_row_leaf=ns * res["clock_mhz"] / 1e3)
        entry["sets"][f"T{T}_{prec}"] = s
        if T == 128 and prec == "highest":
            head = s["timings"]["reps8192_blocks1"]
            _, plain_ms = timed_call(lambda: bm.drain_probe_plain(
                mats, centres, rays, res["orders"][8192], T, prec))
            entry.update(ms=head["ms"], bound_ms=head["bound_ms"],
                         bound_by=head["bound_by"], plain_ms=plain_ms,
                         headline="T=128 highest, reps 8192, one block")
    entry["max_abs_err"] = max(s["max_abs_err"] for s in entry["sets"].values())


def _matmul_chain(mat, feat, prec, reps):
    """The T3a chain with torch.matmul for each product (fp32 with TF32
    off for highest, bf16 for default, three bf16 products for split3):
    the library yardstick, launch-bound (four or more launches a step)."""
    mt = mat.t().contiguous()
    mh = mt.to(torch.bfloat16)
    ml = (mt - mh.float()).to(torch.bfloat16)
    acc = torch.zeros((8, 128), dtype=torch.float32, device=mat.device)
    for _ in range(reps):
        f = torch.where(feat > acc[0, 0], feat, -feat)
        if prec == "highest":
            out = torch.matmul(mt, f)
        else:
            fh = f.to(torch.bfloat16)
            out = torch.matmul(mh, fh).float()
            if prec == "split3":
                fl = (f - fh.float()).to(torch.bfloat16)
                out = out + torch.matmul(mh, fl).float() + torch.matmul(ml, fh).float()
        acc = acc + out.reshape(-1, 8, 128).sum(0)
    return acc


def probes_t3a(entry, results):
    """T3a: each case's kernel against the plain chain on a short chain
    (to the first feedback flip), the torch.matmul chain's time, bounds."""
    from glaze_tpu_torch.tools import bench_dot as bd
    from glaze_tpu_torch.tools.common import cuda_ms, timed_call

    torch.backends.cuda.matmul.allow_tf32 = False
    for res in results:
        mat, feat = res["inputs"]
        prec, T, batch, reps = res["precision"], res["T"], res["batch"], res["reps"]
        label = f"T3a T={T} batch={batch} {prec}"
        k, tk = bd.dot_chain_probe(mat, feat, prec, SHORT_CHAIN, trace=True)
        p, tp = bd.dot_chain_plain(mat, feat, prec, SHORT_CHAIN, trace=True)
        first, flips = bd.first_flip(feat, tk, tp)
        steps = SHORT_CHAIN if first is None else first
        if first is not None:
            k, _ = bd.dot_chain_probe(mat, feat, prec, steps)
            p, _ = bd.dot_chain_plain(mat, feat, prec, steps)
        err = float((k - p).abs().max())
        scale = float(p.abs().max())
        log(f"[probes] {label}: {flips} feedback flips in {SHORT_CHAIN} steps, "
            f"compared over {steps}: max abs err {err:.3e} of {scale:.3e}")
        if steps == 0 or err > CHAIN_RTOL * scale:
            raise RuntimeError(f"{label}: kernel disagrees with the plain chain")
        _matmul_chain(mat, feat, prec, SHORT_CHAIN)  # warm-up
        lib_ms = cuda_ms(lambda: _matmul_chain(mat, feat, prec, reps), 1,
                         warmup=0)
        w = mat.shape[1]
        passes = 1 if prec == "default" else 3
        peak = PEAK_TF32 if prec == "highest" else PEAK_BF16_TC
        b_ms, b_by = _probe_bound(
            16 * w * 4 + 16 * 128 * 4 + 8 * 128 * 4,
            passes * 2 * w * 128 * 16 * reps, peak,
            {"other": reps * (w * 128 + 16 * 128 + 8 * 128)}, blocks=1)
        entry["sets"][f"T{T}_b{batch}_{prec}"] = dict(
            ms=res["ms"], cycles_per_dot=res["cycles_per_dot"],
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, flips=flips,
            compared_steps=steps, max_abs_err=err)
        if (T, batch, prec) == (128, 1, "highest"):
            _, plain_ms = timed_call(lambda: bd.dot_chain_plain(mat, feat, prec, reps))
            entry.update(ms=res["ms"], bound_ms=b_ms, bound_by=b_by,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         headline="T=128 batch=1 highest, reps 4096")
    entry["max_abs_err"] = max(s["max_abs_err"] for s in entry["sets"].values())


def probes_t3b(entry, results):
    """T3b: the kernel against the plain chain on a short chain at every
    leaf size (the tool times T = 128 and 64), bounds."""
    from glaze_tpu_torch.tools import bench_dot as bd
    from glaze_tpu_torch.tools.common import timed_call
    from glaze_tpu_torch.tools.probes_cuda import TS

    timed = {res["T"] for res in results}
    for T in TS:
        if T not in timed:
            mat, feat = bd.chain_inputs(4 * T, "cuda")
            entry["sets"][f"T{T}"] = _drain_diff(
                bd.resolve_chain_probe(mat, feat, T, SHORT_CHAIN),
                bd.as_rows(bd.resolve_chain_plain(mat, feat, T, SHORT_CHAIN),
                           bd.T_INIT), f"T3b T={T} ({SHORT_CHAIN} steps)")
    for res in results:
        T, reps = res["T"], res["reps"]
        mat, feat = res["inputs"]
        k = bd.resolve_chain_probe(mat, feat, T, SHORT_CHAIN)
        p = bd.as_rows(bd.resolve_chain_plain(mat, feat, T, SHORT_CHAIN),
                       bd.T_INIT)
        s = _drain_diff(k, p, f"T3b T={T} ({SHORT_CHAIN} steps)")
        b_ms, b_by = _probe_bound(
            16 * 4 * T * 4 + 16 * 128 * 4 + 128 * 16,
            3 * 2 * 4 * T * 128 * 16 * reps, PEAK_TF32,
            {"other": reps * 128 * (OPS_RESOLVE * T + 16)}, blocks=1)
        s.update(ms=res["ms"], cycles=res["cycles"], bound_ms=b_ms,
                 bound_by=b_by)
        entry["sets"][f"T{T}"] = s
        if T == 128:
            _, plain_ms = timed_call(lambda: bd.resolve_chain_plain(mat, feat, T, reps))
            entry.update(ms=res["ms"], bound_ms=b_ms, bound_by=b_by,
                         plain_ms=plain_ms, headline="T=128, reps 4096")
    entry["max_abs_err"] = max(s["max_abs_err"] for s in entry["sets"].values())


def probes_t2(entry, bvh, o3, d3, results):
    """T2: each (variant, packet) run on the 1080p camera rays against the
    plain walk of the same rays (iterations and outputs exact; A within 1
    ulp per added term), bounds from the plain walk's counts."""
    from glaze_tpu_torch.tools import exp_overhead as eo
    from glaze_tpu_torch.tools.common import timed_call

    r = o3[0].shape[0]
    for res in results:
        v, packet = res["variant"], res["packet"]
        stats = {}
        (tp, ip), p_ms = timed_call(lambda: eo.walk_overhead_plain(
            bvh, o3, d3, v, packet, stats))
        tk, ik = res["t"], res["iters"]
        ulps = int(ulp_diff(tk, tp).max())
        same_iters = bool(torch.equal(ik, ip))
        log(f"[probes] T2 {v} packet {packet}: {ip.numel()} packets, "
            f"{float(ip.float().mean()):.1f} iterations each (max "
            f"{int(ip.max())}), iterations {'equal' if same_iters else 'DIFFER'}, "
            f"outputs max {ulps} ulp apart, plain walk {p_ms / 1e3:.1f} s")
        if not same_iters or ulps > (8 if v == "A" else 0):
            raise RuntimeError(f"T2 {v}/{packet}: kernel disagrees with the plain walk")
        n_packets = r // packet
        slab_tests = int(ip.sum()) * packet
        # A's function tests the 8 triangles of a leaf for the rays that hit
        # its box only; bound_ms_every_ray charges every ray of the packet
        tri_tests = stats["leaf_ray_hits"] * 8 if v == "A" else 0
        every_ray = int(stats["leaf_bodies"].sum()) * 8 * packet if v == "A" else 0
        nbytes = (r * (6 * 4 + 4) + n_packets * 4
                  + stats["nodes_read"] * BYTES_PER_NODE
                  + stats["tri_rows_read"] * 8 * BYTES_PER_TRI)
        b_ms, b_by = _probe_bound(nbytes, ops=summed(
            scaled(NODE_OPS, slab_tests), scaled(TRI_OPS, tri_tests)))
        old_ms, _ = _probe_bound(nbytes, ops=summed(
            scaled(NODE_OPS, slab_tests), scaled(TRI_OPS, every_ray)))
        entry["sets"][f"{v}_packet{packet}"] = dict(
            rays=r, ms=res["ms"], plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            bound_ms_every_ray=old_ms,
            mean_iters=res["mean_iters"], max_iters=int(ip.max()),
            sm_cycles_per_iter=res["cycles_per_iter"],
            leaf_bodies=int(stats["leaf_bodies"].sum()),
            leaf_ray_hits=stats["leaf_ray_hits"], tri_tests=tri_tests,
            nodes_read=stats["nodes_read"], max_ulp=ulps,
            max_abs_err=float((tk - tp).abs().max()))
        if v == "A":
            log(f"[probes] T2 A packet {packet}: {stats['leaf_ray_hits']} rays "
                f"hit an entered leaf's box of "
                f"{int(stats['leaf_bodies'].sum()) * packet} rays of the "
                f"entering packets; bound {b_ms:.4f} ms ({old_ms:.4f} ms "
                "charging every ray)")
        if (v, packet) == ("A", 2048):
            entry.update(ms=res["ms"], plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, headline="A, packet 2048, 1080p rays")
    entry["max_abs_err"] = max(s["max_abs_err"] for s in entry["sets"].values())


def probes_t4(entry, results):
    """T4: each dtype and size against the plain loop (every element
    exact), bounds (the instructions of a test by class: an element in
    f32, a pair of elements in bf16)."""
    from glaze_tpu_torch.tools import bench_bf16_slab as bs
    from glaze_tpu_torch.tools.common import timed_call

    for res in results:
        o, i, nodes = res["inputs"]
        name = "bf16" if res["dtype"] == torch.bfloat16 else "f32"
        plain, p_ms = timed_call(lambda: bs.slab_rate_plain(o, i, nodes, res["iters"]))
        differ = int((res["out"] != plain).sum())
        log(f"[probes] T4 {name} {res['rows']} rows: {differ} of "
            f"{plain.numel()} elements differ from the plain loop")
        if differ:
            raise RuntimeError(f"T4 {name}: kernel disagrees with the plain loop")
        per_thread = 2 if name == "bf16" else 1
        threads = o.numel() // per_thread
        ops = scaled(bs.TEST_OPS_BF16 if name == "bf16" else bs.TEST_OPS_F32,
                     threads * res["iters"])
        blocks = -(-threads // 256)
        b_ms, b_by = _probe_bound(o.numel() * o.element_size() * 3
                                  + nodes.numel() * 4, ops=ops, blocks=blocks)
        term = ops_ms(ops, blocks)[1]
        entry["sets"][f"{name}_{res['rows']}rows"] = dict(
            ms=res["ms"], gtest_per_s=res["rate"], plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, bound_term=term, max_abs_err=0.0)
        log(f"[probes] T4 {name} {res['rows']} rows: {res['ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {term}), {res['ms'] / b_ms:.2f}x")
        if (name, res["rows"]) == ("bf16", bs.FILL_ROWS):
            entry.update(ms=res["ms"], plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, headline=f"bf16, {bs.FILL_ROWS} rows")
    entry["max_abs_err"] = 0.0


def phase_probes():
    """The probes path: the tools' entry points on the card with every
    probe counter set to 0 just before and read just after; then each
    probe kernel against its plain version (launches not counted)."""
    from glaze_tpu_torch.tools import (bench_bf16_slab, bench_dot, bench_mxu,
                                       exp_overhead)
    from glaze_tpu_torch.tools import probes_cuda as pc

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    pc.reset_launch_counts()
    t1 = bench_mxu.measure(dev)
    t3a = bench_dot.measure(dev)
    t3b = bench_dot.measure(dev, resolve=True)
    bvh, o3, d3, t2 = exp_overhead.measure(dev)
    t4 = bench_bf16_slab.measure(dev)
    counts = {fn.__name__: fn.launches for fn in pc.KERNEL_WRAPPERS}
    log(f"[probes] kernel launches of the probes path: {counts} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not all(counts.values()):
        raise RuntimeError(f"a probe kernel was never launched: {counts}")
    entries = {name: _kernel_entry(name, replaces) for name, replaces in PROBES}
    for name, e in entries.items():
        e.update(source="glaze_tpu_torch/csrc/probes.cu",
                 launches_by_path={"probes": counts[name]})
    attrs = pc.kernel_attrs()
    entries["fat_drain"].update(attrs["drain_highest"], instances={
        "highest": attrs["drain_highest"], "default": attrs["drain_default"]})
    entries["resolve_chain"].update(attrs["drain_carry"])
    entries["dot_chain"].update(attrs["chain_highest"], instances={
        p: attrs[f"chain_{p}"] for p in ("highest", "default", "split3",
                                         "highest_w2048")})
    walks = {f"{v}_{n}": attrs[f"walk_{v}_{n}"] for n in pc.PACKETS
             for v in pc.VARIANTS}
    entries["walk_overhead"].update(attrs["walk_A_2048"], instances=walks)
    few = [k for k, a in walks.items() if k.endswith("2048") and a["blocks_per_sm"] < 2]
    if few:
        raise RuntimeError(f"T2 packet-2048 instances {few} fit one block per SM")
    probes_t1(entries["fat_drain"], t1)
    probes_t3a(entries["dot_chain"], t3a)
    probes_t3b(entries["resolve_chain"], t3b)
    probes_t2(entries["walk_overhead"], bvh, o3, d3, t2)
    probes_t4(entries["slab_rate"], t4)
    for e in entries.values():
        lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.3f} ms"
        log(f"[probes] {e['name']}: kernel {e['ms']:.3f} ms, plain "
            f"{e['plain_ms']:.1f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}), library {lib} ({e['headline']})")
    del bvh, o3, d3, t1, t2, t3a, t3b, t4
    torch.cuda.empty_cache()
    log(f"[probes] {time.perf_counter() - t0:.1f} s in all")
    return entries


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

    def __init__(self, limit=None):
        import glaze_tpu_torch.accel as accel

        self.accel = accel
        self.limit = limit  # calls recorded per dispatcher, None: all
        self.calls = {name: [] for name in self.NAMES}
        self._orig = {name: getattr(accel, name) for name in self.NAMES}
        # a forest's dispatch calls the dispatcher again for each chunk:
        # only the outermost call is recorded
        self._depth = 0

    def _anyhits(self):
        return (len(self.calls["any_hit_soa_auto"])
                + len(self.calls["any_hit_soa_masked_auto"]))

    def _record(self, name, rec):
        if self._depth == 0 and (self.limit is None
                                 or len(self.calls[name]) < self.limit):
            self.calls[name].append(rec())

    def _call(self, fn, *a, **k):
        self._depth += 1
        try:
            return fn(*a, **k)
        finally:
            self._depth -= 1

    def __enter__(self):
        def wrap(name):
            orig = self._orig[name]

            def closest(bvh, o3, d3, t_max=None):
                self._record(name, lambda: dict(
                    bvh=bvh, anyhits_before=self._anyhits(),
                    o3=tuple(x.clone() for x in o3),
                    d3=tuple(x.clone() for x in d3),
                    t_max=None if t_max is None else t_max.clone()))
                return self._call(orig, bvh, o3, d3, t_max)

            def anyhit(bvh, o3, d3, t_max, t_min=1e-3, active=None):
                self._record(name, lambda: dict(
                    bvh=bvh, o3=tuple(x.clone() for x in o3),
                    d3=tuple(x.clone() for x in d3), t_max=t_max.clone(),
                    t_min=t_min, active=active.clone()))
                return self._call(orig, bvh, o3, d3, t_max, t_min=t_min,
                                  active=active)

            return closest if name.startswith("closest") else anyhit

        for name in self.NAMES:
            setattr(self.accel, name, wrap(name))
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            setattr(self.accel, name, self._orig[name])


def _table_bytes(stats):
    """The table bytes this run's rays need: each distinct node row,
    triangle, payload word and fat-leaf coefficient row that the walk in
    the kernel's own order read (bvh.WalkStats), once."""
    return (stats.distinct("nodes") * BYTES_PER_NODE
            + stats.distinct("tris") * BYTES_PER_TRI
            + stats.distinct("mask_words") * BYTES_PER_MASK_WORD
            + stats.distinct("coef") * BYTES_PER_COEF_ROW)


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


def walk_ops(stats):
    """The class counts of a walk's work (node visits, triangle tests,
    cell lookups and fat-leaf columns in the kernel's order)."""
    return summed(scaled(NODE_OPS, stats.node_visits),
                  scaled(TRI_OPS, stats.tri_tests),
                  scaled(MASK_OPS, stats.mask_tests),
                  scaled(COLUMN_OPS, stats.col_tests))


def _bound(nbytes, stats):
    """Least time for the work: the larger of bytes over the HBM rate and
    the walk's instructions (:func:`walk_ops`, :func:`ops_ms`). Returns
    (ms, bound_by, the operations' binding term)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops, term = ops_ms(walk_ops(stats))
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", term)


def _walks(name):
    """(kernel wrapper, plain walker) of the kernel ``name``."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import fat
    from glaze_tpu_torch.accel import traverse_cuda as tc

    return {"closest_hit": (tc.closest_hit_soa, B.closest_hit),
            "closest_hit_masked": (tc.closest_hit_soa_masked,
                                   B.closest_hit_masked),
            "closest_hit_fat": (tc.closest_hit_fat_soa, fat.closest_hit_fat),
            "any_hit": (tc.any_hit_soa, B.any_hit),
            "any_hit_masked": (tc.any_hit_soa_masked, B.any_hit_masked),
            "any_hit_fat": (tc.any_hit_fat_soa, fat.any_hit_fat)}[name]


def _check_closest(entry, label, bvh, s):
    """One closest-hit kernel (K1, K2 or K7c, by ``entry``'s name) against
    its plain walker, walking the kernel's own octant order, on the
    captured rays ``s``: tri (and mixed) exact except where two triangles
    tie exactly on t (counted), t/u/v within 1 ulp. Adds the set's numbers
    to ``entry``."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.tools.common import cuda_ms

    kern_fn, plain_fn = _walks(entry["name"])
    masked = entry["name"] == "closest_hit_masked"
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
    warp = stats.warp_counters()
    log(f"[kernels] {entry['name']} {label}: {int((plain['tri'] >= 0).sum())} "
        f"hits of {r} rays ({live} live){extra}, {n_bad} mismatches, "
        f"{n_tie} exact-t ties (excluded), max {ulps} ulp, max abs err "
        f"{err:g}, plain walk {plain_wall:.1f} s; {_warp_text(warp)}")
    if n_bad or ulps > 1:
        raise RuntimeError(f"{entry['name']} kernel disagrees on {label} rays")
    k_ms = cuda_ms(lambda: kern_fn(bvh, o3, d3, cap_), 5)
    p_ms = cuda_ms(lambda: plain_fn(
        bvh, torch.stack(o3, -1), torch.stack(d3, -1), cap_), 1, warmup=0)
    b_ms, b_by, term = _bound(nbytes, stats)
    entry["sets"][label] = dict(
        rays=r, live=live, mismatches=n_bad, ties=n_tie, max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, bound_term=term,
        bytes=nbytes, warp=warp, **_work(stats))


def _check_anyhit(entry, label, bvh, s):
    """One any-hit kernel (K3, K4 or K7a, by ``entry``'s name) against its
    plain walker, walking the kernel's own octant order, on the captured
    rays ``s``: every flag exact."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.tools.common import cuda_ms

    kern_fn, plain_fn = _walks(entry["name"])
    masked = entry["name"] == "any_hit_masked"
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
    warp = stats.warp_counters()
    log(f"[kernels] {entry['name']} {label}: {int(act.sum())} active of "
        f"{r} rays ({live} live), {what}, {n_bad} mismatches, plain walk "
        f"{plain_wall:.1f} s; {_warp_text(warp)}")
    if n_bad:
        raise RuntimeError(f"{entry['name']} kernel disagrees on {label} rays")
    k_ms = cuda_ms(lambda: kern_fn(bvh, o3, d3, tm, t_min=t_min,
                                     active=act), 5)
    p_ms = cuda_ms(lambda: plain_fn(
        bvh, torch.stack(o3, -1), torch.stack(d3, -1), tm, t_min=t_min,
        active=act), 1, warmup=0)
    b_ms, b_by, term = _bound(nbytes, stats)
    entry["sets"][label] = dict(
        rays=r, active=int(act.sum()), live=live, mismatches=n_bad,
        max_abs_err=float(n_bad), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, bound_term=term, bytes=nbytes, warp=warp,
        **_work(stats))


def _warp_text(warp):
    return (f"warps of 32 rays: node-walk SIMD efficiency "
            f"{warp['simd_efficiency']:.3f}, {warp['mean_leaves_per_lane']:.2f} "
            f"leaves per lane, {warp['mean_warp_max_leaves']:.2f} per warp's "
            f"busiest lane")


def _work(stats):
    """A set's work counters: visits and tests with repeats, distinct rows
    read."""
    return dict(node_visits=stats.node_visits, tri_tests=stats.tri_tests,
                mask_tests=stats.mask_tests, col_tests=stats.col_tests,
                distinct_nodes=stats.distinct("nodes"),
                distinct_tris=stats.distinct("tris"),
                distinct_mask_words=stats.distinct("mask_words"),
                distinct_coef_rows=stats.distinct("coef"))


def _kernel_entry(name, replaces):
    return dict(name=name, route="cuda",
                source="glaze_tpu_torch/csrc/traverse.cu", replaces=replaces,
                library_ms=None, launches=0, launches_by_path={}, sets={})


def _summarize(entry, headline):
    """Headline numbers of a kernel: the mean over the sets ``headline``
    (the per-set numbers stay under ``sets``); the worst error of all."""
    sets = [entry["sets"][k] for k in headline]
    entry.update(
        max_abs_err=max(v["max_abs_err"] for v in entry["sets"].values()),
        ms=statistics.mean(v["ms"] for v in sets),
        plain_ms=statistics.mean(v["plain_ms"] for v in sets),
        bound_ms=statistics.mean(v["bound_ms"] for v in sets),
        bound_by=sets[-1]["bound_by"],
        warp={k: v["warp"] for k, v in entry["sets"].items()})
    log(f"[kernels] {entry['name']}: kernel {entry['ms']:.3f} ms, "
        f"plain {entry['plain_ms']:.1f} ms, bound {entry['bound_ms']:.4f} ms "
        f"({entry['bound_by']}) per launch, mean of {list(headline)}")


def phase_walk_cases():
    """Every traversal kernel against its plain walker, bit for bit, on the
    small cases of glaze_tpu_torch.accel.walk_cases: exact ties, 1/31/33/257
    rays, one long lane per warp; the any hits (K3, K4, K7a) also with
    inactive lanes, lanes that block in their first leaf and, masked, rays
    that end blocked, pending or both."""
    from glaze_tpu_torch.accel import traverse_cuda as tc
    from glaze_tpu_torch.accel import walk_cases as wc

    t0 = time.perf_counter()
    lines = []
    bad = wc.closest_mismatches("cuda", {"closest": tc.closest_hit_soa,
                                         "masked": tc.closest_hit_soa_masked,
                                         "fat": tc.closest_hit_fat_soa},
                                log=lambda *a: lines.append(a))
    for label, rays, hits, n_bad in lines:
        if n_bad or rays == 257:
            log(f"[walk_cases] {label}: {hits} hits of {rays} rays, "
                f"{n_bad} rays differ from the plain walker")
    lines = []
    bad_any = wc.any_mismatches("cuda", {"any": tc.any_hit_soa,
                                         "any_masked": tc.any_hit_soa_masked,
                                         "any_fat": tc.any_hit_fat_soa},
                                log=lambda *a: lines.append(a))
    for label, rays, blocked, pending, n_bad in lines:
        if n_bad or rays == 257:
            log(f"[walk_cases] {label}: {blocked} blocked, {pending} pending "
                f"of {rays} rays, {n_bad} rays differ from the plain walker")
    log(f"[walk_cases] {bad} closest and {bad_any} any-hit rays differ in all "
        f"({time.perf_counter() - t0:.1f} s)")
    if bad or bad_any:
        raise RuntimeError("a traversal kernel disagrees with its plain "
                           "walker on the walk cases")


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
        _check_closest(k1, label, bvh, s)
    _summarize(k1, ("camera", "bounce"))
    k3 = _kernel_entry("any_hit", "glaze_tpu/accel/traverse_pallas.py:817")
    for label, s in (("shadow_camera_hits", anyhit[0]),
                     ("shadow_bounce_hits", anyhit[1])):
        _check_anyhit(k3, label, bvh, s)
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
        _check_closest(k2, label, tree, s)
    _summarize(k2, ("camera", "bounce"))
    k4 = _kernel_entry("any_hit_masked",
                       "glaze_tpu/accel/traverse_pallas.py:1733")
    for label, s in (("shadow_camera_hits", anyhit[0]),
                     ("shadow_bounce_hits", anyhit[1])):
        _check_anyhit(k4, label, scene.bvh, s)
    _summarize(k4, ("shadow_camera_hits", "shadow_bounce_hits"))
    del r, cap
    torch.cuda.empty_cache()
    return {"closest_hit_masked": k2, "any_hit_masked": k4}


def phase_fat_kernels(path):
    """K7c/K7a against their plain versions on the rays of the first two
    launches of a 1920x1080 render of the opaque scene uploaded with
    GLAZE_TREE=fat."""
    from glaze_tpu_torch.accel import FatBVH

    with tree_env("fat"):
        r, cap = _capture_sample(path)
    bvh = r.scene.bvh
    if not isinstance(bvh, FatBVH) or r.scene.bvh_any is not None:
        raise RuntimeError("GLAZE_TREE=fat built no fat tree")
    closest = cap.calls["closest_hit_soa_auto"]
    anyhit = cap.calls["any_hit_soa_auto"]
    log(f"[kernels:fat] fat tree: {bvh.n_nodes} nodes, leaves of "
        f"{bvh.leaf_size}, {bvh.coef.shape[0]} slots; coefficient table "
        f"{bvh.coef.numel() * 4 / 1e6:.1f} MB, slabs "
        f"{bvh.leafmat.numel() * 4 / 1e6:.1f} MB")
    k7c = _kernel_entry("closest_hit_fat", "glaze_tpu/accel/traverse_fat.py:352")
    for label, s in (("camera", closest[0]), ("bounce", closest[1])):
        _check_closest(k7c, label, bvh, s)
    _summarize(k7c, ("camera", "bounce"))
    k7a = _kernel_entry("any_hit_fat", "glaze_tpu/accel/traverse_fat.py:366")
    for label, s in (("shadow_camera_hits", anyhit[0]),
                     ("shadow_bounce_hits", anyhit[1])):
        _check_anyhit(k7a, label, bvh, s)
    _summarize(k7a, ("shadow_camera_hits", "shadow_bounce_hits"))
    del r, cap
    torch.cuda.empty_cache()
    return {"closest_hit_fat": k7c, "any_hit_fat": k7a}


# The NEE kernel's least instructions (csrc/shade_lane.cuh nee_lane), by
# part and class, as a floor: the float arithmetic as written, an IEEE
# division and square root at their fast paths (MUFU.RCP or MUFU.RSQ and
# the Newton steps), sinf/cosf at the least of their sequence; integer,
# address and load work is not charged, and an sRGB tap is charged its
# compare and the linear branch's multiply only
NEE_DIV = {"MUFU": 1, "FFMA": 2, "FADD": 1, "FSETP": 1}
NEE_SQRT = {"MUFU": 1, "FMUL": 1, "FFMA": 2, "FSETP": 1}
NEE_TRIG = {"FMUL": 3, "FFMA": 8, "FSETP": 1}
NEE_NORMALIZE = summed({"FMUL": 6, "FADD": 2, "FMNMX": 1}, NEE_SQRT, NEE_DIV)
NEE_SMITS = summed({"FSETP": 6}, scaled({"FMUL": 4, "FADD": 3, "FMNMX": 2},
                                        16))
NEE_TOWARD = summed({"FADD": 5, "FMUL": 6, "FMNMX": 2}, NEE_SQRT, NEE_DIV,
                    NEE_DIV)
NEE_TEX_SETUP = {"FADD": 6, "FMUL": 2, "other": 4}
NEE_TEX = {1: summed(NEE_TEX_SETUP, {"FMUL": 10, "FADD": 3, "FSETP": 4}),
           3: summed(NEE_TEX_SETUP, scaled({"FMUL": 10, "FADD": 3,
                                            "FSETP": 4}, 3))}
NEE_LAMBDA = summed({"FMUL": 7, "FADD": 4, "FMNMX": 3, "FSETP": 1},
                    scaled(NEE_DIV, 3), NEE_SQRT)
NEE_GGX = summed({"FMUL": 12, "FADD": 8, "FMNMX": 1, "FSETP": 1},
                 scaled(NEE_DIV, 10), scaled(NEE_LAMBDA, 3))  # D, G, pdf
NEE_FRESNEL_C = summed({"FMUL": 6, "FADD": 6}, scaled(NEE_DIV, 2))
NEE_FRESNEL_D = summed({"FMUL": 8, "FADD": 5, "FMNMX": 2, "FSETP": 1},
                       NEE_SQRT, scaled(NEE_DIV, 3))
NEE_OPS = {
    "common": summed(
        {"FMUL": 1 + 18 + 3 + 2 + 1 + 16 * 6 + 12 + 5,
         "FADD": 12 + 2 + 16 * 3 + 6 + 1 + 6, "FSETP": 2 + 3,
         "FMNMX": 1 + 7}, scaled(NEE_NORMALIZE, 2), scaled(NEE_DIV, 2)),
    "omni": summed(NEE_TOWARD, {"FMUL": 16}),
    "sun": {"FMUL": 17, "FADD": 1},
    "area": summed({"FADD": 15, "FMUL": 22, "FMNMX": 2}, NEE_SQRT, NEE_SQRT,
                   NEE_TOWARD, NEE_SMITS, {"FMUL": 16}, NEE_DIV),
    "sky": summed({"FMUL": 17, "FADD": 13, "FSETP": 4, "FMNMX": 4},
                  scaled(NEE_DIV, 7), scaled(NEE_TRIG, 4), NEE_NORMALIZE,
                  NEE_TEX[3], NEE_SMITS),
    "lambert": summed(NEE_SMITS, {"FMUL": 5, "FSETP": 1}),
    "metal": summed(NEE_NORMALIZE, {"FADD": 5, "FMUL": 7}, NEE_GGX,
                    scaled(NEE_FRESNEL_C, 16), {"FMUL": 16}),
    "frosted": summed(NEE_NORMALIZE, {"FADD": 9, "FMUL": 12}, NEE_GGX,
                      NEE_FRESNEL_D, scaled(NEE_DIV, 2)),
    "uber_spec": summed(NEE_NORMALIZE, {"FADD": 9, "FMUL": 12}, NEE_GGX,
                        NEE_FRESNEL_D, scaled(summed(NEE_FRESNEL_C, {
                            "FADD": 2, "FMUL": 2}), 16)),
    "uber_diffuse": summed({"FMUL": 15, "FADD": 9, "FMNMX": 1, "FSETP": 2},
                           scaled(NEE_SQRT, 2), scaled(NEE_DIV, 7),
                           NEE_SMITS),
    "tex1": NEE_TEX[1], "tex3": NEE_TEX[3],
}


def _nee_work(scene, args):
    """Lanes by the parts of NEE_OPS they run, from one launch's inputs
    (lights by the picked light's type, BSDFs by the lane's family, the
    uber lanes split by their BSDF draw, texture fetches by the slots the
    scene textures and the texels the kernel writes)."""
    hit, imp, draws = args["hit"], args["importance"], args["draws"]
    p = imp.shape[1]
    c = draws[0].shape[0]
    ex = (lambda a: a.repeat_interleave(p // c)) if c != p else (lambda a: a)
    n = int(scene.lights_no)
    li = torch.clamp(torch.minimum((ex(draws[0]) * float(n)).to(torch.int32),
                                   torch.tensor(n - 1, device=imp.device)),
                     min=0)
    ltype = scene.light_scalars[li.long(), 0].to(torch.int32)
    fam = scene.mat_scalars[hit["material_id"].long(), 8].to(torch.int32)
    spec = ex(draws[4]) < 0.5
    lanes = {"common": p}
    for k, name in enumerate(("omni", "sun", "area", "sky")):
        lanes[name] = int((ltype == k).sum())
    for k, name in ((0, "lambert"), (3, "metal"), (4, "frosted")):
        lanes[name] = int((fam == k).sum())
    lanes["uber_spec"] = int(((fam == 5) & spec).sum())
    lanes["uber_diffuse"] = int(((fam == 5) & ~spec).sum())
    slots, fams = set(scene.tex_slots), set(scene.mat_families)
    diffuse = (0 in slots) and bool(fams & {0, 5})
    lanes["tex3"] = p if diffuse else 0
    lanes["tex1"] = p * (int((1 in slots) and bool(fams & {3, 4, 5}))
                         + int((2 in slots) and 5 in fams))
    return lanes


def _nee_bytes(args, out):
    """Bytes a launch must move: every lane input read once (the draws at
    their chain width) and every output written once; the scene's rows
    and texels, which the lanes share from L2, are not counted."""
    hit = args["hit"]
    ins = [*hit["point"], *args["frame"][0], *args["frame"][1],
           *args["frame"][2], *args["wo_w"], *hit["uv"], hit["material_id"],
           args["importance"], args["nee_active"], *args["draws"]]
    outs = [out[k] for k in ("wiw", "cap", "active", "rgb", "key",
                             "diffuse", "rough", "metal") if k in out]
    return sum(t.numel() * t.element_size() for t in ins + outs)


def phase_nee(path):
    """The NEE kernel (render/shade_cuda.py, csrc/shade.cu) against its plain
    version on the card, on the inputs of the first two launches of a
    1920x1080 render of the full scene (camera hits, then bounce hits):
    wiw, cap, the shadow rays' active lanes and sort key, and the texels
    bit for bit; the contribution within 1e-5 of the lane's largest
    channel (the 16-bin sums run in another order). Times the kernel
    (CUDA events over 20 launches), the plain version and the bound."""
    from glaze_tpu_torch.render import bsdf as bsdf_mod
    from glaze_tpu_torch.render import integrator as ti
    from glaze_tpu_torch.render import shade_cuda as shade

    sets = []
    orig = shade.nee

    def capture(scene, hit, wo_w, frame, mat, importance, nee_active, draws,
                expand):
        if len(sets) < 2:
            def cl(x):
                return tuple(cl(y) for y in x) if isinstance(x, tuple) \
                    else x.clone()
            sets.append({"hit": {k: cl(hit[k]) for k in (
                "point", "shading_normal", "uv", "material_id")},
                "wo_w": cl(wo_w), "frame": cl(frame),
                "importance": importance.clone(),
                "nee_active": nee_active.clone(), "draws": cl(draws)})
        return orig(scene, hit, wo_w, frame, mat, importance, nee_active,
                    draws, expand)

    shade.nee = capture
    try:
        r, _ = _capture_sample(path)
    finally:
        shade.nee = orig
    scene = r.scene
    p = sets[0]["importance"].shape[1]
    entry = dict(name="nee", route="cuda", source="glaze_tpu_torch/csrc/shade.cu",
                 replaces="none (glaze_tpu/render/integrator.py direct_light, "
                 "left to XLA's fusion)", library_ms=None, launches=0,
                 launches_by_path={}, sets={})
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for label, a in zip(("camera_hits", "bounce_hits"), sets):
        def plain(mat):
            return shade.nee_plain(scene, a["hit"], a["wo_w"], a["frame"],
                                   mat, a["importance"], a["nee_active"],
                                   a["draws"],
                                   lambda x: ti._expand_block(x, p))

        mat_p = bsdf_mod.gather_material(scene, a["hit"]["material_id"])
        want = plain(mat_p)
        mat_k = bsdf_mod.gather_material(scene, a["hit"]["material_id"])
        got = shade.nee_kernel(scene, a["hit"], a["wo_w"], a["frame"], mat_k,
                               a["importance"], a["nee_active"], a["draws"])
        torch.cuda.synchronize()
        bad = {}
        for k in ("cap", "active", "key"):
            w = want[k] if k != "key" else ti._trace_key(
                scene, a["hit"]["point"], want["wiw"], want["active"])
            bad[k] = int((got[k] != w).sum())
        bad["wiw"] = int(sum((g != w).sum() for g, w in zip(got["wiw"],
                                                            want["wiw"])))
        # the texels it returns for the BSDF stage against those the plain
        # version kept in its memo
        for key, (_, val) in mat_p.get("_texmemo", {}).items():
            mine = got["texels"][key]
            for g, w in zip(mine if isinstance(mine, tuple) else (mine,),
                            val if isinstance(val, tuple) else (val,)):
                bad[f"texel_{key}"] = bad.get(f"texel_{key}", 0) + int(
                    (g != w).sum())
        scale = want["rgb"].abs().amax(dim=0)
        err = ((got["rgb"] - want["rgb"]).abs()
               / torch.clamp(scale, min=1e-30)).amax().item()
        bad["rgb_beyond_1e-5"] = int(((got["rgb"] - want["rgb"]).abs()
                                      > 1e-5 * scale).any(dim=0).sum())
        log(f"[nee] {label}: {p} lanes, {int(a['nee_active'].sum())} NEE "
            f"lanes, {int(got['active'].sum())} shadow rays; lanes apart "
            f"from the plain version {bad}; rgb off by {err:.2e} of the "
            "lane's scale at most")
        if any(bad.values()):
            raise RuntimeError(f"[nee] {label}: the kernel disagrees with "
                               f"its plain version: {bad}")
        args, out = shade.nee_prepare(scene, a["hit"], a["wo_w"], a["frame"],
                                      a["importance"], a["nee_active"],
                                      a["draws"])
        dev = a["importance"].device
        for _ in range(3):
            shade.launch("nee", args, dev)
        ev[0].record()
        for _ in range(20):
            shade.launch("nee", args, dev)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / 20
        plain(bsdf_mod.gather_material(scene, a["hit"]["material_id"]))
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(3):
            plain(bsdf_mod.gather_material(scene, a["hit"]["material_id"]))
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms = ev[0].elapsed_time(ev[1]) / 3
        lanes = _nee_work(scene, a)
        ops = summed(*(scaled(NEE_OPS[k], n) for k, n in lanes.items()))
        t_ops, term = ops_ms(ops, blocks=SMS)
        nbytes = _nee_bytes(a, out)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        entry["sets"][label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else f"operations, {term}",
            bytes_ms=t_bytes, ops_ms=t_ops, bytes=nbytes, lanes=lanes,
            max_abs_err=err, mismatches=bad, warp={})
        log(f"[nee] {label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound:.4f} ms (bytes {nbytes / 1e9:.3f} GB = "
            f"{t_bytes:.4f} ms; operations {t_ops:.4f} ms, {term}); lanes "
            f"by part {lanes}")
    _summarize(entry, ("camera_hits", "bounce_hits"))
    del r, sets
    torch.cuda.empty_cache()
    return {"nee": entry}


def _surface_bytes(a, out):
    """Bytes a launch of the shade kernel must move, at least: every lane
    reads its hit's row index and barycentrics, its direction, bounce and
    last_specular and the parked mask where there is one, and writes the
    20 floats of the output buffer, its material row and two flags; a lane
    that adds the sky reads 16 bins of importance; each distinct 34-float
    attribute row the lanes hit is read once (``distinct_rows``, the bound;
    ``per_lane`` counts each lane's row, which overstates it: lanes share
    rows, and the table fits in L2). The material rows, texels and the
    sky's table come from L2 and are not counted."""
    p = a["importance"].shape[1]
    sky = int(((out["miss_rgb"][0] != 0) | (out["miss_rgb"][1] != 0)
               | (out["miss_rgb"][2] != 0)).sum())
    rows = int(torch.unique(torch.clamp(a["hit"]["tri"], min=0)).numel())
    lane = 4 * 3 + 4 * 3 + 4 * 2 + (1 if a["parked"] is not None else 0)
    lane += 4 * 20 + 4 + 2
    rest = lane * p + 4 * 16 * sky
    row = 4 * 34
    return {"per_lane": rest + row * p, "distinct_rows": rest + row * rows,
            "sky_lanes": sky, "rows": rows}


def phase_surface(path):
    """The shade kernel (render/shade_cuda.py, csrc/shade.cu) against its
    plain version on the card, on the inputs of the first two launches of
    a 1920x1080 render of the full scene (camera rays, then bounce rays):
    every lane float (the hit point, the frame, wo, uv, the sky's RGB), the
    material rows and both flags bit for bit. Times the kernel (CUDA
    events over 20 launches) and the plain version, and gives the bound by
    bytes (_surface_bytes: each distinct attribute row once)."""
    from glaze_tpu_torch.render import shade_cuda as shade

    sets = []
    orig = shade.surface

    def cl(x):
        if isinstance(x, tuple):
            return type(x)(*(cl(y) for y in x)) if hasattr(x, "_replace") \
                else tuple(cl(y) for y in x)
        return x.clone() if isinstance(x, torch.Tensor) else x

    def capture(scene, hit, direction, state, importance, parked=None):
        if len(sets) < 2:
            sets.append({"hit": {k: hit[k].clone() for k in ("tri", "u",
                                                             "v")},
                         "direction": cl(direction), "state": cl(state),
                         "importance": importance.clone(),
                         "parked": cl(parked)})
        return orig(scene, hit, direction, state, importance, parked)

    shade.surface = capture
    try:
        r, _ = _capture_sample(path)
    finally:
        shade.surface = orig
    scene = r.scene
    p = sets[0]["importance"].shape[1]
    entry = dict(name="surface", route="cuda",
                 source="glaze_tpu_torch/csrc/shade.cu",
                 replaces="none (glaze_tpu/render/integrator.py closest-hit "
                 "and miss shading, left to XLA's fusion)", library_ms=None,
                 launches=0, launches_by_path={}, sets={})
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for label, a in zip(("camera_hits", "bounce_hits"), sets):
        def call(fn):
            return fn(scene, a["hit"], a["direction"], a["state"],
                      a["importance"], a["parked"])

        want = call(shade.surface_plain)
        got = call(shade.surface_kernel)
        torch.cuda.synchronize()
        names = ("px", "py", "pz", "sx", "sy", "sz", "tx", "ty", "tz", "nx",
                 "ny", "nz", "wox", "woy", "woz", "u", "v", "sky_r", "sky_g",
                 "sky_b")
        bad = {}
        for name, g, w in zip(names, _surface_floats(got),
                              _surface_floats(want)):
            n_bad = int((~((g == w) | (torch.isnan(g) & torch.isnan(w))))
                        .sum())
            if n_bad:
                bad[name] = n_bad
        for k, g, w in (("material_id", got["surf"]["material_id"],
                         want["surf"]["material_id"]),
                        ("missed", got["missed"], want["missed"]),
                        ("nee_active", got["nee_active"],
                         want["nee_active"])):
            if int((g != w).sum()):
                bad[k] = int((g != w).sum())
        nb = _surface_bytes(a, want)
        log(f"[surface] {label}: {p} lanes, {int(want['missed'].sum())} "
            f"missed, {nb['sky_lanes']} add the sky, "
            f"{int(want['nee_active'].sum())} NEE lanes, {nb['rows']} "
            f"distinct rows; elements apart from the plain version "
            f"{bad or 0}")
        if bad:
            raise RuntimeError(f"[surface] {label}: the kernel disagrees "
                               f"with its plain version: {bad}")
        args, _ = shade.surface_prepare(scene, a["hit"], a["direction"],
                                        a["state"], a["importance"],
                                        a["parked"])
        dev = a["importance"].device
        for _ in range(3):
            shade.launch("surface", args, dev)
        ev[0].record()
        for _ in range(20):
            shade.launch("surface", args, dev)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / 20
        call(shade.surface_plain)
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(3):
            call(shade.surface_plain)
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms = ev[0].elapsed_time(ev[1]) / 3
        bound = nb["distinct_rows"] / PEAK_BYTES * 1e3
        entry["sets"][label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
            bytes_ms=bound, bytes=nb["distinct_rows"],
            per_lane_bytes=nb["per_lane"], max_abs_err=0.0, mismatches=bad,
            warp={})
        log(f"[surface] {label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} "
            f"ms, bound {bound:.4f} ms (bytes "
            f"{nb['distinct_rows'] / 1e9:.3f} GB, each distinct row once), "
            f"{ms / bound:.2f}x the bound; each lane's row "
            f"{nb['per_lane'] / 1e9:.3f} GB")
    _summarize(entry, ("camera_hits", "bounce_hits"))
    del r, sets
    torch.cuda.empty_cache()
    return {"surface": entry}


def _surface_floats(res):
    """The 20 lane floats of a shade stage's result, as (P,) rows in the
    kernel's order."""
    s, t, n = res["frame"]
    surf = res["surf"]
    return (*surf["point"], *s, *t, *n, *res["wo_w"], *surf["uv"],
            *res["miss_rgb"])


def _bsdf_bytes(scene, a):
    """Bytes a launch of the BSDF kernel must move, at least: every lane
    reads its miss flag, material row index, bounce, last_specular, accum,
    sq and the two contributions and writes the 29 floats of its new state;
    a lane that hit reads the frame, wo, the hit point, uv, the launch's
    importance and its draws (at their chain width), and the NEE stage's
    texels that its family reads; a lane that missed reads the old
    importance, origin and direction. The scene's rows come from L2 and
    are not counted."""
    p = a["importance"].shape[1]
    c = a["draws"][0].shape[0]
    hit = ~a["missed"]
    hits = int(hit.sum())
    fam = scene.mat_scalars[a["hit"]["material_id"].long(), 8]
    readers = {"diffuse": (0, 5), "rough": (3, 4, 5), "metal": (5,)}
    texels = 0
    for key, val in a["texels"].items():
        rows = len(val) if isinstance(val, tuple) else 1
        reads = hit & sum((fam == f) for f in readers[key]).bool()
        texels += 4 * rows * int(reads.sum())
    every = 1 + 4 + 4 * (1 + 1 + 3 + 1 + 3 + 3) + 4 * 29
    live = 4 * (3 + 9 + 3 + 2 + 16) + (16 if c == p else 0)
    draws = 0 if c == p else 4 * 4 * c
    return every * p + live * hits + texels + draws + 4 * 22 * (p - hits)


def phase_bsdf(path):
    """The BSDF kernel (render/shade_cuda.py, csrc/shade.cu) against its
    plain version on the card, on the inputs of the first two launches of
    a 1920x1080 render of the full scene (camera hits, then bounce hits),
    given the texels the NEE kernel returned and fetching its own: every
    leaf of the new state bit for bit. Times the kernel (CUDA events over
    20 launches) and the plain version, and gives the bound by bytes
    (_bsdf_bytes)."""
    from glaze_tpu_torch.render import bsdf as bsdf_mod
    from glaze_tpu_torch.render import integrator as ti
    from glaze_tpu_torch.render import shade_cuda as shade

    sets = []
    orig = shade.bsdf

    def cl(x):
        if isinstance(x, tuple):
            return type(x)(*(cl(y) for y in x)) if hasattr(x, "_replace") \
                else tuple(cl(y) for y in x)
        return x.clone() if isinstance(x, torch.Tensor) else x

    def capture(scene, state, hit, missed, wo_w, frame, mat, importance,
                miss_rgb, nee_rgb, draws, expand, direct_only=False,
                texels=None):
        if len(sets) < 2:
            sets.append({
                "state": cl(state), "hit": {k: cl(hit[k]) for k in (
                    "point", "shading_normal", "uv", "material_id")},
                "missed": missed.clone(), "wo_w": cl(wo_w),
                "frame": cl(frame), "importance": importance.clone(),
                "miss_rgb": cl(miss_rgb), "nee_rgb": nee_rgb.clone(),
                "draws": cl(tuple(draws)),
                "texels": {k: cl(v) for k, v in texels.items()}})
        return orig(scene, state, hit, missed, wo_w, frame, mat, importance,
                    miss_rgb, nee_rgb, draws, expand, direct_only, texels)

    shade.bsdf = capture
    try:
        r, _ = _capture_sample(path)
    finally:
        shade.bsdf = orig
    scene = r.scene
    p = sets[0]["importance"].shape[1]
    entry = dict(name="bsdf", route="cuda", source="glaze_tpu_torch/csrc/shade.cu",
                 replaces="none (glaze_tpu/render/integrator.py path_trace "
                 "step's bounce, left to XLA's fusion)", library_ms=None,
                 launches=0, launches_by_path={}, sets={})
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for label, a in zip(("camera_hits", "bounce_hits"), sets):
        hit = a["hit"]

        def call(fn, m, *extra, **kw):
            return fn(scene, a["state"], hit, a["missed"], a["wo_w"],
                      a["frame"], m, a["importance"], a["miss_rgb"],
                      a["nee_rgb"], a["draws"], *extra, **kw)

        def ex(x):
            return ti._expand_block(x, p)

        # the plain version fetches its own texels into mat_p, which the
        # timed calls below reuse, as the plain stage reuses the NEE stage's
        mat_p = bsdf_mod.gather_material(scene, hit["material_id"])
        want = call(shade.bsdf_plain, mat_p, ex)
        bad = {}
        for given in (True, False):
            got = call(shade.bsdf_kernel,
                       bsdf_mod.gather_material(scene, hit["material_id"]),
                       texels=a["texels"] if given else None)
            torch.cuda.synchronize()
            for k, w in want.items():
                g = got[k]
                g = torch.stack(g) if isinstance(g, tuple) else g
                w = torch.stack(w) if isinstance(w, tuple) else w
                same = (g == w) | (torch.isnan(g) & torch.isnan(w))
                n_bad = int((~same).sum())
                if n_bad:
                    bad[f"{k}{'' if given else '_fetched'}"] = n_bad
        missed = int(a["missed"].sum())
        killed = int(((a["state"].bounce > 3) & ~a["missed"]
                      & (want["bounce"] == 0)).sum())
        log(f"[bsdf] {label}: {p} lanes, {p - missed} hits, "
            f"{int((want['bounce'] > 0).sum())} paths go on, {killed} "
            f"roulette-active hits end; elements apart from the plain "
            f"version {bad or 0}")
        if bad:
            raise RuntimeError(f"[bsdf] {label}: the kernel disagrees with "
                               f"its plain version: {bad}")
        args, out = shade.bsdf_prepare(
            scene, a["state"], hit, a["missed"], a["wo_w"], a["frame"],
            a["importance"], a["miss_rgb"], a["nee_rgb"], a["draws"],
            texels=a["texels"])
        dev = a["importance"].device
        for _ in range(3):
            shade.launch("bsdf", args, dev)
        ev[0].record()
        for _ in range(20):
            shade.launch("bsdf", args, dev)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / 20
        call(shade.bsdf_plain, mat_p, ex)
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(3):
            call(shade.bsdf_plain, mat_p, ex)
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms = ev[0].elapsed_time(ev[1]) / 3
        nbytes = _bsdf_bytes(scene, a)
        bound = nbytes / PEAK_BYTES * 1e3
        entry["sets"][label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
            bytes_ms=bound, bytes=nbytes, max_abs_err=0.0, mismatches=bad,
            warp={})
        log(f"[bsdf] {label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound:.4f} ms (bytes {nbytes / 1e9:.3f} GB), "
            f"{ms / bound:.2f}x the bound")
    _summarize(entry, ("camera_hits", "bounce_hits"))
    del r, sets
    torch.cuda.empty_cache()
    return {"bsdf": entry}


def _launch_counts():
    """Every traversal kernel's and shading kernel's launch count, by
    KERNELS name, and every probe kernel's."""
    from glaze_tpu_torch.accel import traverse_cuda as tc
    from glaze_tpu_torch.render import shade_cuda as shade
    from glaze_tpu_torch.tools import probes_cuda as pc

    wrappers = (tc.closest_hit_soa, tc.any_hit_soa, tc.closest_hit_soa_masked,
                tc.any_hit_soa_masked, tc.closest_hit_fat_soa,
                tc.any_hit_fat_soa, shade.nee_kernel, shade.bsdf_kernel,
                shade.surface_kernel)
    return ({name: fn.launches for name, fn in zip(KERNELS, wrappers)},
            {fn.__name__: fn.launches for fn in pc.KERNEL_WRAPPERS})


def _reset_counts():
    from glaze_tpu_torch.accel import traverse_cuda as tc
    from glaze_tpu_torch.render import shade_cuda as shade
    from glaze_tpu_torch.tools import probes_cuda as pc

    tc.reset_launch_counts()
    shade.reset_launch_counts()
    pc.reset_launch_counts()


def _held_to(tag, label, launches, probe_launches, expected, report):
    """A path's launch counts against ``expected`` (every probe counter
    0); the launches go into ``report`` under ``label``."""
    if any(probe_launches.values()):
        raise RuntimeError(f"{label} render launched probes {probe_launches}")
    log(f"[{tag}] kernel launches during the render: {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise RuntimeError(f"{label} render launched {launches}, expected "
                           f"{expected}")
    for name, n in launches.items():
        if expected[name]:
            report[name]["launches"] += n
            report[name]["launches_by_path"][label] = n


def run_cli(argv, env=None):
    """The port's CLI in this process with the variables ``env`` set
    around it and every kernel counter set to 0 just before; returns
    (exit code, renderer, times, launches, probe launches, stderr)."""
    import io

    from glaze_tpu_torch import cli

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    err = io.StringIO()
    try:
        _reset_counts()
        with contextlib.redirect_stderr(err):
            code, renderer, times = cli.run(argv)
        launches, probes = _launch_counts()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    text = err.getvalue()
    for line in text.replace("\r", "\n").splitlines():
        if line.strip() and not line.startswith("Rendering"):
            log(f"  cli: {line.strip()}")
    return code, renderer, times, launches, probes, text


def phase_main_path(label, path, workdir, report, expected, tree=None):
    """The port's CLI on a scene at 1920x1080, 2 spp, on the card, with
    GLAZE_TREE=``tree`` around the call; every kernel counter is set to 0
    just before and read just after, and must equal ``expected`` (every
    probe counter 0)."""
    from PIL import Image

    out = os.path.join(workdir, f"sponza_{label}.png")
    with tree_env(tree):
        code, renderer, times, launches, probe_launches, _ = run_cli([
            path, out, "--res", f"{RES[0]}x{RES[1]}", "--spp", str(SPP),
            "--seed", str(SEED)])
    if code != 0:
        raise RuntimeError(f"CLI exited {code}")
    _held_to(f"main:{label}", label, launches, probe_launches, expected,
             report)
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
    if label == "full":
        # [mesh] holds the --mesh render of the same command to these bits
        MAIN_STATES[label] = _state_np(st)
    numbers["profile"] = profile_sample(renderer, label)
    del renderer
    torch.cuda.empty_cache()
    return numbers


# host copies of main-path renders that a later phase compares with
MAIN_STATES = {}


def profile_sample(renderer, label):
    """Where one sample's time goes (6 launches of the main path, after
    the render above). Wall time is taken unprofiled; device time by
    kernel comes from torch.profiler (CUPTI). Reports, not checks: if the
    profiler records no device time the numbers read "not measured"."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.draw(1, return_image=False)
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, walks = _device_kernels(
        lambda: renderer.draw(1, return_image=False))
    busy_ms = sum(v[0] for v in kernels.values())
    if busy_ms <= 0.0:
        log(f"[profile:{label}] the profiler recorded no device time: not "
            "measured")
        return {"wall_ms_per_sample": wall_ms, "device_busy_ms": "not measured"}
    trav = sum(v[0] for v in walks.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"[profile:{label}] one sample (6 launches): wall {wall_ms:.1f} ms unprofiled, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f}% of wall), "
        f"traversal kernels {trav:.2f} ms ({100 * trav / busy_ms:.1f}% of busy), "
        f"{sum(v[1] for v in kernels.values())} kernel launches")
    per_launch = {name: ms / n for name, (ms, n) in walks.items()}
    for name, what in (("surface", "shade"), ("nee", "NEE"),
                       ("bsdf", "BSDF")):
        mine = [v for k, v in kernels.items() if f"{name}_kernel" in k]
        if mine:
            per_launch[name] = (sum(v[0] for v in mine)
                                / sum(v[1] for v in mine))
            log(f"[profile:{label}]   {what} kernel: "
                f"{sum(v[1] for v in mine)} launches, {per_launch[name]:.3f} "
                "ms per launch in the render")
    for name, (ms, n) in sorted(walks.items()):
        log(f"[profile:{label}]   traversal {name}: {n} launches, {ms:.2f} ms, "
            f"{ms / n:.3f} ms per launch in the render")
    for name, (ms, n) in top:
        log(f"[profile:{label}]   {ms:8.2f} ms  {n:6d}x  {name}")
    return {"wall_ms_per_sample": wall_ms, "device_busy_ms": busy_ms,
            "traversal_ms": trav, "traversal_ms_per_launch": per_launch,
            "kernel_launches": sum(v[1] for v in kernels.values()),
            "top": [[name, ms, n] for name, (ms, n) in top]}


def _device_kernels(fn):
    """torch.profiler (CUPTI) over one call of ``fn``, the card idle before
    and after: {kernel name: [device ms, launches]} of every kernel, and
    the same for the traversal kernels by wrapper name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    walks = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        k = kernels.setdefault(e.key[:90], [0.0, 0])
        k[0] += us / 1e3
        k[1] += e.count
        name = _traversal_kernel(e.key)
        if name is not None:
            w = walks.setdefault(name, [0.0, 0])
            w[0] += us / 1e3
            w[1] += e.count
    return kernels, walks


# the traversal kernels' device-function names (csrc/traverse.cu) and the
# wrapper each one serves, the fat kernels first (their names extend the
# classic ones')
TRAVERSAL_NAMES = (("closest_kernel_fat", "closest_hit_fat"),
                   ("anyhit_kernel_fat", "any_hit_fat"),
                   ("closest_kernel<false", "closest_hit"),
                   ("closest_kernel<true", "closest_hit_masked"),
                   ("anyhit_kernel<false", "any_hit"),
                   ("anyhit_kernel<true", "any_hit_masked"))


def _traversal_kernel(key):
    """The wrapper name of the traversal kernel a profiler key names, or
    None."""
    for fn, name in TRAVERSAL_NAMES:
        if fn in key:
            return name
    return None


GOLDEN = os.path.join(HERE, "tests", "goldens", "matrow_coh1.npz")


def _state_np(state):
    """(accum (P, 3), count (P,)) of a PathState as NumPy."""
    return (torch.stack(state.accum, -1).cpu().numpy(),
            state.count.cpu().numpy())


def _mc_agree(tag, accum, count, ref_accum, ref_count):
    """count exact and the clipped image within the Monte-Carlo bound of
    tests/test_goldens.py (per-pixel MAD < 0.06, image mean within 3%)."""
    if not np.array_equal(count, ref_count):
        raise RuntimeError(f"{tag}: count differs")
    if not np.isfinite(accum).all():
        raise RuntimeError(f"{tag}: non-finite radiance")
    ca = np.clip(accum / np.maximum(count, 1.0)[:, None], 0.0, 1.0)
    cg = np.clip(ref_accum / np.maximum(ref_count, 1.0)[:, None], 0.0, 1.0)
    mad = float(np.abs(ca - cg).mean())
    dmean = abs(ca.mean() - cg.mean())
    log(f"[{tag}] count exact, per-pixel MAD {mad:.3g} (bound 0.06), "
        f"image mean {ca.mean():.5f} vs {cg.mean():.5f}")
    if mad >= 0.06 or dmean >= 0.03 * max(cg.mean(), 1e-6):
        raise RuntimeError(f"{tag}: render outside the MC bound")
    return mad


def phase_golden():
    """The golden scene at 96x48, coherent 1, 8 spp against the stored
    golden of the JAX package (exact count, MAD within the MC bound)."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    g = np.load(GOLDEN)
    r = RayTraceRenderer(ps.MatRowScene(), width=ps.GOLDEN_W,
                         height=ps.GOLDEN_H, seed=ps.GOLDEN_SEED, coherent=1,
                         device="cuda")
    r.draw(ps.GOLDEN_SPP, return_image=False)
    _mc_agree("golden", *_state_np(r._state), g["accum"], g["count"])


# [sampling]: the CLI with two samples in flight, the ld sampler, coherent
# off and adaptive stopping; the small minimum and loose tau make tiles
# park within the 2 spp. Launches: ceil(2 * 6 / 2) = 6, each tracing two
# copies of the padded grid; per launch the full scene's kernels as in
# EXPECTED_FULL.
SAMPLING_ENV = {"GLAZE_ADAPTIVE_MIN": "6", "GLAZE_ADAPTIVE_TAU": "0.5"}
SAMPLING_FLAGS = ["--sif", "2", "--sampler", "ld", "--coherent", "off",
                  "--adaptive", "on"]
SAMPLING_LAUNCHES = -(-SPP * 6 // 2)
EXPECTED_SAMPLING = _expected(SAMPLING_LAUNCHES,
                              closest_hit_masked=4 * SAMPLING_LAUNCHES,
                              any_hit_masked=SAMPLING_LAUNCHES)
# [resume]: one sample (6 launches) of the full scene per process
EXPECTED_RESUME = _expected(6, closest_hit_masked=4 * 6, any_hit_masked=6)
EXPECTED_PROFILE = _expected(6, closest_hit=6, any_hit=6)


@contextlib.contextmanager
def mask_log(masks):
    """Appends (mask, count, bounce) of every adaptive mask the renderer
    takes (once per chunk, from the state before the chunk) to
    ``masks``."""
    from glaze_tpu_torch.render import integrator as integ

    real = integ.adaptive_lane_mask

    def mask(state, **kw):
        m = real(state, **kw)
        masks.append((m.clone(), state.count.clone(), state.bounce.clone()))
        return m

    integ.adaptive_lane_mask = mask
    try:
        yield masks
    finally:
        integ.adaptive_lane_mask = real


def _sampling_kernels(scene, cap, report):
    """K2 and K4 against their plain walkers (as in [kernels]) on the
    [sampling] render's own dispatches of 2 x 2,088,960 lanes: K2 on the
    full tree's walk of launch 0 (camera rays of both copies), launch 1
    (mostly bounce rays) and the last launch (parked lanes carry cap -1);
    K4 on the shadow rays of launch 0 and of the last launch (parked lanes
    inactive). Returns the parked lanes of the last launch's walk."""
    closest = cap.calls["closest_hit_soa_masked_auto"]
    anyhit = cap.calls["any_hit_soa_masked_auto"]
    # launch n's first full-tree call is its walk (n any-hit calls before
    # it); the second is its re-test round
    walk = {}
    for c in closest:
        if c["bvh"] is scene.bvh:
            walk.setdefault(c["anyhits_before"], c)
    last = SAMPLING_LAUNCHES - 1
    parked = int((walk[last]["t_max"] < 0).sum())
    log(f"[sampling] launch {last}: {parked} of "
        f"{walk[last]['o3'][0].shape[0]} lanes parked (cap -1), "
        f"{int(anyhit[last]['active'].sum())} shadow rays active")
    if not parked:
        raise RuntimeError("the last sampling launch traced no parked lane")
    k2, k4 = report["closest_hit_masked"], report["any_hit_masked"]
    for label, s in (("sampling_camera", walk[0]),
                     ("sampling_bounce", walk[1]),
                     ("sampling_parked", walk[last])):
        _check_closest(k2, label, scene.bvh, s)
    for label, s in (("sampling_shadow", anyhit[0]),
                     ("sampling_shadow_parked", anyhit[last])):
        _check_anyhit(k4, label, scene.bvh, s)
    # the headline stays the one-copy sets of [kernels]; the worst error
    # and the warp counters take the new sets in
    _summarize(k2, ("camera", "bounce"))
    _summarize(k4, ("shadow_camera_hits", "shadow_bounce_hits"))
    return parked


# the golden of [sampling]: sif 2, ld, coherent 0 and adaptive stopping
# whose tiles park within its 8 spp (24 launches, masks before launches
# 0, 8 and 16), on the card against the port's CPU render
GOLDEN_SAMPLING = dict(samples_in_flight=2, sampler="ld", coherent=0,
                       adaptive=True)
GOLDEN_ADAPTIVE = (0.1, 6.0)  # tau, least launches a pixel
FLOAT_LEAVES = ("importance", "origin", "direction", "accum", "sq")


def _leaf(state, name):
    """A PathState leaf as NumPy (k, P)."""
    v = getattr(state, name)
    v = torch.stack(v) if isinstance(v, tuple) else v
    return v.cpu().numpy().reshape(-1, state.count.shape[0])


def _states_agree(tag, got, want, launches):
    """The rule of tests/test_torch_sampling.py: count, path_no and
    bounce exact; the float leaves within rtol/atol 1e-4 on all but 0.1%
    of the lanes per launch; the image within the MC bound. Returns the
    share of lanes off and the MAD."""
    for name in ("count", "path_no", "bounce"):
        if not np.array_equal(_leaf(got, name), _leaf(want, name)):
            raise RuntimeError(f"{tag}: {name} differs")
    off = np.zeros(got.count.shape[0], bool)
    for name in FLOAT_LEAVES:
        off |= ~np.isclose(_leaf(got, name), _leaf(want, name), rtol=1e-4,
                           atol=1e-4).all(0)
    share = float(off.mean())
    log(f"[{tag}] count, path_no and bounce exact; {int(off.sum())} of "
        f"{off.size} lanes have a float leaf off 1e-4 ({share:.3g}, "
        f"allowed {0.001 * launches:.3g} after {launches} launches)")
    mad = _mc_agree(tag, *_state_np(got), *_state_np(want))
    if share > 0.001 * launches:
        raise RuntimeError(f"{tag}: {int(off.sum())} lanes off 1e-4")
    return share, mad


def phase_sampling(path, workdir, report):
    """The full scene through the CLI at 1920x1080, 2 spp, with
    SAMPLING_FLAGS: the launch counters equal EXPECTED_SAMPLING, every
    dispatch traces 2 x 2,088,960 lanes, some tile parks and the parked
    lanes' counts stay frozen; K2 and K4 against their plain walkers on
    the render's own rays (_sampling_kernels). Then the golden scene at
    96x48 with GOLDEN_SAMPLING on the card against the port's CPU render
    of the same arguments (_states_agree)."""
    from PIL import Image

    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.render import integrator as integ
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    out = os.path.join(workdir, "sponza_sampling.png")
    masks = []
    with Capture() as cap, mask_log(masks):
        code, r, times, launches, probes, _ = run_cli(
            [path, out, "--res", f"{RES[0]}x{RES[1]}", "--spp", str(SPP),
             "--seed", str(SEED), "--device", "cuda"] + SAMPLING_FLAGS,
            env=SAMPLING_ENV)
    if code != 0:
        raise RuntimeError(f"CLI exited {code}")
    _held_to("sampling", "sampling", launches, probes, EXPECTED_SAMPLING,
             report)
    want = 2 * integ.pixel_count(*RES)
    lanes = {int(c["o3"][0].shape[0]) for calls in cap.calls.values()
             for c in calls}
    if times["launches"] != SAMPLING_LAUNCHES or lanes != {want}:
        raise RuntimeError(f"sampling render: {times['launches']} launches, "
                           f"lane counts {sorted(lanes)}, expected "
                           f"{SAMPLING_LAUNCHES} of {want}")
    parked = [float(1.0 - m.float().mean()) for m, _, _ in masks]
    log(f"[sampling] {times['launches']} launches of {want} lanes; parked "
        f"share of lanes per chunk {parked}")
    count = r._state.count
    frozen = 0
    for m, count0, bounce0 in masks:
        if bool(m.all()):
            continue
        # lanes of a parked tile at a path boundary park at once: their
        # count stops (this is the last chunk that parks: the render ends
        # with it)
        at_rest = ~m & (bounce0 == 0)
        frozen = int(at_rest.sum())
        if m is masks[-1][0] and not bool(torch.equal(count[at_rest],
                                                      count0[at_rest])):
            raise RuntimeError("parked lanes kept counting")
    if not frozen or masks[-1][0].all():
        raise RuntimeError(f"no tile parked: parked shares {parked}")
    accum = torch.stack(r._state.accum)
    if not bool(torch.isfinite(accum).all()):
        raise RuntimeError("non-finite radiance in the sampling render")
    img = np.asarray(Image.open(out))
    if img.shape != (RES[1], RES[0], 3) or img.mean() < 5.0:
        raise RuntimeError(f"sampling PNG {img.shape}, mean {img.mean():.1f}")
    rays = RES[0] * RES[1] * 2 * times["launches"]
    log(f"[sampling] {out}: mean {img.mean():.1f}; {frozen} lanes parked at "
        f"rest in the last chunk; setup {times['setup']:.0f} ms, render "
        f"{times['render']:.0f} ms = {times['render'] / times['launches']:.1f} "
        f"ms per launch, {rays / times['render'] / 1e3:.3f} Mrays/s")
    numbers = {"setup_ms": times["setup"], "render_ms": times["render"],
               "launches": times["launches"], "lanes_per_launch": want,
               "ms_per_launch": times["render"] / times["launches"],
               "mrays_per_s": rays / times["render"] / 1e3,
               "parked_share_by_chunk": parked, "frozen_lanes": frozen,
               "image_mean": float(img.mean()), "kernel_launches": launches}
    del masks, count, accum
    numbers["parked_lanes_checked"] = _sampling_kernels(r.scene, cap, report)
    del r, cap
    torch.cuda.empty_cache()
    renders = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        g = RayTraceRenderer(ps.MatRowScene(), width=ps.GOLDEN_W,
                             height=ps.GOLDEN_H, seed=ps.GOLDEN_SEED,
                             device=dev, **GOLDEN_SAMPLING)
        g.adaptive_tau, g.adaptive_min = GOLDEN_ADAPTIVE
        g_masks = []
        with mask_log(g_masks):
            g.draw(ps.GOLDEN_SPP, return_image=False)
        shares = [float(1.0 - m.float().mean()) for m, _, _ in g_masks]
        log(f"[sampling] golden scene, sif 2, ld, coherent 0, adaptive "
            f"(tau {GOLDEN_ADAPTIVE[0]}, min {GOLDEN_ADAPTIVE[1]:g}), "
            f"{ps.GOLDEN_SPP} spp on {dev}: {time.perf_counter() - t0:.1f} s; "
            f"parked share per chunk {shares}")
        if not any(shares):
            raise RuntimeError(f"no golden tile parked on {dev}")
        renders[dev] = g
    share, mad = _states_agree("sampling:golden", renders["cuda"]._state,
                               renders["cpu"]._state,
                               renders["cuda"].launches(ps.GOLDEN_SPP))
    numbers.update(golden_lanes_off=share, golden_mad=mad,
                   golden_parked_by_chunk=shares)
    return numbers


# the second process of [resume]: the CLI in a fresh interpreter, printing
# its launch counts and times as JSON
RESUME_CHILD = """
import json, sys
from glaze_tpu_torch import cli
from glaze_tpu_torch.accel import traverse_cuda as tc
from glaze_tpu_torch.render import shade_cuda as shade
code, r, t = cli.run(sys.argv[1:])
print(json.dumps({"code": code, "times": t, "completed_spp": r.completed_spp,
                  "launches": [tc.closest_hit_soa.launches,
                               tc.any_hit_soa.launches,
                               tc.closest_hit_soa_masked.launches,
                               tc.any_hit_soa_masked.launches,
                               tc.closest_hit_fat_soa.launches,
                               tc.any_hit_fat_soa.launches,
                               shade.nee_kernel.launches,
                               shade.bsdf_kernel.launches,
                               shade.surface_kernel.launches]}))
"""


def phase_resume(paths, workdir, report):
    """Checkpoints on the card: the full scene through the CLI at
    1920x1080, one sample with --checkpoint, a second process resuming it
    to two, against a straight two-sample render (count exact, the largest
    accum difference logged); a checkpoint of the golden scene written by a
    CPU render resumed on the card against the stored golden; one render
    with --profile writing its trace."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.render.renderer import RayTraceRenderer
    from glaze_tpu_torch.utils.runtime import TRACE_FILE

    numbers = {}
    ck = os.path.join(workdir, "resume.npz")
    if os.path.exists(ck):
        os.unlink(ck)
    base = [paths["full"], "--res", f"{RES[0]}x{RES[1]}", "--seed", str(SEED),
            "--device", "cuda"]

    def argv(out, spp, *extra):
        return [base[0], os.path.join(workdir, out)] + base[1:] + [
            "--spp", str(spp), *extra]

    code, r, t1, launches, probes, _ = run_cli(argv("resume1.png", 1,
                                                    "--checkpoint", ck))
    if code != 0 or not os.path.exists(ck):
        raise RuntimeError(f"checkpointed render exited {code}")
    _held_to("resume:first", "resume", launches, probes, EXPECTED_RESUME,
             report)
    del r
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", RESUME_CHILD]
        + argv("resume2.png", 2, "--checkpoint", ck),
        cwd=HERE, capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise RuntimeError(f"resuming process exited {child.returncode}:\n"
                           f"{child.stderr[-3000:]}")
    res = json.loads(child.stdout.strip().splitlines()[-1])
    got = dict(zip(KERNELS, res["launches"]))
    log(f"[resume] second process ({child_s:.1f} s): "
        + "; ".join(line.strip() for line in
                    child.stderr.replace("\r", "\n").splitlines()
                    if line.strip() and not line.startswith("Rendering")))
    if res["code"] != 0 or "Resumed " not in child.stderr \
            or res["completed_spp"] != 2:
        raise RuntimeError(f"the second process did not resume: {res}")
    if got != EXPECTED_RESUME:
        raise RuntimeError(f"resumed render launched {got}, expected "
                           f"{EXPECTED_RESUME}")
    for name, n in got.items():
        if n:
            report[name]["launches"] += n
            report[name]["launches_by_path"]["resume"] += n
    code, straight, t2, launches, probes, _ = run_cli(argv("straight.png", 2))
    if code != 0:
        raise RuntimeError(f"straight render exited {code}")
    _held_to("resume:straight", "resume_straight", launches, probes,
             {k: 2 * n for k, n in EXPECTED_RESUME.items()}, report)
    data = np.load(ck)
    ck_accum = np.stack([data[f"leaf_{i}"] for i in (9, 10, 11)], -1)
    accum, count = _state_np(straight._state)
    if not np.array_equal(data["leaf_12"], count):
        raise RuntimeError("resumed count differs from the straight render")
    diff = float(np.abs(ck_accum - accum).max())
    log(f"[resume] resumed 1 + 1 spp against a straight 2-spp render: count "
        f"exact, largest accum difference {diff!r} (expected 0.0)")
    # what a save and a load of a 1080p checkpoint cost (the CLI's render
    # time holds its saves)
    tmp = os.path.join(workdir, "timed.npz")
    t0 = time.perf_counter()
    straight.save_checkpoint(tmp)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    straight.load_checkpoint(tmp)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[resume] a 1080p checkpoint: {os.path.getsize(tmp) / 1e6:.1f} MB, "
        f"save {save_s:.2f} s, load {load_s:.2f} s")
    numbers.update(first_render_ms=t1["render"], resumed_render_ms=res[
        "times"]["render"], straight_render_ms=t2["render"],
        second_process_s=child_s, max_accum_diff=diff,
        checkpoint_mb=os.path.getsize(tmp) / 1e6, save_s=save_s,
        load_s=load_s)
    del straight
    torch.cuda.empty_cache()
    # a CPU-written checkpoint of the golden scene resumes on the card
    g = np.load(GOLDEN)
    kw = dict(width=ps.GOLDEN_W, height=ps.GOLDEN_H, seed=ps.GOLDEN_SEED,
              coherent=1)
    ck_cpu = os.path.join(workdir, "golden_cpu.npz")
    cpu = RayTraceRenderer(ps.MatRowScene(), device="cpu", **kw)
    cpu.draw(ps.GOLDEN_SPP // 2, return_image=False)
    cpu.save_checkpoint(ck_cpu)
    gpu = RayTraceRenderer(ps.MatRowScene(), device="cuda", **kw)
    gpu.load_checkpoint(ck_cpu)
    if gpu._state.count.device.type != "cuda":
        raise RuntimeError("the checkpoint did not load onto the card")
    gpu.draw(ps.GOLDEN_SPP - ps.GOLDEN_SPP // 2, return_image=False)
    numbers["golden_resumed_mad"] = _mc_agree(
        "resume:golden", *_state_np(gpu._state), g["accum"], g["count"])
    # --profile
    prof = os.path.join(workdir, "profile")
    trace = os.path.join(prof, TRACE_FILE)
    if os.path.exists(trace):
        os.unlink(trace)
    code, r, t3, launches, probes, err = run_cli(
        [paths["opaque"], os.path.join(workdir, "profiled.png"), "--res",
         f"{RES[0]}x{RES[1]}", "--spp", "1", "--seed", str(SEED),
         "--device", "cuda", "--profile", prof])
    if code != 0 or "Phases: " not in err or "Profile trace written" not in err:
        raise RuntimeError(f"--profile render exited {code}")
    _held_to("resume:profile", "profile", launches, probes, EXPECTED_PROFILE,
             report)
    size = os.path.getsize(trace)
    log(f"[resume] --profile: {trace} ({size / 1e6:.1f} MB), render "
        f"{t3['render']:.0f} ms profiled")
    numbers.update(profile_trace_mb=size / 1e6, profiled_render_ms=t3["render"])
    del r
    return numbers


# [denoise]: the full scene's 2-spp render with --denoise. The G-buffer
# pass traces the camera rays once through trace_alpha (one alpha round on
# the full masked tree: the walk and one re-test round of K2)
EXPECTED_DENOISE = dict(EXPECTED_FULL,
                        closest_hit_masked=EXPECTED_FULL["closest_hit_masked"]
                        + 2)
# the G-buffer held card against CPU on the full scene at this size (the
# plain walkers on the CPU take seconds a 100k rays)
GBUFFER_RES = (320, 180)
# depth, normal and albedo, card against CPU. The walks agree with the
# plain walkers to 1 ulp in u and v ([kernels]), and a texture sample
# moves by that ulp times the texture's width in texels, so the albedo
# is held to the geometry's tolerance, not bit for bit
GUIDE_TOL = 1e-4


def _gbuffer_on(device, path, res):
    """The port's G-buffer of the scene at ``path`` on ``device`` for its
    own camera at ``res``, with the renderer's alpha rounds."""
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    r = RayTraceRenderer(parse(path), width=res[0], height=res[1], seed=SEED,
                         device=device)
    gb = r._gbuffer()
    return {k: torch.stack(v).cpu() if isinstance(v, tuple) else v.cpu()
            for k, v in gb.items()}


def phase_denoise(path, workdir, report):
    """The display denoiser on the card: the full scene through the CLI at
    1920x1080, 2 spp, with --denoise and --checkpoint against the same
    render without --denoise (launch counters, checkpoint and accumulation
    bit for bit, the PNGs differ); the G-buffer on the card against the
    CPU; denoised_display on the card against the CPU on the same state;
    the filter's time at 1080p."""
    from PIL import Image

    from glaze_tpu_torch.render import denoise as dn
    from glaze_tpu_torch.tools.common import card_line, cuda_ms

    numbers = {}
    runs = {}
    for label, extra in (("denoise", ["--denoise"]), ("raw", [])):
        ck = os.path.join(workdir, f"denoise_{label}.npz")
        if os.path.exists(ck):
            os.unlink(ck)
        out = os.path.join(workdir, f"sponza_{label}.png")
        code, r, times, launches, probes, _ = run_cli(
            [path, out, "--res", f"{RES[0]}x{RES[1]}", "--spp", str(SPP),
             "--seed", str(SEED), "--device", "cuda", "--checkpoint", ck]
            + extra)
        if code != 0:
            raise RuntimeError(f"{label} render exited {code}")
        _held_to(f"denoise:{label}", f"denoise_{label}", launches, probes,
                 EXPECTED_DENOISE if extra else EXPECTED_FULL, report)
        runs[label] = (r, np.asarray(Image.open(out)), dict(np.load(ck)),
                       times)
    (r, img, ck, times), (raw_r, raw_img, raw_ck, _) = runs["denoise"], runs["raw"]
    same_ck = sorted(ck) == sorted(raw_ck) and all(
        ck[k].dtype == raw_ck[k].dtype and np.array_equal(ck[k], raw_ck[k])
        for k in ck)
    same_state = all(torch.equal(a, b) for a, b in zip(
        r._leaves(), raw_r._leaves()))
    changed = float((img != raw_img).any(-1).mean())
    log(f"[denoise] --denoise render: {times['render']:.0f} ms render; "
        f"checkpoint {'equal' if same_ck else 'DIFFERENT'} and accumulation "
        f"{'equal' if same_state else 'DIFFERENT'} to the raw render's, bit "
        f"for bit; {changed:.1%} of the saved pixels differ from the raw "
        f"image (mean {img.mean():.1f} vs {raw_img.mean():.1f})")
    if not (same_ck and same_state) or img.shape != (RES[1], RES[0], 3) \
            or changed == 0.0:
        raise RuntimeError("--denoise changed the accumulation or the "
                           "checkpoint, or left the image raw")
    numbers.update(render_ms=times["render"], pixels_changed=changed)
    # the filter: card against CPU on the same state and G-buffer
    gb = r._gbuffer()
    inv, pw, ph = dn.lane_to_image(*RES, r.device)
    st = r._state
    kw = dict(pw=pw, ph=ph, sif=r.samples_in_flight,
              launches_per_spp=r.integrator.steps_per_sample)
    exposure = r._exposure()
    card = dn.denoised_display(st.accum, st.count, gb, inv, exposure, **kw)
    ms = cuda_ms(lambda: dn.denoised_display(st.accum, st.count, gb, inv,
                                             exposure, **kw), runs=5)

    def cpu(x):
        if isinstance(x, tuple):
            return tuple(v.cpu() for v in x)
        return x.cpu() if isinstance(x, torch.Tensor) else x

    host = dn.denoised_display(cpu(st.accum), cpu(st.count),
                               {k: cpu(v) for k, v in gb.items()}, inv.cpu(),
                               cpu(exposure), **kw)
    diff = (card.cpu().int() - host.int()).abs()
    differ = int((diff > 0).any(-1).sum())
    log(f"[denoise] denoised_display at {RES[0]}x{RES[1]} (4 iterations): "
        f"{ms:.2f} ms on the card ({card_line()}); card against CPU on the "
        f"same state: {differ} of {pw * ph} pixels differ, at most "
        f"{int(diff.max())} level")
    if int(diff.max()) > 1:
        raise RuntimeError("denoised_display: card and CPU more than one "
                           "level apart")
    numbers.update(filter_ms=ms, filter_pixels_differ=differ,
                   filter_max_level_diff=int(diff.max()))
    del runs, r, raw_r, gb, st, card, host
    torch.cuda.empty_cache()
    # the G-buffer: card against CPU for the same camera
    t0 = time.perf_counter()
    g_card = _gbuffer_on("cuda", path, GBUFFER_RES)
    g_cpu = _gbuffer_on("cpu", path, GBUFFER_RES)
    z_c, z_h = g_card["depth"], g_cpu["depth"]
    off = ((z_c - z_h).abs() > GUIDE_TOL * z_h.abs()) | (
        (g_card["normal"] - g_cpu["normal"]).abs() > GUIDE_TOL).any(0)
    # an exact-t tie: the same depth, another triangle's normal
    ties = off & (z_c == z_h)
    alb = (g_card["albedo"] - g_cpu["albedo"]).abs()
    log(f"[denoise] G-buffer at {GBUFFER_RES[0]}x{GBUFFER_RES[1]}, card "
        f"against CPU ({time.perf_counter() - t0:.1f} s): "
        f"{int((z_h < 1e8).sum())} of {z_h.numel()} lanes hit; "
        f"{int(off.sum())} off {GUIDE_TOL:g} in depth or normal, "
        f"{int(ties.sum())} of them exact-t ties; depth max "
        f"{float(((z_c - z_h).abs() / z_h.abs()).max()):.2e} relative; "
        f"albedo: {int((alb > 0).any(0).sum())} lanes differ, max "
        f"{float(alb.max()):.2e}")
    if int((off & ~ties).sum()) or float(alb.max()) > GUIDE_TOL:
        raise RuntimeError("the G-buffer on the card disagrees with the CPU")
    numbers.update(gbuffer_lanes_off=int(off.sum()),
                   gbuffer_ties=int(ties.sum()),
                   gbuffer_albedo_lanes_differ=int((alb > 0).any(0).sum()),
                   gbuffer_albedo_max_diff=float(alb.max()))
    return numbers


def _count_exact(tag, renderer, launches):
    """Every lane of the render counted each of its ``launches`` (the
    path state's ``count``; no lane parks without adaptive stopping)."""
    count = renderer._state.count
    if not bool((count == float(launches)).all()):
        raise RuntimeError(f"{tag}: count is not {launches} on every lane "
                           f"(min {float(count.min())}, max "
                           f"{float(count.max())})")


def phase_convert(full_path, workdir, report):
    """The converter on the card's machine: the Sponza-class scene written
    as Wavefront OBJ + MTL with PNG textures (glaze_tpu_torch.scenes
    write_obj: the curtain's lace as map_d, the ceiling panel's Ke), the
    .obj rendered through the CLI at 1920x1080, 2 spp, the conversion
    included. The parsed triangles and the MIXED alpha triangles equal
    those of the scene written directly (flattened here); the K2/K4
    counters equal the launches derived from the captured dispatches
    (one kernel a masked dispatch; EXPECTED_FULL); count is exact and the
    image finite and not black; K2 and K4 are held against their plain
    walkers on launch 0's camera and shadow rays."""
    import tempfile

    from PIL import Image

    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import converter
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.scene.flatten import flatten_scene_np

    t0 = time.perf_counter()
    scene = ps.SponzaScene()
    obj = ps.write_obj(scene, os.path.join(workdir, "sponza_obj"))
    write_s = time.perf_counter() - t0
    direct_tris = sum(len(m.indices) for m in scene.meshes()) // 3
    fields, _, _ = flatten_scene_np(parse(full_path))
    direct_mixed = int(fields["bvh_alpha.n_tris"])
    del fields
    log(f"[convert] {obj}: written in {write_s:.1f} s ({os.path.getsize(obj)}"
        f" bytes); the scene written directly has {direct_tris} triangles, "
        f"{direct_mixed} MIXED")
    out = os.path.join(workdir, "sponza_convert.png")
    conv_s = []
    real_convert = converter.convert

    def timed_convert(*a, **k):
        t = time.perf_counter()
        n = real_convert(*a, **k)
        conv_s.append(time.perf_counter() - t)
        return n

    converter.convert = timed_convert
    # the converted .glaze is cached in the temporary directory: keep it
    # in the work directory, emptied first (the .obj written above has a
    # new mtime, so an earlier run's cache file would never hit again)
    saved_tmp = tempfile.tempdir
    tempfile.tempdir = os.path.join(workdir, "tmp")
    shutil.rmtree(tempfile.tempdir, ignore_errors=True)
    os.makedirs(tempfile.tempdir)
    try:
        with Capture() as cap:
            code, r, times, launches, probes, _ = run_cli(
                [obj, out, "--res", f"{RES[0]}x{RES[1]}", "--spp", str(SPP),
                 "--seed", str(SEED), "--device", "cuda"])
    finally:
        converter.convert = real_convert
        tempfile.tempdir = saved_tmp
    if code != 0:
        raise RuntimeError(f"CLI exited {code} on the .obj")
    if len(conv_s) != 1:
        raise RuntimeError(f"the CLI converted {len(conv_s)} times")
    tris = sum(r.host.inst_tri_count)
    mixed = int(r.scene.bvh_alpha.n_tris) if r.scene.bvh_alpha else 0
    log(f"[convert] converted scene: {tris} triangles, {mixed} MIXED, "
        f"{len(r.host.materials)} materials, {len(r.host.lights)} lights")
    if tris != direct_tris or mixed != direct_mixed:
        raise RuntimeError(f"converted scene has {tris} triangles, {mixed} "
                           f"MIXED; written directly {direct_tris}, "
                           f"{direct_mixed}")
    calls = {k: len(v) for k, v in cap.calls.items()}
    derived = _expected(times["launches"],
                        closest_hit_masked=calls["closest_hit_soa_masked_auto"],
                        any_hit_masked=calls["any_hit_soa_masked_auto"])
    log(f"[convert] dispatches {calls}; {times['launches']} launches")
    if calls["closest_hit_soa_auto"] or calls["any_hit_soa_auto"] or \
            derived != EXPECTED_FULL:
        raise RuntimeError(f"converted render dispatched {calls}, expected "
                           f"{EXPECTED_FULL}")
    _held_to("convert", "convert", launches, probes, derived, report)
    _count_exact("convert", r, times["launches"])
    accum = torch.stack(r._state.accum)
    img = np.asarray(Image.open(out))
    lit = float((img.max(-1) > 0).mean())
    log(f"[convert] {out}: mean {img.mean():.2f}, {lit:.1%} of pixels lit")
    if not bool(torch.isfinite(accum).all()) or img.shape != (
            RES[1], RES[0], 3) or img.mean() < 1.0 or lit < 0.5:
        raise RuntimeError("the converted render is not finite or is black")
    setup_ms = times["setup"]
    ms_launch = times["render"] / times["launches"]
    log(f"[convert] conversion {conv_s[0]:.2f} s (in the setup); setup "
        f"{setup_ms:.0f} ms with it, {setup_ms - conv_s[0] * 1e3:.0f} ms "
        f"without; render {times['render']:.0f} ms = {ms_launch:.1f} ms per "
        f"launch")
    numbers = {"write_s": write_s, "conversion_s": conv_s[0],
               "setup_ms": setup_ms,
               "setup_ms_without_conversion": setup_ms - conv_s[0] * 1e3,
               "render_ms": times["render"], "ms_per_launch": ms_launch,
               "triangles": tris, "mixed": mixed, "image_mean":
               float(img.mean()), "lit_share": lit, "launches": launches}
    del accum
    numbers["profile"] = profile_sample(r, "convert")
    walk0 = next(c for c in cap.calls["closest_hit_soa_masked_auto"]
                 if c["bvh"] is r.scene.bvh and c["anyhits_before"] == 0)
    k2, k4 = report["closest_hit_masked"], report["any_hit_masked"]
    _check_closest(k2, "convert_camera", r.scene.bvh, walk0)
    _check_anyhit(k4, "convert_shadow", r.scene.bvh,
                  cap.calls["any_hit_soa_masked_auto"][0])
    _summarize(k2, ("camera", "bounce"))
    _summarize(k4, ("shadow_camera_hits", "shadow_bounce_hits"))
    del r, cap, walk0
    torch.cuda.empty_cache()
    return numbers


# [edit]: one sample (6 launches) after each edit of the full scene; the
# tables each edit leaves select the kernels: with the curtain's map the
# classic tree takes K2/K4 (EXPECTED_FULL) and the fat tree the
# opaque/alpha split (EXPECTED_FAT_FULL); without it K1/K3 and K7c/K7a
EXPECTED_EDIT = {
    ("classic", True): _expected(6, closest_hit_masked=4 * 6,
                                 any_hit_masked=6),
    ("classic", False): _expected(6, closest_hit=6, any_hit=6),
    ("fat", True): _expected(6, closest_hit=6, any_hit=6,
                             closest_hit_masked=4 * 6),
    ("fat", False): _expected(6, closest_hit_fat=6, any_hit_fat=6),
}


def _tables(renderer):
    from glaze_tpu_torch.scene.flatten import device_scene_to_numpy

    return device_scene_to_numpy(renderer.scene)


def phase_edit(full_path, report):
    """Scene edits on the card, on the classic and the fat tree: a
    1920x1080 renderer of the full scene renders one sample, then
    update_materials_and_lights removes the curtain's opacity map (render
    one sample) and puts it back (render one sample). After each edit the
    counters, set to 0 just before the render, equal EXPECTED_EDIT for the
    tables the edit left, and count is exact; after the round trip every
    table equals, bit for bit, that of a fresh renderer of the scene. Logs
    each rebuild's time."""
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    parsed = parse(full_path)
    with_map = parsed.materials()
    without = parse(full_path).materials()
    for m in without:
        m.opacity = 0
    numbers = {}
    for tree in ("classic", "fat"):
        with tree_env(None if tree == "classic" else tree):
            t0 = time.perf_counter()
            r = RayTraceRenderer(parsed, width=RES[0], height=RES[1],
                                 seed=SEED, device="cuda")
            torch.cuda.synchronize()
            setup_ms = (time.perf_counter() - t0) * 1e3
            steps = {}
            for label, mats in (("map", None), ("removed", without),
                                ("restored", with_map)):
                edit_ms = None
                if mats is not None:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r.update_materials_and_lights(mats, parsed.lights())
                    torch.cuda.synchronize()
                    edit_ms = (time.perf_counter() - t0) * 1e3
                has_map = label != "removed"
                _reset_counts()
                t0 = time.perf_counter()
                r.draw(1, return_image=False)
                render_ms = (time.perf_counter() - t0) * 1e3
                launches, probes = _launch_counts()
                _held_to(f"edit:{tree}:{label}", f"edit_{tree}_{label}",
                         launches, probes, EXPECTED_EDIT[(tree, has_map)],
                         report)
                _count_exact(f"edit:{tree}:{label}", r, 6)
                if r._alpha_rounds != (1 if has_map else 0) or (
                        r.scene.bvh_alpha is None) == has_map:
                    raise RuntimeError(f"edit:{tree}:{label}: alpha rounds "
                                       f"{r._alpha_rounds}, alpha tree "
                                       f"{r.scene.bvh_alpha is not None}")
                log(f"[edit] {tree} {label}: edit "
                    + ("-" if edit_ms is None else f"{edit_ms:.0f} ms")
                    + f", one sample {render_ms:.0f} ms "
                    f"({render_ms / 6:.1f} ms per launch)")
                steps[label] = {"edit_ms": edit_ms, "render_ms": render_ms,
                                "launches": launches}
            t0 = time.perf_counter()
            fresh = RayTraceRenderer(parsed, width=RES[0], height=RES[1],
                                     seed=SEED, device="cuda")
            torch.cuda.synchronize()
            fresh_ms = (time.perf_counter() - t0) * 1e3
            a, b = _tables(r), _tables(fresh)
            differ = sorted(set(a) ^ set(b)) + [
                k for k in sorted(set(a) & set(b))
                if np.asarray(a[k]).tobytes() != np.asarray(b[k]).tobytes()
                or np.shape(a[k]) != np.shape(b[k])]
            log(f"[edit] {tree}: after the round trip {len(a)} tables, "
                f"{len(differ)} differ from a fresh renderer's (built in "
                f"{fresh_ms:.0f} ms; the first renderer's setup "
                f"{setup_ms:.0f} ms)")
            if differ:
                raise RuntimeError(f"edit:{tree}: tables differ from a fresh "
                                   f"renderer's: {differ}")
            numbers[tree] = {"setup_ms": setup_ms, "fresh_ms": fresh_ms,
                             "steps": steps}
            del r, fresh, a, b
            torch.cuda.empty_cache()
    return numbers


# [interactive]: the app (python -m glaze_tpu_torch.app) on the full scene
# at 1920x1080, scale 1.0, with the script below. A command that changes
# something presents 8 frames (app.main's present), so the frames are: 1
# at start; frames 24; drag 8 and its present's 1; denoise on 8; frames
# 12; drag 8 and 1; raytrace off 8 (preview); frames 8 (preview);
# raytrace on 8; the material edit 8; frames 6. That is 85 path-traced
# launches (26 raw still, 8 raw drag, 43 temporal still, 8 temporal drag,
# by whether the camera moved since the last frame) and 16 preview
# frames. A launch of the full scene runs K2 four times and K4 once
# (EXPECTED_FULL); a preview frame traces the camera rays once with 4
# alpha rounds on the full masked tree: K2 five times. One gbuffer_pass
# runs (K2 twice: the walk and one alpha round), on the first frame after
# "denoise on", which continues the paths (ROADMAP F14); a temporal frame
# after a move or an edit takes its G-buffer from its own launch, and the
# still frames and get_image reuse it.
INTERACTIVE_SCRIPT = ("frames 24", "drag 0.5 0 8", "denoise on", "frames 12",
                      "drag 0.5 0 8", "raytrace off", "frames 8",
                      "raytrace on", "mat 1 diffuse 200 120 60", "frames 6",
                      "shot {shot}")
INTERACTIVE_FRAMES = {"raw still": 26, "raw drag": 8, "temporal still": 43,
                      "temporal drag": 8, "preview": 16}
PREVIEW_K2 = 5  # the walk and 4 alpha rounds
GBUFFER_K2 = 2  # the walk and 1 alpha round
INTERACTIVE_GBUFFER_PASSES = 1
# the preview card against CPU at this size (the plain walkers on the CPU)
PREVIEW_RES = (160, 90)
PREVIEW_OFF = 0.001  # share of pixels more than one level apart
VALID_FLIPS = 0.001  # share of pixels whose reprojection validity differs
FRAMESTATS_S = 1.2  # seconds of frames a kind's steady run lasts at least
# a drag of 0.004 rad moves the image ~8 pixels: most of the history
# reprojects (depth within 5%, normals agreeing)
VALID_SHARE = 0.5


class FrameLog:
    """Wraps RealtimeRenderer.draw_frame for a run: each frame's kind (the
    preview, or raw/temporal and still/drag: whether the path tracer's
    camera moved since its last frame), its host seconds and the fps
    FrameStats reports after it; keeps the renderer."""

    def __init__(self):
        from glaze_tpu_torch.render import realtime

        self.cls = realtime.RealtimeRenderer
        self.real = self.cls.draw_frame
        self.frames = []
        self.rr = None
        self._cam = None

    def __enter__(self):
        from glaze_tpu_torch.render import integrator as integ

        def draw_frame(rr, pipelined=False):
            self.rr = rr
            if rr.use_raytracer:
                rt = rr._rt
                c2w, _ = integ.camera_matrices(rt.camera, rt.width, rt.height)
                moved = self._cam is not None and not np.array_equal(
                    c2w, self._cam)
                self._cam = c2w
                kind = (("temporal" if rt.denoise else "raw")
                        + (" drag" if moved else " still"))
            else:
                kind = "preview"
            t0 = time.perf_counter()
            out = self.real(rr, pipelined)
            self.frames.append((kind, time.perf_counter() - t0,
                                rr.stats.fps))
            return out

        self.cls.draw_frame = draw_frame
        return self

    def __exit__(self, *exc):
        self.cls.draw_frame = self.real

    def by_kind(self):
        out = {}
        for kind, dt, fps in self.frames:
            k = out.setdefault(kind, {"frames": 0, "s": []})
            k["frames"] += 1
            k["s"].append(dt)
            k["fps"] = fps
        for k in out.values():
            k["ms_mean"] = 1e3 * statistics.mean(k["s"])
            k["ms_median"] = 1e3 * statistics.median(k["s"])
            del k["s"]
        return out


def _frame_profile(tag, kind, rr, step, n=3):
    """One frame kind in steady state: two frames to warm it, then frames
    timed on the host clock (the card idle after) for FRAMESTATS_S, so
    that FrameStats closes a window of its own, and ``n`` frames under
    torch.profiler. Returns ms per frame, the fps FrameStats reports,
    device busy ms and kernel launches per frame, and the traversal
    kernels' launches per frame."""
    from glaze_tpu_torch.render.realtime import FrameStats

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    rr.stats = FrameStats()
    frames = 0
    t0 = time.perf_counter()
    while frames < n or time.perf_counter() - t0 < FRAMESTATS_S:
        step()
        frames += 1
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / frames
    fps = rr.stats.fps
    kernels, walks = _device_kernels(lambda: [step() for _ in range(n)])
    busy = sum(v[0] for v in kernels.values()) / n
    launches = sum(v[1] for v in kernels.values()) / n
    trav = {name: c / n for name, (_, c) in walks.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:3]
    log(f"[{tag}] {kind}: {wall:.1f} ms per frame (host clock, {frames} "
        f"frames, pipelined), FrameStats {fps:.2f} fps, device busy "
        f"{busy:.1f} ms per frame "
        f"({100 * busy / wall:.0f}% of wall), {launches:.0f} kernel "
        f"launches per frame; traversal launches per frame {trav}; top: "
        + "; ".join(f"{name} {ms / n:.2f} ms" for name, (ms, _) in top))
    return {"ms_per_frame": wall, "fps": fps,
            "device_busy_ms_per_frame": busy,
            "kernel_launches_per_frame": launches,
            "traversal_launches_per_frame": trav}


def _app_session(path, workdir):
    """The app's script on the card; returns (the frame log, the
    renderer's counters, probe counters, seconds, the shot)."""
    import io

    from PIL import Image

    from glaze_tpu_torch import app

    shot = os.path.join(workdir, "interactive_shot.png")
    script = os.path.join(workdir, "interactive_script.txt")
    with open(script, "w") as f:
        f.write("\n".join(INTERACTIVE_SCRIPT).format(shot=shot) + "\nquit\n")
    err = io.StringIO()
    with FrameLog() as frames:
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            code = app.main([path, "--res", f"{RES[0]}x{RES[1]}", "--scale",
                             "1.0", "--script", script, "--out",
                             os.path.join(workdir, "interactive_view.png")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, probes = _launch_counts()
    for line in err.getvalue().splitlines():
        if line.startswith(">") or "fps" in line or "loaded" in line:
            log(f"  app: {line.strip()}")
    if code != 0:
        raise RuntimeError(f"the app exited {code}")
    return frames, launches, probes, seconds, np.asarray(Image.open(shot))


def _preview_card_cpu(rr):
    """The flat preview of the session's scene (its tables copied to the
    CPU) at PREVIEW_RES for the session's camera, on the card and on the
    CPU: pixels more than one level apart, at most PREVIEW_OFF of them."""
    from glaze_tpu_torch.render.preview import FlatPreviewRenderer
    from glaze_tpu_torch.scene.flatten import (device_scene_from_numpy,
                                               device_scene_to_numpy)

    t0 = time.perf_counter()
    cpu_scene = device_scene_from_numpy(
        device_scene_to_numpy(rr._rt.scene), "cpu")
    imgs = []
    for scene in (rr._rt.scene, cpu_scene):
        p = FlatPreviewRenderer(scene, camera=rr.camera(),
                                width=PREVIEW_RES[0], height=PREVIEW_RES[1])
        imgs.append(p.get_image().astype(np.int32))
    diff = np.abs(imgs[0] - imgs[1]).max(-1)
    off = float((diff > 1).mean())
    log(f"[interactive] preview at {PREVIEW_RES[0]}x{PREVIEW_RES[1]}, card "
        f"against CPU ({time.perf_counter() - t0:.1f} s): "
        f"{int((diff > 0).sum())} of {diff.size} pixels differ, "
        f"{int((diff > 1).sum())} by more than one level (bound "
        f"{PREVIEW_OFF:g} of the pixels), max {int(diff.max())}; image mean "
        f"{imgs[0].mean():.1f}")
    if off > PREVIEW_OFF or imgs[0].mean() < 5.0:
        raise RuntimeError("the preview on the card disagrees with the CPU")
    return {"pixels_differ": int((diff > 0).sum()),
            "pixels_off_1": int((diff > 1).sum()),
            "max_level_diff": int(diff.max())}


def _temporal_card_cpu(rr):
    """One temporal drag frame of the path tracer on the card, and its
    display recomputed on the CPU from the same inputs (the launch's state
    and G-buffer, the history and camera before it), by [denoise]'s rule:
    at most one level apart, but where the reprojection's validity test
    (a threshold on a bilinear mix of depths) falls the other way, counted
    and bounded by VALID_FLIPS."""
    from glaze_tpu_torch.render import denoise as dn
    from glaze_tpu_torch.render import integrator as integ

    rt = rr._rt
    rt.denoise = True
    for _ in range(2):
        rt.draw_frame(return_image=True)
    rr.look_around(0.004, 0.001)
    hist, prev = rt._dn_hist, rt._dn_prev
    card = rt.draw_frame(return_image=True)
    st, gb = rt._state, rt._gb
    w, h = rt.width, rt.height
    inv, pw, ph = dn.lane_to_image(w, h, "cpu")

    def cpu(x):
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(cpu(v) for v in x)
        return x.cpu() if isinstance(x, torch.Tensor) else x

    t0 = time.perf_counter()
    kw = dict(width=w, height=h, pw=pw, ph=ph,
              is_persp=rt.camera.is_perspective,
              launches_per_spp=rt.integrator.steps_per_sample)
    host, _ = dn.denoised_display_temporal(
        cpu(st.accum), cpu(st.count), cpu(gb), cpu(hist), prev, inv,
        cpu(rt._exposure()), **kw)
    host_s = time.perf_counter() - t0

    def valid(gbuf, hst, lane_map):
        planes = {k: tuple(c[lane_map].reshape(ph, pw) for c in gbuf[k])
                  for k in ("wpos", "normal")}
        return dn._reproject(hst, planes, prev, width=w, height=h, pw=pw,
                             ph=ph, is_persp=rt.camera.is_perspective)[2]

    card_valid = valid(gb, hist, inv.to(rt.device)).cpu()
    share = float(card_valid[:h, :w].float().mean())
    flips = (card_valid != valid(cpu(gb), cpu(hist), inv))[:h, :w]
    diff = (card.cpu().int() - host.int()).abs()[:h, :w].amax(-1)
    beyond = (diff > 1) & ~flips
    log(f"[interactive] temporal drag frame at {w}x{h}, card against CPU "
        f"on the same inputs (CPU {host_s:.1f} s): {int((diff > 0).sum())} "
        f"of {diff.numel()} pixels differ, {int((diff > 1).sum())} by more "
        f"than one level; {int(flips.sum())} pixels' reprojection validity "
        f"differs (bound {VALID_FLIPS:g} of the pixels); {int(beyond.sum())}"
        f" pixels more than one level apart elsewhere; the history is valid "
        f"on {share:.3f} of the pixels (at least {VALID_SHARE})")
    if int(beyond.sum()) or float(flips.float().mean()) > VALID_FLIPS:
        raise RuntimeError("the temporal display on the card disagrees with "
                           "the CPU")
    if share < VALID_SHARE:
        raise RuntimeError("a small drag left the history mostly invalid")
    return {"pixels_differ": int((diff > 0).sum()),
            "pixels_off_1": int((diff > 1).sum()),
            "validity_flips": int(flips.sum()), "valid_share": share}


def _pipelined_blocking(path):
    """Two RealtimeRenderers of the scene at 1920x1080 with one seed, one
    pipelined and one blocking: get_image equal bit for bit after the same
    launches, and the pipelined present FRAMES_IN_FLIGHT launches late."""
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.realtime import (FRAMES_IN_FLIGHT,
                                                 RealtimeRenderer)

    a = RealtimeRenderer(parse(path), width=RES[0], height=RES[1], seed=SEED,
                         device="cuda")
    b = RealtimeRenderer(parse(path), width=RES[0], height=RES[1], seed=SEED,
                         device="cuda")
    n = 3 + FRAMES_IN_FLIGHT
    shown = []
    for _ in range(n):
        last = a.draw_frame(pipelined=True)
        shown.append(b.draw_frame())
    same = np.array_equal(a.get_image(), b.get_image())
    lag = np.array_equal(last, shown[n - FRAMES_IN_FLIGHT - 1])
    log(f"[interactive] pipelined against blocking after {n} launches at "
        f"{RES[0]}x{RES[1]}: get_image {'equal' if same else 'DIFFERENT'} bit "
        f"for bit; the pipelined present is "
        f"{'launch ' + str(n - FRAMES_IN_FLIGHT) if lag else 'NOT the launch'}"
        f" {FRAMES_IN_FLIGHT} behind")
    if not (same and lag):
        raise RuntimeError("pipelined frames differ from blocking ones")
    del a, b
    torch.cuda.empty_cache()


def phase_interactive(path, workdir, report):
    """The interactive path on the card: the app's script on the full scene
    at 1920x1080 (INTERACTIVE_SCRIPT), ms per frame of each kind and the
    fps FrameStats reports; the launch counters, set to 0 just before the
    app and read just after, exactly those of the frames drawn (and no
    gbuffer_pass); each kind profiled in steady state; K2 and K4 against
    their plain walkers on one tile-coherent drag launch; pipelined
    against blocking; the preview and a temporal drag frame card against
    CPU."""
    from glaze_tpu_torch.render import denoise as dn
    from glaze_tpu_torch.render import integrator as integ
    from glaze_tpu_torch.tools.common import cuda_ms

    gb_passes = []
    real_gb = dn.gbuffer_pass

    def counted_gb(*a, **k):
        gb_passes.append(1)
        return real_gb(*a, **k)

    dn.gbuffer_pass = counted_gb
    try:
        frames, launches, probes, seconds, shot = _app_session(path, workdir)
    finally:
        dn.gbuffer_pass = real_gb
    kinds = frames.by_kind()
    counts = {k: v["frames"] for k, v in kinds.items()}
    log(f"[interactive] app script: {len(frames.frames)} frames in "
        f"{seconds:.1f} s (setup and PNG writes included): {counts}; "
        f"gbuffer_pass calls {len(gb_passes)}")
    if counts != INTERACTIVE_FRAMES or \
            len(gb_passes) != INTERACTIVE_GBUFFER_PASSES:
        raise RuntimeError(f"the script drew {counts}, expected "
                           f"{INTERACTIVE_FRAMES}, and {len(gb_passes)} "
                           "G-buffer passes")
    pt = sum(n for k, n in counts.items() if k != "preview")
    expected = _expected(
        pt, closest_hit_masked=(4 * pt + PREVIEW_K2 * counts["preview"]
                            + GBUFFER_K2 * len(gb_passes)),
        any_hit_masked=pt)
    _held_to("interactive", "interactive", launches, probes, expected,
             report)
    for kind, v in kinds.items():
        log(f"[interactive] {kind}: {v['frames']} frames, "
            f"{v['ms_mean']:.1f} ms per frame mean, {v['ms_median']:.1f} "
            f"median (host clock of draw_frame, pipelined); FrameStats fps "
            f"{v['fps']:.2f} after the last")
    if shot.shape != (RES[1], RES[0], 3) or shot.mean() < 5.0:
        raise RuntimeError(f"the shot has shape {shot.shape}, mean "
                           f"{shot.mean():.1f}")
    rr = frames.rr
    rt = rr._rt
    if rr.coherent != 2:
        raise RuntimeError(f"interactive coherent mode {rr.coherent}")
    numbers = {"frames": kinds, "seconds": seconds, "launches": launches}
    zero_ms = cuda_ms(rt._zero_state, runs=5)
    # what a present-time unswizzle on the host would cost this thread per
    # frame (RealtimeRenderer unswizzles on the device behind the launch)
    rt.denoise = False
    lanes = rt.draw_frame(return_image=True).cpu().numpy()
    px, py = integ.pixel_coords_np(*RES)
    pw, _ = integ.padded_dims(*RES)
    inv = np.empty(px.shape[0], np.int64)
    inv[py.astype(np.int64) * pw + px] = np.arange(px.shape[0])
    t0 = time.perf_counter()
    for _ in range(5):
        lanes[inv]
    host_ms = (time.perf_counter() - t0) * 1e3 / 5
    log(f"[interactive] a restart's zero state at {RES[0]}x{RES[1]}: "
        f"{zero_ms:.3f} ms on the card; a host unswizzle of the frame's "
        f"{lanes.shape[0]} lanes (NumPy gather): {host_ms:.1f} ms")
    numbers.update(zero_state_ms=zero_ms, host_unswizzle_ms=host_ms)

    def moved():
        rr.look_around(0.002, 0.0)
        rr.draw_frame(pipelined=True)

    profiles = {}
    for kind, denoise, ray, step in (
            ("raw still", False, True, None), ("raw drag", False, True, moved),
            ("temporal still", True, True, None),
            ("temporal drag", True, True, moved),
            ("preview", False, False, None)):
        rr.denoise, rr.use_raytracer = denoise, ray
        profiles[kind] = _frame_profile(
            "interactive", kind, rr,
            step or (lambda: rr.draw_frame(pipelined=True)))
    numbers["profile"] = profiles
    # K2 and K4 on the rays of one tile-coherent drag launch
    rr.denoise, rr.use_raytracer = False, True
    rr.look_around(0.003, 0.0)
    with Capture() as cap:
        rt.draw_frame()
    torch.cuda.synchronize()
    walk = next(c for c in cap.calls["closest_hit_soa_masked_auto"]
                if c["bvh"] is rt.scene.bvh)
    k2, k4 = report["closest_hit_masked"], report["any_hit_masked"]
    _check_closest(k2, "interactive_drag", rt.scene.bvh, walk)
    _check_anyhit(k4, "interactive_drag_shadow", rt.scene.bvh,
                  cap.calls["any_hit_soa_masked_auto"][0])
    _summarize(k2, ("camera", "bounce"))
    _summarize(k4, ("shadow_camera_hits", "shadow_bounce_hits"))
    del cap, walk
    numbers["temporal_card_cpu"] = _temporal_card_cpu(rr)
    numbers["preview_card_cpu"] = _preview_card_cpu(rr)
    del frames, rr, rt
    torch.cuda.empty_cache()
    _pipelined_blocking(path)
    return numbers


def phase_viewer(path, report):
    """The browser viewer on the card: viewer.serve on port 0 around a
    RealtimeRenderer of the full scene at 1920x1080, scale 0.5 (the
    viewer's default); the frame endpoint fetched several times, the stats
    endpoint until spp advances, a camera control posted and the frame
    sequence seen to advance with the camera moved; then shut down and the
    render thread joined. The counters, set to 0 just before the server
    starts and read after the join, equal those of the frames the render
    loop drew."""
    import io
    import threading
    import urllib.request

    from PIL import Image

    from glaze_tpu_torch import viewer
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.realtime import FrameStats, RealtimeRenderer

    scale = 0.5
    t0 = time.perf_counter()
    rr = RealtimeRenderer(parse(path), width=RES[0], height=RES[1],
                          render_scale=scale, device="cuda")
    setup_s = time.perf_counter() - t0
    w, h = rr._rt.width, rr._rt.height
    died = []
    hook = threading.excepthook
    threading.excepthook = lambda a: died.append(repr(a.exc_value))

    def get(url):
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.headers.get("Content-Type", ""), r.read()

    with FrameLog() as frames:
        _reset_counts()
        srv, state, t = viewer.serve(rr, host="127.0.0.1", port=0)
        st = threading.Thread(target=srv.serve_forever, daemon=True)
        st.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            for _ in range(3):
                ctype, body = get(url + "/frame")
                img = np.asarray(Image.open(io.BytesIO(body)))
                if ctype != "image/jpeg" or img.shape != (h, w, 3):
                    raise RuntimeError(f"/frame gave {ctype} {img.shape}")
            s0 = json.loads(get(url + "/stats")[1])
            deadline = time.time() + 120
            while True:
                s1 = json.loads(get(url + "/stats")[1])
                if s1["spp"] > s0["spp"] or time.time() > deadline:
                    break
                time.sleep(0.05)
            if s1["spp"] <= s0["spp"] or s1["mode"] != "pt":
                raise RuntimeError(f"/stats did not advance: {s0} -> {s1}")
            cam0 = np.asarray(rr.camera().inner.position, float).copy()
            seq0 = state.seq
            req = urllib.request.Request(
                url + "/control", method="POST",
                data=json.dumps({"action": "advance", "value": 1}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                if r.status != 204:
                    raise RuntimeError(f"/control answered {r.status}")
            seq = seq0
            for _ in range(3):
                _, seq = state.wait_frame(seq, timeout=120)
            cam1 = np.asarray(rr.camera().inner.position, float)
            if seq < seq0 + 3 or np.allclose(cam0, cam1):
                raise RuntimeError("the control did not move the camera or "
                                   "the frames stopped")
            # follow the frames as a stream client does (one fetch per
            # published frame) until FrameStats closed a window; fetching
            # as fast as possible would starve the render thread of the
            # interpreter lock
            rr.stats = FrameStats()
            t1 = time.perf_counter()
            fetched = 0
            while time.perf_counter() - t1 < 2 * FRAMESTATS_S:
                _, seq = state.wait_frame(seq, timeout=120)
                get(url + "/frame")
                fetched += 1
            fps = rr.stats.fps
        finally:
            with state.cond:
                state.running = False
                state.cond.notify_all()
            srv.shutdown()
            srv.server_close()
            t.join(timeout=120)
            st.join(timeout=60)
            threading.excepthook = hook
        torch.cuda.synchronize()
        launches, probes = _launch_counts()
    if t.is_alive() or st.is_alive() or died:
        raise RuntimeError(f"viewer threads: render alive {t.is_alive()}, "
                           f"server alive {st.is_alive()}, died {died}")
    kinds = frames.by_kind()
    n = len(frames.frames)
    if set(kinds) - {"raw still", "raw drag"}:
        raise RuntimeError(f"the viewer drew {kinds}")
    _held_to("viewer", "viewer", launches, probes,
             _expected(n, closest_hit_masked=4 * n, any_hit_masked=n), report)
    ms = statistics.median(dt for _, dt, _ in frames.frames) * 1e3
    log(f"[viewer] {w}x{h} (scale {scale}), setup {setup_s:.1f} s: {n} "
        f"frames, {ms:.1f} ms per draw_frame median (render thread; the "
        f"JPEG publish not included), FrameStats {fps:.2f} fps while "
        f"{fetched} frames were fetched; stats spp {s0['spp']} -> "
        f"{s1['spp']}; frame sequence {seq0} -> {seq} after the control; "
        f"render thread joined")
    numbers = {"frames": n, "ms_per_frame_median": ms, "fps": fps,
               "setup_s": setup_s, "launches": launches}
    del rr, frames, srv, state
    torch.cuda.empty_cache()
    return numbers


# ---------------------------------------------------------------------------
# The chunked forest ([chunked]), the BVH disk cache ([cache]), rendering
# over a device mesh ([mesh]) and over two processes ([distributed]).

GRID_TRIS = 1_049_760  # glaze_tpu_torch.scenes.SponzaGridScene
SMALL_CHUNKS = 100_000  # the chunk limit [chunked] sets for the 262k scene


def _n_chunks(tree):
    """Chunks of a forest, 1 for a single tree."""
    return len(getattr(tree, "chunks", ())) or 1


def _expected_full(scene, launches):
    """The launches of the full masked path (EXPECTED_FULL's rule) on
    ``scene``, where every walk of a forest launches once per chunk: per
    launch the closest trace runs K2 twice on the main tree, the occlusion
    K4 once on it and K2 twice on the alpha tree."""
    c, ca = _n_chunks(scene.bvh), _n_chunks(scene.bvh_alpha)
    return _expected(launches,
                     closest_hit_masked=(2 * c + 2 * ca) * launches,
                     any_hit_masked=c * launches)


def _expected_split(scene, launches):
    """The opaque/alpha split path (EXPECTED_FAT_FULL's rule), per chunk:
    K1 on the opaque tree and K2 twice on the alpha tree for the closest
    trace, K3 on the opaque tree and K2 twice on the alpha tree for the
    occlusion."""
    co, ca = _n_chunks(scene.bvh_opaque), _n_chunks(scene.bvh_alpha)
    return _expected(launches, closest_hit=co * launches,
                     any_hit=co * launches,
                     closest_hit_masked=4 * ca * launches)


def _image_ok(tag, out, state):
    """The render's radiance finite, its PNG 1920x1080 and not flat."""
    from PIL import Image

    if not bool(torch.isfinite(torch.stack(state.accum)).all()):
        raise RuntimeError(f"{tag}: non-finite radiance")
    img = np.asarray(Image.open(out))
    if img.shape != (RES[1], RES[0], 3):
        raise RuntimeError(f"{tag}: PNG has shape {img.shape}")
    if img.mean() < 5.0 or img.std() < 2.0:
        raise RuntimeError(f"{tag}: PNG looks black or flat: mean "
                           f"{img.mean():.1f}")
    return float(img.mean())


def _grid_render(label, path, workdir, report, capture=None):
    """The CLI on the 1M-triangle scene at 1920x1080, 2 spp, its counters
    held to the full masked path's per chunk; returns (renderer, numbers)."""
    out = os.path.join(workdir, f"sponza_{label}.png")
    with capture or contextlib.nullcontext():
        code, r, times, launches, probes, _ = run_cli([
            path, out, "--res", f"{RES[0]}x{RES[1]}", "--spp", str(SPP),
            "--seed", str(SEED)])
    if code != 0:
        raise RuntimeError(f"{label}: CLI exited {code}")
    scene = r.scene
    if scene.bvh.n_tris != GRID_TRIS or scene.bvh_alpha is None:
        raise RuntimeError(f"{label}: {scene.bvh.n_tris} triangles")
    _held_to(f"chunked:{label}", label, launches, probes,
             _expected_full(scene, LAUNCHES), report)
    mean = _image_ok(label, out, r._state)
    ms = times["render"] / times["launches"]
    log(f"[chunked:{label}] {_n_chunks(scene.bvh)} chunk(s) of "
        f"{[c.n_tris for c in getattr(scene.bvh, 'chunks', [scene.bvh])]} "
        f"triangles; image mean {mean:.1f}; setup {times['setup']:.0f} ms, "
        f"{ms:.1f} ms per launch")
    return r, {"chunks": _n_chunks(scene.bvh), "setup_ms": times["setup"],
               "render_ms": times["render"], "ms_per_launch": ms,
               "image_mean": mean, "launches": launches}


def _chunks_closest(entry, label, forest, s):
    """K2 against its plain walker on each chunk of ``forest`` in turn, each
    chunk under the cap the earlier ones left (the best t so far), as the
    chunked dispatch walks them. Returns the hits of each chunk and the
    merges: hits of a later chunk that replaced an earlier chunk's."""
    from glaze_tpu_torch.accel import traverse_cuda as tc

    cap = best = s["t_max"]
    hits, merges, found = [], 0, None
    for i, chunk in enumerate(forest.chunks):
        _check_closest(entry, f"{label}_chunk{i}", chunk, dict(s, t_max=cap))
        h = tc.closest_hit_soa_masked(chunk, s["o3"], s["d3"], cap)
        hit = h["tri"] >= 0
        hits.append(int(hit.sum()))
        if found is not None:
            merges += int((hit & found).sum())
        found = hit if found is None else found | hit
        best = h["t"] if best is None else torch.where(hit, h["t"], best)
        cap = best
    log(f"[chunked] {label}: hits by chunk {hits}, {merges} merges (a later "
        "chunk's hit replaced an earlier one's)")
    return hits, merges


def _chunks_any(entry, label, forest, s):
    """K4 against its plain walker on each chunk in turn, each chunk for
    the rays the earlier ones left unblocked."""
    from glaze_tpu_torch.accel import traverse_cuda as tc

    act = s["active"]
    walked, blocked = [], []
    for i, chunk in enumerate(forest.chunks):
        walked.append(int(act.sum()))
        if not walked[-1]:
            log(f"[kernels] {entry['name']} {label}_chunk{i}: every ray "
                "blocked in the earlier chunks, nothing to compare")
            blocked.append(0)
            continue
        _check_anyhit(entry, f"{label}_chunk{i}", chunk, dict(s, active=act))
        b, _ = tc.any_hit_soa_masked(chunk, s["o3"], s["d3"], s["t_max"],
                                     t_min=s["t_min"], active=act)
        blocked.append(int((b & act).sum()))
        act = act & ~b
    log(f"[chunked] {label}: rays walked by chunk {walked}, blocked by "
        f"chunk {blocked}")
    return walked, blocked


def _forest_against_tree(label, forest, f_order, tree, t_order, closest,
                         anyhit):
    """The chunked dispatch against one tree of the same triangles (both
    carrying the same cell masks) on the captured rays: the SOURCE triangle
    of every hit the same (each tree's leaf order maps it back) except
    exact-t ties, which are counted; t, u, v the same bits and mixed the
    same where the source triangle is; blocked and pending exact."""
    import glaze_tpu_torch.accel as accel

    fo = torch.from_numpy(f_order.astype(np.int64)).cuda()
    to = torch.from_numpy(t_order.astype(np.int64)).cuda()

    def source(tri, order):
        return torch.where(tri >= 0, order[tri.clamp(min=0).long()], -1)

    ties = 0
    for name, s in closest:
        a = accel.closest_hit_soa_masked_auto(forest, s["o3"], s["d3"],
                                              s["t_max"])
        b = accel.closest_hit_soa_masked_auto(tree, s["o3"], s["d3"],
                                              s["t_max"])
        same = source(a["tri"], fo) == source(b["tri"], to)
        tie = ~same & (a["t"] == b["t"])
        bits = all(bool((a[k][same].view(torch.int32)
                         == b[k][same].view(torch.int32)).all())
                   for k in ("t", "u", "v"))
        n_bad = int((~same & ~tie).sum() + (same & (a["mixed"] != b["mixed"]))
                    .sum())
        ties += int(tie.sum())
        log(f"[chunked:{label}] {name}: {int((b['tri'] >= 0).sum())} hits, "
            f"{n_bad} rays apart, {int(tie.sum())} exact-t ties (counted), "
            f"t/u/v bits equal where the source triangle is: {bits}")
        if n_bad or not bits:
            raise RuntimeError(f"{label}: the forest disagrees with one tree "
                               f"on {name} rays")
    for name, s in anyhit:
        kw = dict(t_min=s["t_min"], active=s["active"])
        a = accel.any_hit_soa_masked_auto(forest, s["o3"], s["d3"],
                                          s["t_max"], **kw)
        b = accel.any_hit_soa_masked_auto(tree, s["o3"], s["d3"], s["t_max"],
                                          **kw)
        n_bad = int((a[0] != b[0]).sum() + (a[1] != b[1]).sum())
        log(f"[chunked:{label}] {name}: {int(b[0].sum())} blocked, "
            f"{int(b[1].sum())} pending, {n_bad} rays apart")
        if n_bad:
            raise RuntimeError(f"{label}: the forest disagrees with one tree "
                               f"on {name} rays")
    return ties


def _chunk_limit(n):
    """CHUNK_MAX_TRIS set to ``n`` inside the block (None: unchanged)."""
    from glaze_tpu_torch.accel import bvh as B

    @contextlib.contextmanager
    def block():
        saved = B.CHUNK_MAX_TRIS
        B.CHUNK_MAX_TRIS = saved if n is None else n
        try:
            yield
        finally:
            B.CHUNK_MAX_TRIS = saved
    return block()


def _render_small(path, tree, limit, spp=1, capture=None):
    """A 1920x1080 renderer of ``path`` under GLAZE_TREE=``tree`` and chunk
    limit ``limit``, ``spp`` samples drawn with the counters set to 0 just
    before (inside ``capture`` where given); returns (renderer, launches,
    probe launches, setup ms)."""
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    with tree_env(tree), _chunk_limit(limit):
        t0 = time.perf_counter()
        r = RayTraceRenderer(parse(path), width=RES[0], height=RES[1],
                             seed=SEED, device=torch.device("cuda"))
        setup = (time.perf_counter() - t0) * 1e3
    _reset_counts()
    with capture or contextlib.nullcontext():
        r.draw(spp, return_image=False)
    torch.cuda.synchronize()
    launches, probes = _launch_counts()
    return r, launches, probes, setup


# A view of the 1M scene from outside the grid, down the -z facades of the
# z = 0 row: the near atrium (x > 13) is chunk 1 and the far one chunk 0,
# and a ray that meets the near facade runs on into the far atrium, so the
# chunk-0 walk finds a hit that the chunk-1 walk then replaces. The CLI's
# camera sits inside the first atrium, where no ray reaches chunk 1.
GRID_OUTSIDE = dict(position=[50.0, 8.0, -20.0], target=[0.0, 3.0, -5.0],
                    up=[0.0, 1.0, 0.0])


def _outside_view(r):
    """``r`` pointed at GRID_OUTSIDE and one sample drawn; returns the
    closest and any-hit calls on its main tree of the sample's first
    launches."""
    from glaze_tpu_torch.core import Camera, PerspectiveCam

    r.update_camera(Camera.Perspective(PerspectiveCam(**GRID_OUTSIDE)))
    with Capture(limit=5) as cap:
        r.draw(1, return_image=False)
    torch.cuda.synchronize()
    return _tree_calls(cap, r.scene.bvh)


def _tree_calls(cap, tree):
    """(closest, any-hit) captured calls on ``tree``: the closest ones of
    the camera and bounce traces (no cap), and the shadow rays'."""
    closest = [c for c in cap.calls["closest_hit_soa_masked_auto"]
               if c["bvh"] is tree and c["t_max"] is None]
    anyhit = [c for c in cap.calls["any_hit_soa_masked_auto"]
              if c["bvh"] is tree]
    if len(closest) < 2 or len(anyhit) < 2:
        raise RuntimeError(f"captured {len(closest)} closest and "
                           f"{len(anyhit)} any-hit calls on the tree")
    return closest, anyhit


def phase_chunked(paths, workdir, report):
    """The chunked forest on the card.

    The Sponza-class scene four times over in a 2x2 grid of instances
    (1,049,760 triangles, lace maps on) builds a 2-chunk main tree carrying
    the cell masks. Its CLI render at 1920x1080, 2 spp: counters exact with
    K2 and K4 launched once per chunk; K2 and K4 against their plain
    walkers chunk by chunk on the render's camera, bounce and shadow rays;
    the same render with the chunk limit raised in-process (one tree); the
    forest's dispatch against that tree on the same rays. Then the 262k
    scene with a chunk limit of 100,000: the full scene on the classic tree
    (a 4-chunk main tree) and under GLAZE_TREE=hybrid (chunked opaque
    subset), and the opaque scene under hybrid (a chunked any-hit tree), one
    sample each, against the same render unchunked: count exact, accum
    within the MC bound (ROADMAP F4)."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.accel import ChunkedBVH

    numbers = {}
    t0 = time.perf_counter()
    grid = os.path.join(workdir, "sponza_grid.glaze")
    ps.write_glaze(ps.SponzaGridScene(), grid)
    paths["grid"] = grid
    log(f"[chunked] wrote {grid} ({os.path.getsize(grid)} bytes) in "
        f"{time.perf_counter() - t0:.1f} s")
    # launch 0's four masked closest calls and launch 1's first
    cap = Capture(limit=5)
    r, numbers["grid_chunked"] = _grid_render("grid_chunked", grid, workdir,
                                              report, cap)
    forest = r.scene.bvh
    if not isinstance(forest, ChunkedBVH) or len(forest.chunks) != 2:
        raise RuntimeError(f"the 1M scene built {_n_chunks(forest)} chunks")
    closest, anyhit = _tree_calls(cap, forest)
    sets_c = (("grid_camera", closest[0]), ("grid_bounce", closest[1]))
    sets_a = (("grid_shadow_camera_hits", anyhit[0]),
              ("grid_shadow_bounce_hits", anyhit[1]))
    for label, s in sets_c:
        _chunks_closest(report["closest_hit_masked"], label, forest, s)
    for label, s in sets_a:
        _chunks_any(report["any_hit_masked"], label, forest, s)
    numbers["grid_chunked"]["profile"] = profile_sample(r, "grid_chunked")
    # the view from outside, where the chunks merge
    closest, anyhit = _outside_view(r)
    out_c = (("grid_outside_camera", closest[0]),
             ("grid_outside_bounce", closest[1]))
    out_a = (("grid_outside_shadow_camera_hits", anyhit[0]),
             ("grid_outside_shadow_bounce_hits", anyhit[1]))
    hits, merges = _chunks_closest(report["closest_hit_masked"],
                                   out_c[0][0], forest, out_c[0][1])
    _chunks_closest(report["closest_hit_masked"], out_c[1][0], forest,
                    out_c[1][1])
    if min(hits) == 0 or merges == 0:
        raise RuntimeError(f"the outside view's camera rays hit the chunks "
                           f"{hits} times with {merges} merges: it does not "
                           "reach both chunks")
    blocked_late = 0
    for label, s in out_a:
        walked, blocked = _chunks_any(report["any_hit_masked"], label,
                                      forest, s)
        blocked_late += blocked[1]
    if blocked_late == 0:
        raise RuntimeError("no shadow ray of the outside view was blocked "
                           "in chunk 1")
    for name in ("closest_hit_masked", "any_hit_masked"):
        e = report[name]
        e["max_abs_err"] = max(v["max_abs_err"] for v in e["sets"].values())
    numbers["grid_outside"] = {"hits_by_chunk": hits, "merges": merges,
                               "shadow_blocked_in_chunk1": blocked_late}
    numbers["grid_outside"]["profile_chunked"] = profile_sample(
        r, "grid_outside_chunked")
    with _chunk_limit(2 * GRID_TRIS):
        r1, numbers["grid_single"] = _grid_render("grid_single", grid,
                                                  workdir, report)
    if _n_chunks(r1.scene.bvh) != 1:
        raise RuntimeError("the raised chunk limit still chunked the scene")
    numbers["grid_single"]["profile"] = profile_sample(r1, "grid_single")
    ties = _forest_against_tree(
        "grid", forest, r.host.tri_order, r1.scene.bvh, r1.host.tri_order,
        sets_c + out_c, sets_a + out_a)
    r1.update_camera(r.camera)
    numbers["grid_outside"]["profile_single"] = profile_sample(
        r1, "grid_outside_single")
    numbers["grid_ties"] = ties
    del r, r1, cap, closest, anyhit, sets_c, sets_a, out_c, out_a, forest
    torch.cuda.empty_cache()

    for label, scene, tree, walked in (
            ("full", "full", None, "bvh"),
            ("full_hybrid", "full", "hybrid", "bvh_opaque"),
            ("opaque_hybrid", "opaque", "hybrid", "bvh_any")):
        cap = Capture(limit=5) if label == "full" else None
        rc, launches, probes, setup_c = _render_small(paths[scene], tree,
                                                      SMALL_CHUNKS,
                                                      capture=cap)
        sc = rc.scene
        n = _n_chunks(getattr(sc, walked))
        if n < 2:
            raise RuntimeError(f"{label}: {walked} has {n} chunk(s)")
        if walked == "bvh":
            expected = _expected_full(sc, 6)
        elif walked == "bvh_opaque":
            expected = _expected_split(sc, 6)
        else:
            expected = _expected(6, closest_hit_fat=6, any_hit=n * 6)
        _held_to(f"chunked:{label}", f"chunked_{label}", launches, probes,
                 expected, report)
        rp, _, _, setup_p = _render_small(paths[scene], tree, None)
        mad = _mc_agree(f"chunked:{label}", *_state_np(rc._state),
                        *_state_np(rp._state))
        if cap is not None:
            # the rays of this render, where 4 chunks merge, against the
            # single tree of the unchunked one
            closest, anyhit = _tree_calls(cap, sc.bvh)
            numbers["full_ties"] = _forest_against_tree(
                "full", sc.bvh, rc.host.tri_order, rp.scene.bvh,
                rp.host.tri_order,
                (("full_camera", closest[0]), ("full_bounce", closest[1])),
                (("full_shadow_camera_hits", anyhit[0]),
                 ("full_shadow_bounce_hits", anyhit[1])))
            del closest, anyhit
        log(f"[chunked:{label}] {walked} in {n} chunks; setup {setup_c:.0f} ms "
            f"chunked, {setup_p:.0f} ms unchunked")
        numbers[label] = {"chunks": n, "walked": walked, "mad": mad,
                          "setup_ms": setup_c, "setup_ms_unchunked": setup_p,
                          "launches": launches}
        del rc, rp, cap
        torch.cuda.empty_cache()
    return numbers


CACHE_CHILD = """
import hashlib, json, sys
import numpy as np
from glaze_tpu_torch import cli
from glaze_tpu_torch.scene.flatten import device_scene_to_numpy
code, r, t = cli.run(sys.argv[1:])
h = hashlib.sha256()
tables = device_scene_to_numpy(r.scene)
for k in sorted(tables):
    if k.startswith("bvh"):
        h.update(k.encode())
        h.update(np.ascontiguousarray(np.asarray(tables[k])).tobytes())
print(json.dumps({"code": code, "setup_ms": t["setup"],
                  "digest": h.hexdigest()}))
"""


def phase_cache(paths, workdir):
    """The BVH disk cache: two CLI processes on the 1M-triangle scene with
    GLAZE_CACHE_DIR under build/, the first with the directory empty
    (cold), the second reading what it wrote (warm). Each reports its
    setup; the warm process's tree tables must equal the cold one's bit
    for bit (a digest of every table)."""
    cache = os.path.join(workdir, "bvh_cache")
    shutil.rmtree(cache, ignore_errors=True)
    env = dict(os.environ, GLAZE_CACHE_DIR=cache)
    runs = []
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", CACHE_CHILD, paths["grid"],
             os.path.join(workdir, f"cache_{label}.png"), "--res", "480x270",
             "--spp", "1", "--seed", str(SEED)],
            env=env, cwd=HERE, capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            raise RuntimeError(f"[cache] {label} process exited "
                               f"{child.returncode}: {child.stderr[-2000:]}")
        out = json.loads(child.stdout.strip().splitlines()[-1])
        files = os.listdir(os.path.join(cache, "bvh"))
        size = sum(os.path.getsize(os.path.join(cache, "bvh", f))
                   for f in files)
        out.update(wall_s=time.perf_counter() - t0, files=len(files),
                   bytes_on_disk=size)
        log(f"[cache] {label}: setup {out['setup_ms']:.0f} ms, process "
            f"{out['wall_s']:.1f} s, {len(files)} files, {size} bytes on disk, "
            f"tables {out['digest'][:16]}")
        runs.append(out)
    if runs[0]["digest"] != runs[1]["digest"]:
        raise RuntimeError("[cache] warm tables differ from the cold build's")
    # a file for each chunk of the forest and each subset tree, written by
    # the cold process only
    if runs[0]["files"] < 2 or (runs[1]["files"], runs[1]["bytes_on_disk"]) \
            != (runs[0]["files"], runs[0]["bytes_on_disk"]):
        raise RuntimeError("[cache] the warm process wrote to the cache")
    return {"cold": runs[0], "warm": runs[1]}


def _leaves_equal(tag, a, b):
    """Every leaf of two PathStates the same bits."""
    from glaze_tpu_torch.render import integrator as integ

    differ = [n for (n, x), (_, y) in zip(integ.named_leaves(a),
                                          integ.named_leaves(b))
              if not torch.equal(x.cpu(), y.cpu())]
    if differ:
        raise RuntimeError(f"{tag}: leaves {differ} differ")
    log(f"[{tag}] every leaf equal bit for bit")


def phase_mesh(paths, workdir, report):
    """Rendering over a device mesh on the one card. CLI --mesh on the full
    scene at 1920x1080, 2 spp (one slot here): the [main:full] render's
    accum and count bit for bit, with the same counters. In process, on
    make_mesh(["cuda:0"] * 2) at 1920x1080 (1,044,480 lanes a slot, 510
    whole tiles): a renderer's pixel mode (one sample) against the
    unsharded renderer, and the spp mode (2 launches, 2 slots) against the
    per-seed renders summed in slot order; make_mesh_2d(2, ["cuda:0"] * 4)
    against the same sums. Each bit for bit, K2 and K4 counted per slot.
    Then checkpoints at 960x540: a mesh render checkpointed after one
    sample (6 launches) and resumed on the mesh, and an unsharded
    checkpoint resumed on the mesh, against the straight mesh render."""
    from glaze_tpu_torch.parallel import mesh as pm
    from glaze_tpu_torch.render import integrator as integ
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    numbers = {}
    out = os.path.join(workdir, "sponza_mesh.png")
    code, r, times, launches, probes, _ = run_cli([
        paths["full"], out, "--res", f"{RES[0]}x{RES[1]}", "--spp", str(SPP),
        "--seed", str(SEED), "--mesh"])
    if code != 0 or r._mesh is None or r._mesh.size != 1:
        raise RuntimeError(f"CLI --mesh exited {code}")
    _held_to("mesh:cli", "mesh_cli", launches, probes, EXPECTED_FULL, report)
    accum, count = _state_np(r._state)
    want = MAIN_STATES["full"]
    same = bool(np.array_equal(accum.view(np.int32), want[0].view(np.int32))
                and np.array_equal(count, want[1]))
    log(f"[mesh:cli] --mesh (1 slot) against [main:full]: accum and count "
        f"bit for bit: {same}; {times['render'] / times['launches']:.1f} ms "
        f"per launch")
    if not same:
        raise RuntimeError("--mesh render differs from the unsharded one")
    numbers["cli_ms_per_launch"] = times["render"] / times["launches"]
    scene, camera = r.scene, r.camera
    del r
    torch.cuda.empty_cache()

    mesh2 = pm.make_mesh(["cuda:0"] * 2)
    kw = dict(width=RES[0], height=RES[1], seed=SEED, camera=camera)
    ref = RayTraceRenderer(scene, **kw)
    t0 = time.perf_counter()
    ref.draw(1, return_image=False)
    torch.cuda.synchronize()
    numbers["unsharded_ms_per_launch"] = (time.perf_counter() - t0) * 1e3 / 6
    rm = RayTraceRenderer(scene, mesh=mesh2, **kw)
    _reset_counts()
    t0 = time.perf_counter()
    rm.draw(1, return_image=False)
    torch.cuda.synchronize()
    numbers["pixel2_ms_per_launch"] = (time.perf_counter() - t0) * 1e3 / 6
    launches, probes = _launch_counts()
    log(f"[mesh:pixel2] one sample: {numbers['pixel2_ms_per_launch']:.1f} ms "
        f"per launch on 2 slots of cuda:0, unsharded "
        f"{numbers['unsharded_ms_per_launch']:.1f}")
    _held_to("mesh:pixel2", "mesh_pixel2", launches, probes,
             _expected_full(scene, 6 * 2), report)
    _leaves_equal("mesh:pixel2", rm._state, ref._state)
    del rm, ref

    c2w, s2c = integ.camera_matrices(camera, RES[0], RES[1])
    seeds = np.asarray([[11, 12], [13, 14]], np.uint32)  # (steps, slots)
    offsets = np.asarray([[0.25, 0.75], [0.625, 0.125]], np.float32)
    args = dict(width=RES[0], height=RES[1], is_persp=camera.is_perspective,
                direct_only=False, steps=2, alpha_rounds=1, coherent=1,
                sampler="pcg", sampler_seed=0)
    group = pm._group_sampler_seeds(0, 2)
    per_seed = [integ.render_steps(
        scene, integ.init_state(RES[0], RES[1], "cuda"), seeds[:, i], offsets,
        c2w, s2c, **dict(args, sampler_seed=group[i])) for i in range(2)]
    want = per_seed[0]._replace(
        accum=tuple(a + b for a, b in zip(per_seed[0].accum,
                                          per_seed[1].accum)),
        count=per_seed[0].count + per_seed[1].count)
    for label, mesh, fn in (
            ("spp2", mesh2, pm.render_steps_spp_sharded),
            ("2d_2x2", pm.make_mesh_2d(2, ["cuda:0"] * 4),
             pm.render_steps_2d_sharded)):
        _reset_counts()
        states = fn(scene, pm.init_state_spp(RES[0], RES[1], 2, "cuda"),
                    seeds, offsets, c2w, s2c, mesh, **args)
        got = pm.reduce_spp(states)
        torch.cuda.synchronize()
        launches, probes = _launch_counts()
        _held_to(f"mesh:{label}", f"mesh_{label}", launches, probes,
                 _expected_full(scene, 2 * mesh.size), report)
        _leaves_equal(f"mesh:{label}", got, want)
    del per_seed, want, states, got

    w2, h2 = RES[0] // 2, RES[1] // 2
    kw = dict(width=w2, height=h2, seed=SEED, camera=camera)
    straight = RayTraceRenderer(scene, mesh=mesh2, **kw)
    straight.draw(2, return_image=False)
    for label, first_mesh in (("mesh_checkpoint", mesh2),
                              ("unsharded_checkpoint", None)):
        ck = os.path.join(workdir, f"{label}.npz")
        r1 = RayTraceRenderer(scene, mesh=first_mesh, **kw)
        r1.draw(1, return_image=False)  # 6 launches: even (ROADMAP F12)
        t0 = time.perf_counter()
        r1.save_checkpoint(ck)
        save_s = time.perf_counter() - t0
        r2 = RayTraceRenderer(scene, mesh=mesh2, **kw)
        r2.load_checkpoint(ck)
        r2.draw(1, return_image=False)
        log(f"[mesh:{label}] saved in {save_s:.2f} s at {w2}x{h2}")
        _leaves_equal(f"mesh:{label}", r2._state, straight._state)
        del r1, r2
    torch.cuda.empty_cache()
    return numbers


# pod_launch.main under torch's launcher, each rank's kernel launches
# written to DIR/rank<RANK>.json: python POD_CHILD DIR <pod_launch args>
POD_CHILD = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from glaze_tpu_torch.accel import traverse_cuda as tc
from glaze_tpu_torch.render import shade_cuda as shade
from glaze_tpu_torch.tools import pod_launch
tc.reset_launch_counts()
shade.reset_launch_counts()
code = pod_launch.main(sys.argv[2:])
torch.cuda.synchronize()
launches = [tc.closest_hit_soa.launches, tc.any_hit_soa.launches,
            tc.closest_hit_soa_masked.launches, tc.any_hit_soa_masked.launches,
            tc.closest_hit_fat_soa.launches, tc.any_hit_fat_soa.launches,
            shade.nee_kernel.launches, shade.bsdf_kernel.launches,
            shade.surface_kernel.launches]
with open(os.path.join(sys.argv[1], "rank%s.json" % os.environ["RANK"]),
          "w") as f:
    json.dump({"code": code, "launches": launches}, f)
sys.exit(code)
"""

DIST_RES = (RES[0] // 2, RES[1] // 2)


def _torchrun(label, target, args):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2``
    on ``target`` (``["-m", module]`` or a script) with ``args``; raises
    unless every rank exits 0. Returns the wall seconds."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.setdefault("OMP_NUM_THREADS", "2")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *target, *args], env=env, cwd=HERE,
        capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    for line in (child.stdout + child.stderr).splitlines():
        if line.startswith(("pod_launch", "setup", "resumed", "saved")) or \
                " spp (" in line:
            log(f"  [{label}] {line.strip()}")
    if child.returncode != 0:
        raise RuntimeError(f"[distributed] {label}: torchrun exited "
                           f"{child.returncode}: {child.stderr[-3000:]}")
    return wall


def _checkpoints_equal(tag, got, want):
    """Every array of two checkpoints the same bits: the 15 leaves, the
    host generator, the scheduler and the scene id."""
    a, b = np.load(got), np.load(want)
    differ = sorted(k for k in set(a.files) | set(b.files)
                    if k not in a.files or k not in b.files
                    or not np.array_equal(a[k], b[k]))
    log(f"[distributed] {tag}: checkpoint arrays apart from the "
        f"one-process CLI's: {differ}")
    if differ:
        raise RuntimeError(f"[distributed] {tag}: {differ} differ")


def phase_distributed(paths, workdir, report):
    """pod_launch under torch's launcher, two ranks on the one card over
    gloo (NCCL refuses two ranks on one card), on the full scene at
    960x540 with --checkpoint: straight to 2 spp (the command the README
    gives, ``-m glaze_tpu_torch.tools.pod_launch``), and interrupted at 1
    spp and resumed to 2 by a second launch (pod_launch.main with each
    rank's kernel launches counted). Each final checkpoint, and its image,
    must equal the one-process CLI's of the same seed bit for bit."""
    res = f"{DIST_RES[0]}x{DIST_RES[1]}"
    files = {k: os.path.join(workdir, f"pod_{k}") for k in (
        "cli.npz", "cli.png", "straight.npz", "straight.png", "resumed.npz",
        "resumed.png")}
    for f in files.values():
        if os.path.exists(f):
            os.unlink(f)
    counts = os.path.join(workdir, "pod_counts")
    shutil.rmtree(counts, ignore_errors=True)
    os.makedirs(counts)
    child = os.path.join(workdir, "pod_child.py")
    with open(child, "w") as f:
        f.write(POD_CHILD)

    def pod(tag, spp):
        return ["--res", res, "--spp", str(spp), "--seed", str(SEED),
                "--checkpoint", files[f"{tag}.npz"]]

    code, _, times, _, _, _ = run_cli([
        paths["full"], files["cli.png"], "--res", res, "--spp", "2", "--seed",
        str(SEED), "--checkpoint", files["cli.npz"]])
    if code != 0:
        raise RuntimeError(f"[distributed] the CLI exited {code}")
    walls = {"straight": _torchrun(
        "straight", ["-m", "glaze_tpu_torch.tools.pod_launch"],
        [paths["full"], files["straight.png"], *pod("straight", 2)])}
    launches = dict.fromkeys(KERNELS, 0)
    for part, spp in (("interrupted", 1), ("resumed", 2)):
        walls[part] = _torchrun(part, [child, counts],
                                [paths["full"], files["resumed.png"],
                                 *pod("resumed", spp)])
        for rank in range(2):
            with open(os.path.join(counts, f"rank{rank}.json")) as f:
                got = json.load(f)
            for i, name in enumerate(KERNELS):
                launches[name] += got["launches"][i]
    log(f"[distributed] torchrun, 2 ranks on cuda:0 over gloo: straight "
        f"{walls['straight']:.1f} s, interrupted {walls['interrupted']:.1f} "
        f"s, resumed {walls['resumed']:.1f} s")
    # 6 launches a sample and rank, each K2 four times, K4 and the NEE
    # kernel once
    _held_to("distributed", "distributed", launches, {},
             _expected(6 * 2 * 2, closest_hit_masked=4 * 6 * 2 * 2,
                       any_hit_masked=6 * 2 * 2), report)
    for tag in ("straight", "resumed"):
        _checkpoints_equal(tag, files[f"{tag}.npz"], files["cli.npz"])
        with open(files[f"{tag}.png"], "rb") as a, \
                open(files["cli.png"], "rb") as b:
            if a.read() != b.read():
                raise RuntimeError(f"[distributed] {tag}: the image differs "
                                   "from the CLI's")
    log("[distributed] both images equal the CLI's byte for byte")
    return {"wall_s": walls, "cli_setup_ms": times["setup"],
            "cli_render_ms": times["render"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import glaze_tpu_torch  # noqa: F401  (fails outside a checkout)
    from glaze_tpu_torch.tools.common import card_line, max_sm_clock_mhz

    t_start = time.perf_counter()
    # the BVH disk cache stays off, so every path's setup is a cold build
    # and the script writes nothing outside the checkout; [cache] points
    # its own processes at a directory under build/
    os.environ["GLAZE_CACHE_DIR"] = "0"
    global SM_HZ
    card = card_line()
    clock = max_sm_clock_mhz()
    SM_HZ = clock * 1e6
    log(f"[card] {card}; max SM clock {clock:.0f} MHz; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    workdir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    seconds = {}

    def run(name, fn, *args):
        """A phase, its host seconds logged and kept."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"[time] {name}: {seconds[name]:.1f} s")
        return out

    attrs = run("build", phase_build)
    rates = run("rates", phase_rates)
    run("walk_cases", phase_walk_cases)
    probes = run("probes", phase_probes)
    paths = run("scene", phase_scene, workdir)
    report = run("kernels", phase_kernels, paths["opaque"])
    report.update(run("masked_kernels", phase_masked_kernels, paths["full"]))
    report.update(run("fat_kernels", phase_fat_kernels, paths["opaque"]))
    report.update(run("surface", phase_surface, paths["full"]))
    report.update(run("nee", phase_nee, paths["full"]))
    report.update(run("bsdf", phase_bsdf, paths["full"]))
    main_numbers = {}
    for label, scene, expected, tree in (
            ("full", "full", EXPECTED_FULL, None),
            ("opaque", "opaque", EXPECTED_OPAQUE, None),
            ("fat", "opaque", EXPECTED_FAT, "fat"),
            ("hybrid", "opaque", EXPECTED_HYBRID, "hybrid"),
            ("fat_full", "full", EXPECTED_FAT_FULL, "fat")):
        main_numbers[label] = run(label, phase_main_path, label, paths[scene],
                                  workdir, report, expected, tree)
    run("golden", phase_golden)
    main_numbers["sampling"] = run("sampling", phase_sampling, paths["full"],
                                   workdir, report)
    main_numbers["resume"] = run("resume", phase_resume, paths, workdir,
                                 report)
    main_numbers["denoise"] = run("denoise", phase_denoise, paths["full"],
                                  workdir, report)
    main_numbers["convert"] = run("convert", phase_convert, paths["full"],
                                  workdir, report)
    main_numbers["edit"] = run("edit", phase_edit, paths["full"], report)
    main_numbers["interactive"] = run("interactive", phase_interactive,
                                      paths["full"], workdir, report)
    main_numbers["viewer"] = run("viewer", phase_viewer, paths["full"],
                                 report)
    main_numbers["chunked"] = run("chunked", phase_chunked, paths, workdir,
                                  report)
    main_numbers["cache"] = run("cache", phase_cache, paths, workdir)
    main_numbers["mesh"] = run("mesh", phase_mesh, paths, workdir, report)
    main_numbers["distributed"] = run("distributed", phase_distributed,
                                      paths, workdir, report)
    for name, a in attrs.items():
        report[name].update(a)
    for label, numbers in main_numbers.items():
        for name, ms in numbers.get("profile", {}).get(
                "traversal_ms_per_launch", {}).items():
            report[name].setdefault("in_render_ms_by_path", {})[label] = ms
    report.update(probes)
    kernels = []
    for k in report.values():
        kernels.append({key: k[key] for key in (
            "name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "sets") + tuple(
                key for key in ("headline", "registers", "local_bytes",
                                "instances",
                                "threads_per_block", "blocks_per_sm",
                                "occupancy", "warp", "in_render_ms_by_path")
                if key in k)})
    log(f"[done] {time.perf_counter() - t_start:.0f} s in all")
    print(json.dumps({"main_path": main_numbers, "card": card,
                      "max_sm_clock_mhz": clock, "rates": rates,
                      "phase_seconds": seconds}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
