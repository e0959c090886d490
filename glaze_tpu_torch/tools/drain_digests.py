"""Bit-for-bit check of the drain kernels (T1, T3b) and the slab-rate
loops (T4) across two builds.

Prints sha256 digests of ``drain_kernel``'s t/tri/u/v bytes on fixed
inputs: for every leaf size and precision, T1's check drain and its timed
leaf order (:func:`bench_mxu.run`'s inputs), rays aimed at the triangles
(:func:`bench_mxu.aimed_rays`) and the exact ties of
:func:`bench_mxu.tie_inputs`; T3b's chain at 16 and 4,096 steps; T4's
output in f32 and bf16 at the tool's 256 and 512 rows and at 2,112 rows,
2,048 iterations. With ``--against SOURCE`` it also builds ``SOURCE`` (a
``probes.cu`` with the same C interface, e.g. an earlier commit's) and
reports the cases whose digests differ between the two builds; with
``--time`` it times T1 (T = 128, both precisions, 8,192 leaves, one
block), T3b (T = 128, 4,096 steps) and T4 (2,112 rows, both types) on
each build, in turns (this, that, that, this).

Usage: python -m glaze_tpu_torch.tools.drain_digests [--against SOURCE]
       [--time] [--device cuda|cpu]
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch

from glaze_tpu_torch import cuda_build
from glaze_tpu_torch.tools import (bench_bf16_slab, bench_dot, bench_mxu,
                                   common, probes_cuda)

AGAINST_LIBRARY = "libglaze_probes_against.so"


def _digest(outputs) -> str:
    h = hashlib.sha256()
    for x in outputs:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


SLAB_ROWS = (bench_bf16_slab.ROWS_F32, 2 * bench_bf16_slab.ROWS_F32,
             bench_bf16_slab.FILL_ROWS)


def cases(device, ts=bench_mxu.TS, reps=8192, chain=(16, 4096),
          slab_rows=SLAB_ROWS, slab_iters=bench_bf16_slab.ITERS):
    """{name: call} of the drains and slab loops to digest, on
    ``device``."""
    out = {}
    for dt, dtype in bench_bf16_slab.DTYPES.items():
        for rows in slab_rows:
            inp = bench_bf16_slab.slab_inputs(dtype, rows, device)
            out[f"T4_{dt}_{rows}"] = (
                lambda inp=inp: (bench_bf16_slab.slab_rate_probe(
                    *inp, slab_iters).view(torch.int16),))
    for T in ts:
        inp, rng = bench_mxu.probe_inputs(T)
        mats, centres, rays = (torch.from_numpy(inp[k]).to(device)
                               for k in ("mats", "centres", "rays"))
        check = torch.arange(inp["L"], dtype=torch.int32, device=device)
        timed = torch.from_numpy(
            rng.integers(0, inp["L"], reps).astype(np.int32)).to(device)
        aimed = torch.from_numpy(bench_mxu.aimed_rays(T)).to(device)
        tie = bench_mxu.tie_inputs(T)
        tie = [torch.from_numpy(tie[k]).to(device)
               for k in ("mats", "centres", "rays", "order")]
        for prec in bench_mxu.PRECISIONS:
            for label, r, order in (("check", rays, check),
                                    (f"reps{reps}", rays, timed),
                                    ("aimed", aimed, check)):
                out[f"T1_T{T}_{prec}_{label}"] = (
                    lambda r=r, order=order, T=T, prec=prec:
                    bench_mxu.drain_probe(mats, centres, r, order, T, prec))
            out[f"T1_T{T}_{prec}_ties"] = (
                lambda tie=tie, T=T, prec=prec:
                bench_mxu.drain_probe(*tie, T, prec))
        mat, feat = bench_dot.chain_inputs(4 * T, device)
        for steps in chain:
            out[f"T3b_T{T}_{steps}"] = (
                lambda mat=mat, feat=feat, T=T, steps=steps:
                bench_dot.resolve_chain_probe(mat, feat, T, steps))
    return out


def digests(device, **kw) -> dict:
    """{case: sha256 hex} of :func:`cases` on ``device``."""
    return {name: _digest(call()) for name, call in cases(device, **kw).items()}


def times(device) -> dict:
    """Milliseconds (median of 5) of the T1 and T3b headline drains and
    of T4 at 2,112 rows."""
    inp, rng = bench_mxu.probe_inputs(128)
    mats, centres, rays = (torch.from_numpy(inp[k]).to(device)
                           for k in ("mats", "centres", "rays"))
    order = torch.from_numpy(
        rng.integers(0, inp["L"], 8192).astype(np.int32)).to(device)
    mat, feat = bench_dot.chain_inputs(512, device)
    out = {f"T1_{p}_ms": common.cuda_ms(lambda p=p: bench_mxu.drain_probe(
        mats, centres, rays, order, 128, p), runs=5)
        for p in bench_mxu.PRECISIONS}
    out["T3b_ms"] = common.cuda_ms(
        lambda: bench_dot.resolve_chain_probe(mat, feat, 128, 4096), runs=5)
    for dt, dtype in bench_bf16_slab.DTYPES.items():
        inp = bench_bf16_slab.slab_inputs(dtype, bench_bf16_slab.FILL_ROWS,
                                          device)
        out[f"T4_{dt}_ms"] = common.cuda_ms(
            lambda inp=inp: bench_bf16_slab.slab_rate_probe(*inp), runs=5)
    return out


def main(argv=None):
    device, args = common.split_device(sys.argv[1:] if argv is None else argv)
    against = args[args.index("--against") + 1] if "--against" in args else None
    res = {"this": {"digests": digests(device)}}
    if against is not None:
        so, _ = cuda_build.build(os.path.abspath(against), AGAINST_LIBRARY)
        probes_cuda.use_library(so)
        res["that"] = {"source": against, "digests": digests(device)}
        probes_cuda.use_library(None)
        res["differ"] = sorted(k for k, v in res["this"]["digests"].items()
                               if res["that"]["digests"].get(k) != v)
    if "--time" in args and device.type == "cuda":
        libs = [("this", None)] + ([("that", so)] if against else [])
        for name, lib in libs + libs[::-1]:
            probes_cuda.use_library(lib)
            for k, ms in times(device).items():
                res[name].setdefault(k, []).append(ms)
        probes_cuda.use_library(None)
        res["card"] = common.card_line()
    print(json.dumps(res))
    return 1 if res.get("differ") else 0


if __name__ == "__main__":
    sys.exit(main())
