"""Slab-test rate probe (T4): does packed bf16 run the AABB slab test at
twice the f32 rate on this card?

A conservative bf16 slab test (bounds widened outward by directed
rounding) would be hit-exact, so the only question is throughput. This
probe times the production slab-test op mix (6 add/sub, 6 mul, 10 min/max,
2 compares, the hit count and the capped t per element and iteration)
``ITERS`` times per element, in f32 (one element per thread) and in
packed bf16 (two elements per thread, ``__nv_bfloat162``), at the tool's
256 and 512 rows of 128 and at a size that fills the card (132 SMs x 2048
threads = 2,112 rows of 128 f32 elements).

Decision rule (the tool's): adopt bf16 slabs only if the per-element rate
is >= 1.7x f32, else the family closes.

Kernels: ``slab_rate_f32`` / ``slab_rate_bf16`` in ``csrc/probes.cu``;
``slab_rate_plain`` is their plain torch version, which rounds every bf16
operation once, as the card's packed instructions do.

Usage: python -m glaze_tpu_torch.tools.bench_bf16_slab [--iters N]
       [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from glaze_tpu_torch.device import resolve_device
from glaze_tpu_torch.tools import common, probes_cuda
from glaze_tpu_torch.tools.bench_mxu import bf16_round

ROWS_F32 = 256     # (256, 128) f32 rays, as the tool's resident block
ITERS = 2048       # slab tests per kernel call per element
LANES = 128
NODE_ROWS = 64
FILL_ROWS = 2112   # 132 SMs x 2048 threads / 128 lanes
# the instructions of one test by class (glaze_tpu_torch.tools.common.RATES),
# as the sm_90a loops issue them (python scripts/sass_loops.py probes
# slab_rate): f32, per element: 6 add/sub and the count's add, 6 mul, 10
# min/max and the cap's min, 2 compares, the cap's select (27); bf16, per
# pair of elements: the same adds and muls packed (the compiler issues
# some as HFMA2), 9 packed min/max (two three-input VHMNMX do two each),
# 2 compares into lane masks and 2 LOP3 for the count and the capped t
# (26)
TEST_OPS_F32 = {"FADD": 7, "FMUL": 6, "FMNMX": 11, "FSETP": 2, "FSEL": 1}
TEST_OPS_BF16 = {"HADD2": 7, "HMUL2": 6, "HMNMX2": 7, "VHMNMX": 2,
                 "HSET2": 2, "LOP3": 2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def slab_inputs(dtype, rows, device):
    """The tool's inputs: o in [0, 1) (rng 0), i in [0.5, 1.5) (rng 1) as
    (rows, 128) in ``dtype`` (through f32), nodes (64, 128) f32 (rng 2)."""
    shape = (rows, LANES)
    o = np.random.default_rng(0).random(shape).astype(np.float32)
    i = (np.random.default_rng(1).random(shape) + 0.5).astype(np.float32)
    nodes = np.random.default_rng(2).random((NODE_ROWS, LANES))
    return (torch.from_numpy(o).to(device, dtype),
            torch.from_numpy(i).to(device, dtype),
            torch.from_numpy(nodes.astype(np.float32)).to(device))


def _ops(dtype):
    """(add, mul, round) of the op mix in ``dtype``: f32 as is; bf16 as f32
    rounded to bf16 after every operation. That is the card's single
    rounding: a product of two bf16 values is exact in f32, and so is a sum
    unless their exponents differ by more than 15, when the exact sum lies
    within an f32 ulp of the larger operand, far from a bf16 halfway
    point."""
    if dtype == torch.float32:
        return (lambda a, b: a + b), (lambda a, b: a * b), (lambda x: x)
    return ((lambda a, b: bf16_round(a + b)), (lambda a, b: bf16_round(a * b)),
            bf16_round)


def slab_rate_plain(o, i, nodes, iters):
    """Plain torch version of :func:`slab_rate_probe` (any device)."""
    dtype = o.dtype
    add, mul, rnd = _ops(dtype)
    ox, ix = o.float(), i.float()
    one = torch.ones((), device=o.device)
    t_cap = mul(ox, one)
    acc = torch.zeros_like(ox)
    zero = torch.zeros_like(ox)
    for k in range(iters):
        b = rnd(nodes[k % NODE_ROWS]).expand_as(ox)
        oxo = mul(ox, one)
        t0x = mul(add(b, -ox), ix)
        t1x = mul(add(b, ox), ix)
        t0y = mul(add(b, -oxo), ix)
        t1y = mul(add(b, oxo), ix)
        t0z = mul(add(b, -ix), ox)
        t1z = mul(add(b, ix), ox)
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.maximum(t0z, t1z))
        hit = (tn <= tf) & (tf >= 0)
        acc = add(acc, torch.where(hit, one, zero))
        t_cap = torch.where(hit, torch.minimum(t_cap, tf), t_cap)
    return add(acc, t_cap).to(dtype)


def slab_rate_probe(o, i, nodes, iters=None):
    """T4: ``acc + t_cap`` after ``iters`` (default ITERS) slab tests per
    element of ``o``/``i`` ((rows, 128) f32 or bf16) against the node rows
    ``k % 64`` of ``nodes`` (64, 128) f32, in the inputs' dtype. A CPU
    tensor takes the plain version; a CUDA tensor the kernel (or
    raises)."""
    iters = ITERS if iters is None else iters
    if o.device.type == "cpu":
        return slab_rate_plain(o, i, nodes, iters)
    return probes_cuda.slab_rate(o, i, nodes, iters)


def run(dtype, rows, device=None, iters=None):
    """One dtype and size: the output and, on the card, the median ms of
    three calls and the rate in Gtest/s."""
    device = resolve_device(device)
    iters = ITERS if iters is None else iters
    o, i, nodes = slab_inputs(dtype, rows, device)
    out = slab_rate_probe(o, i, nodes, iters)
    res = dict(dtype=dtype, rows=rows, iters=iters, out=out,
               inputs=(o, i, nodes))
    if device.type == "cuda":
        ms = common.cuda_ms(lambda: slab_rate_probe(o, i, nodes, iters))
        res.update(ms=ms, rate=rows * LANES * iters / (ms * 1e-3) / 1e9)
    return res


SIZES = (("f32", ROWS_F32), ("bf16", ROWS_F32), ("bf16", ROWS_F32 * 2),
         ("f32", FILL_ROWS), ("bf16", FILL_ROWS))


def measure(device=None, iters=None):
    """The tool's main, and the size that fills the card: prints the rate
    lines and the decision lines; returns the results in SIZES order."""
    device = resolve_device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}")
    runs = [run(DTYPES[dt], rows, device, iters) for dt, rows in SIZES]
    if device.type != "cuda":
        for (dt, rows), r in zip(SIZES, runs):
            print(f"{dt:4s} ({rows}x128): checksum "
                  f"{float(r['out'].double().sum()):.6g} (time: not measured "
                  "on the CPU)")
        print("verdict: not measured on the CPU")
        return runs
    for (dt, rows), r in zip(SIZES, runs):
        base = runs[0] if rows <= ROWS_F32 * 2 else runs[3]
        ratio = "" if r is base else f"  ({r['rate'] / base['rate']:.2f}x)"
        print(f"{dt:4s} ({rows}x128): {r['ms']:7.2f} ms  {r['rate']:6.2f} "
              f"Gtest/s{ratio}")
    print(verdict(max(runs[1]["rate"], runs[2]["rate"]), runs[0]["rate"]))
    print(f"at {FILL_ROWS} rows: {verdict(runs[4]['rate'], runs[3]['rate'])}")
    return runs


def main(argv=None):
    device, args = common.split_device(sys.argv[1:] if argv is None else argv)
    measure(device, int(args[args.index("--iters") + 1])
            if "--iters" in args else None)
    return 0


def verdict(bf16_rate, f32_rate):
    """The tool's decision line."""
    return ("ADOPT-CANDIDATE (wire conservative bf16 slabs)"
            if bf16_rate >= 1.7 * f32_rate
            else "CLOSED: bf16 VPU math does not deliver ~2x here")


if __name__ == "__main__":
    sys.exit(main())
