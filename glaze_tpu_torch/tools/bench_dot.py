"""Drain-product probe (T3a, T3b): the fat drain's product against shape
and precision, on tensor cores.

T3a times a chain of ``reps`` dependent (F, W)^T (F, 128) products (the
fat drain's contraction), W = 4*T*batch, each fed back through a
non-linear sign flip of the features and folded into an (8, 128) sum, so
the product dominates. It answers:

  1. does a wider product (batch leaf slabs per call) amortise fixed
     cost, i.e. is the time per (row, leaf) lower at W = 2048 than at 512?
  2. how do ``highest`` (3xTF32) and ``default`` (one bf16 pass) scale?
  3. the manual 3-pass bf16 hi/lo split (``split3``) against ``highest``.

T3b (``run_resolve_case``, or ``--resolve``) times the same product at
``highest`` plus the full closest-hit resolve of the fat drain, ``reps``
times.

Kernels: ``dot_chain_kernel`` and ``drain_kernel`` (carry form) in
``csrc/probes.cu``; ``dot_chain_plain`` and ``resolve_chain_plain`` are
their plain torch versions.

Usage: python -m glaze_tpu_torch.tools.bench_dot [--resolve] [--reps N]
       [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from glaze_tpu_torch.device import resolve_device
from glaze_tpu_torch.tools import common, probes_cuda
from glaze_tpu_torch.tools.bench_mxu import (F, as_rows, fold_leaf, no_hits,
                                             product_plain, resolve_plain)

REPS = 4096
CASES = ((128, 1), (128, 2), (128, 4), (64, 1), (64, 4), (64, 8))
RESOLVE_TS = (128, 64)
T_INIT = 1e30  # run_resolve_case's initial t


def chain_inputs(W, device):
    """The tool's (16, W) matrix (rng 0) and (16, 128) features (rng 1)."""
    mat = np.random.default_rng(0).normal(size=(F, W)).astype(np.float32)
    feat = np.random.default_rng(1).normal(size=(F, 128)).astype(np.float32)
    return torch.from_numpy(mat).to(device), torch.from_numpy(feat).to(device)


def dot_chain_plain(mat, feat, precision, reps, trace=False):
    """Plain torch version of :func:`dot_chain_probe` (any device)."""
    acc = torch.zeros((8, 128), dtype=torch.float32, device=mat.device)
    steps = []
    for _ in range(reps):
        f = torch.where(feat > acc[0, 0], feat, -feat)
        out = product_plain(mat, f, precision)
        acc = acc + out.reshape(-1, 8, 128).sum(0)
        if trace:
            steps.append(acc[0, 0])
    return acc, (torch.stack(steps) if trace and steps else None)


def dot_chain_probe(mat, feat, precision, reps, trace=False):
    """T3a: ``acc`` (8, 128) after ``reps`` steps of
    ``f = where(feat > acc[0, 0], feat, -feat)``,
    ``acc += sum((mat^T f).reshape(-1, 8, 128), 0)``; with ``trace`` also
    acc[0, 0] after each step, else None. CPU tensors take the plain
    version; CUDA tensors the kernel (or raise)."""
    if mat.device.type == "cpu":
        return dot_chain_plain(mat, feat, precision, reps, trace)
    return probes_cuda.dot_chain(mat, feat, precision, reps, trace)


def first_flip(feat, trace_a, trace_b):
    """Steps at which two chains fed back different sign patterns (step s
    compares ``feat > trace[s - 1]``, step 0 compares with 0): ``(first,
    count)``, first None when they never differ."""
    zero = trace_a.new_zeros(1)
    prev_a = torch.cat([zero, trace_a[:-1]])
    prev_b = torch.cat([zero, trace_b[:-1].to(trace_a.device)])
    f = feat.reshape(1, -1)
    differ = ((f > prev_a[:, None]) != (f > prev_b[:, None])).any(1)
    idx = torch.nonzero(differ).flatten()
    return (int(idx[0]) if idx.numel() else None), int(idx.numel())


def resolve_chain_plain(mat, feat, T, reps):
    """Plain torch version of :func:`resolve_chain_probe` (any device)."""
    best = no_hits(feat.shape[1], mat.device, T_INIT)
    carry = torch.zeros((), dtype=torch.float32, device=mat.device)
    inf = torch.full((), float("inf"), device=mat.device)
    for _ in range(reps):
        out = product_plain(mat[:, :4 * T], feat + carry, "highest")
        tmin, col, u, v = resolve_plain(out, T)
        best, better = fold_leaf(best, 0, T, tmin, col, u, v)
        # the step's least t below the best so far (inf where none)
        carry = carry + torch.where(better[0], tmin[0], inf) * 1e-30
    return best


def resolve_chain_probe(mat, feat, T, reps):
    """T3b: ``reps`` steps of the 3xTF32 product of ``mat`` (16, 4T) with
    ``feat + carry`` and the closest-hit resolve (t starts at 1e30; the
    carry grows by ray 0's least new t times 1e-30). Returns the tool's
    (8, 128) t, tri, u, v."""
    if mat.device.type == "cpu":
        res = resolve_chain_plain(mat, feat, T, reps)
    else:
        res = probes_cuda.resolve_chain(mat, feat, T, reps, T_INIT)
    return as_rows(res, T_INIT)


def _cycles(ms, reps):
    clock = common.max_sm_clock_mhz()
    return ms * 1e-3 * clock * 1e6 / reps, clock


def run_case(T, batch, precision, split3, reps=REPS, device=None):
    """The tool's case: the chain at (T, batch) and ``precision``
    (``split3`` selects the bf16 hi/lo split, the tool's
    ``run_case(T, batch, "default", True)``). Returns a dict with the
    chain's ``acc`` and, on the card, ``ms``."""
    device = resolve_device(device)
    prec = "split3" if split3 else precision
    mat, feat = chain_inputs(4 * T * batch, device)
    acc, _ = dot_chain_probe(mat, feat, prec, reps)
    res = dict(T=T, batch=batch, precision=prec, reps=reps, acc=acc,
               inputs=(mat, feat))
    label = f"T={T} batch={batch} prec={precision}{' split3' if split3 else ''}"
    if device.type != "cuda":
        print(f"{label}: checksum {float(acc.double().sum()):.6g} after "
              f"{reps} dots (time: not measured on the CPU)")
        return res
    ms = common.cuda_ms(lambda: dot_chain_probe(mat, feat, prec, reps), runs=2)
    cyc, clock = _cycles(ms, reps)
    res.update(ms=ms, cycles_per_dot=cyc, clock_mhz=clock)
    print(f"{label}: {ms:.2f} ms/{reps} dots -> {cyc:.0f} cyc/dot, "
          f"{cyc / batch:.0f} cyc/(row,leaf) (clocks.max.sm {clock:.0f} MHz)")
    return res


def run_resolve_case(T, reps=REPS, device=None):
    """The tool's full-resolve case at leaf size ``T``."""
    device = resolve_device(device)
    mat, feat = chain_inputs(4 * T, device)
    t, tri, u, v = resolve_chain_probe(mat, feat, T, reps)
    res = dict(T=T, reps=reps, outputs=(t, tri, u, v), inputs=(mat, feat))
    if device.type != "cuda":
        print(f"T={T} FULL-RESOLVE: {int((tri[0] >= 0).sum())} rays hit "
              f"after {reps} pairs (time: not measured on the CPU)")
        return res
    ms = common.cuda_ms(lambda: resolve_chain_probe(mat, feat, T, reps),
                        runs=2)
    cyc, clock = _cycles(ms, reps)
    res.update(ms=ms, cycles=cyc, clock_mhz=clock)
    print(f"T={T} FULL-RESOLVE: {ms:.2f} ms/{reps} pairs -> {cyc:.0f} "
          f"cyc/(row,leaf) (clocks.max.sm {clock:.0f} MHz)")
    return res


def measure(device=None, reps=REPS, resolve=False):
    """The tool's main: every (T, batch) case at highest, default and
    split3, or (``resolve``) the full-resolve cases. Returns the list of
    results."""
    if resolve:
        return [run_resolve_case(T, reps, device) for T in RESOLVE_TS]
    return [run_case(T, batch, precision, split3, reps, device)
            for T, batch in CASES
            for precision, split3 in (("highest", False), ("default", False),
                                      ("default", True))]


def main(argv=None):
    device, args = common.split_device(sys.argv[1:] if argv is None else argv)
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else REPS
    measure(device, reps, "--resolve" in args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
