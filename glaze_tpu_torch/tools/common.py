"""What the probe tools (and ``chip_smoke.py``) share: the ``--device``
flag, timing with CUDA events, the card's clocks, name and power limit."""

from __future__ import annotations

import functools
import statistics
import subprocess

import torch

from glaze_tpu_torch.device import resolve_device


# The non-tensor rates that the bounds charge, in thread instructions per
# SM-clock (a packed bf16x2 instruction counts once), by instruction class,
# with the pipe each class issues to: classes of one pipe share its time.
# Measured on the card by scripts/issue_rates.py (PERF.md, "Issue rates on
# this card"); chip_smoke.py's [rates] phase fails if a class runs more
# than 5% above its rate here, so that every bound stays a least time.
ISSUE_PER_SM_CLOCK = 128  # one warp instruction per sub-partition a clock
RATES = {
    "FADD": ("fma", 128), "FMUL": ("fma", 128), "FFMA": ("fma", 128),
    "FMNMX": ("alu", 64), "FSETP": ("alu", 64), "FSEL": ("alu", 64),
    "LOP3": ("alu", 64), "MUFU": ("sfu", 16),
    "HADD2": ("fma", 128), "HMUL2": ("fma", 128), "HFMA2": ("fma", 128),
    "HSET2": ("alu", 64),
    "HMNMX2": ("alu", 64), "VHMNMX": ("alu", 64), "HSETP2": ("alu", 64),
    "F2FP": ("alu", 64), "LDS64": ("mio", 16),
}


def ops_clocks(counts):
    """SM-clocks that ``counts`` (class -> thread instructions on one SM)
    take at the least: the larger of all of them over the issue rate and,
    for each pipe of :data:`RATES`, its classes' instructions over their
    rates. A class without a charged rate counts towards the issue term
    only. Returns (clocks, the term that binds: 'issue' or a pipe)."""
    terms = {"issue": sum(counts.values()) / ISSUE_PER_SM_CLOCK}
    for cls, n in counts.items():
        if cls in RATES:
            pipe, rate = RATES[cls]
            terms[pipe] = terms.get(pipe, 0.0) + n / rate
    term = max(terms, key=terms.get)
    return terms[term], term


def split_device(argv):
    """``(device, rest)`` of a tool's argv: ``--device cpu|cuda`` (default
    cuda; no card raises, see :func:`resolve_device`) and the other
    arguments in order."""
    argv = list(argv)
    device = None
    if "--device" in argv:
        k = argv.index("--device")
        if k + 1 >= len(argv):
            raise SystemExit("--device needs cpu or cuda")
        device = argv[k + 1]
        del argv[k:k + 2]
    return resolve_device(device), argv


def timed_call(fn):
    """``(result, ms)`` of one call of ``fn``, timed between two CUDA
    events on the current stream after the card is idle."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def cuda_ms(fn, runs: int = 3, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``runs`` calls timed by
    :func:`timed_call`, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    return statistics.median(timed_call(fn)[1] for _ in range(runs))


def sm_clocks_mhz():
    """``(clocks.sm, clocks.max.sm)`` of card 0 in MHz as nvidia-smi reads
    them now."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    now, peak = res.stdout.strip().splitlines()[0].split(",")
    return float(now), float(peak)


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=1)
def max_sm_clock_mhz() -> float:
    """clocks.max.sm of card 0 in MHz, read once per process: the clock
    that the tools convert times to cycles at."""
    return sm_clocks_mhz()[1]


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
