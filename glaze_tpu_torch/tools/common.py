"""What the probe tools (and ``chip_smoke.py``) share: the ``--device``
flag, timing with CUDA events, the card's clocks, name and power limit."""

from __future__ import annotations

import functools
import statistics
import subprocess

import torch

from glaze_tpu_torch.device import resolve_device


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
