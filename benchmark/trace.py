"""The traced segment of a ``--trace 1`` run: ``torch.profiler`` over a
stretch of the window, reduced to device time.

The segment lies inside a ``bench.window`` annotation, between two
synchronisations of every card the cell uses, so every device operation
it issues ends inside it. The trace is written as Chrome trace JSON to
``benchmark/cache/traces/`` (one fixed file a cell, overwritten) and read
back: kernels, copies and fills are device activity; a card's busy time
is the union of its intervals.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

import torch

from benchmark.cells import HERE

TRACE_DIR = os.path.join(HERE, "cache", "traces")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the traversal kernels of glaze_tpu_torch/csrc/traverse.cu, by name
WALK_KERNELS = ("closest_kernel", "anyhit_kernel")
TOP = 10


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo, hi):
    """The uncovered stretches of [lo, hi] between ``intervals``."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class TraceData:
    """What a traced segment's trace holds, in seconds: ``window_s``,
    ``busy_s`` (mean over the cards), ``kernels`` (launch count),
    ``walk_s`` (the traversal kernels), and the ``breakdown``."""

    def __init__(self, events: list, devices: list[int]):
        win = next(e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == "bench.window")
        lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
        by_dev = defaultdict(list)
        by_name = defaultdict(float)
        self.kernels = 0
        walk = 0.0
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            s = max(float(e["ts"]), lo)
            t = min(float(e["ts"]) + float(e["dur"]), hi)
            if t <= s:
                continue
            by_dev[int(e.get("args", {}).get("device", 0))].append((s, t))
            by_name[e["name"][:160]] += (t - s) * 1e-6
            if e["cat"] == "kernel":
                self.kernels += 1
                if any(k in e["name"] for k in WALK_KERNELS):
                    walk += t - s
        self.window_s = (hi - lo) * 1e-6
        busy = [union_length(by_dev.get(d, [])) * 1e-6 for d in devices]
        self.busy_by_device = busy
        self.busy_s = sum(busy) / len(busy)
        self.walk_s = walk * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        idle = defaultdict(float)
        cpu = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events
                     if e.get("cat") == "cpu_op" and e.get("ph") == "X")
        starts = [c[0] for c in cpu]
        for a, b in gaps(by_dev.get(devices[0], []), lo, hi):
            mid = 0.5 * (a + b)
            label = "host outside any torch op"
            # the innermost torch op running on the host at the gap's middle
            k = bisect.bisect_right(starts, mid)
            for s, t, name in reversed(cpu[max(0, k - 200):k]):
                if t >= mid:
                    label = name
                    break
            idle[label[:160]] += (b - a) * 1e-6
        self.breakdown = {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]}


    def idle_pct(self):
        if not self.window_s:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)


class Segment:
    """Profiles what runs inside it on ``devices`` (CUDA indices) and
    leaves a :class:`TraceData` in ``data``."""

    def __init__(self, name: str, devices: list[int]):
        self.name = name
        self.devices = devices
        self.data = None

    def _sync(self):
        for d in self.devices:
            torch.cuda.synchronize(d)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark = record_function("bench.window")
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        os.makedirs(TRACE_DIR, exist_ok=True)
        path = os.path.join(TRACE_DIR, f"{self.name}.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.data = TraceData(events, self.devices)
        return False
