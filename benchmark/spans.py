"""The device's work and idle time of a Chrome trace, put down to the
program's spans.

The program (``glaze_tpu_torch``) marks its layers with spans
(``glaze_tpu_torch.utils.runtime.span``). While a recording is open
under ``torch.profiler``, each lands in the profiler's trace as a
``user_annotation`` event, on the host clock of the device events. Of a
trace that holds them this module gives:

- each kernel, copy or fill's device time, put down to the innermost
  program span that holds the CUDA runtime call that launched it, matched
  by ``args.correlation``;
- each idle gap of the first card, put down to the innermost program span
  open on the host at the gap's middle.

Time that no program span holds is put down to ``OUTSIDE``, so the
device time by span adds up to all the device time. The stretch read is
the ``bench.window`` annotation of a traced segment (:mod:`benchmark.trace`),
else the stretch the program spans cover; device time is clipped to it
as :class:`benchmark.trace.TraceData` clips it.

    python -m benchmark.spans TRACE.json [--device N]

prints the breakdown of a trace as JSON: a traced segment's
``cache/traces/<cell>.json`` from a run that recorded the program's spans,
or the CLI's ``--profile DIR`` trace ``DIR/trace.json``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict

from benchmark.trace import DEVICE_CATS, TOP, WALK_KERNELS, gaps

OUTSIDE = "outside any program span"
# the benchmark's own annotations, which are not the program's
BENCH_SPANS = ("bench.window",)
# the host calls that launch device work, which carry its correlation id
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def program_spans(events) -> list:
    """``(start, end, name, tid)`` of the trace's program spans (the
    ``user_annotation`` events other than the benchmark's), in
    microseconds, sorted by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"], e.get("tid"))
                  for e in events
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                  and e.get("name") not in BENCH_SPANS)


class Innermost:
    """The innermost of properly nested spans that holds a time: of the
    spans that hold it, the one that started last."""

    def __init__(self, spans):
        self._spans = spans
        self._starts = [s[0] for s in spans]
        by_tid = defaultdict(list)
        for s in spans:
            by_tid[s[3]].append(s)
        self._tids = {t: Innermost(v) for t, v in by_tid.items()} \
            if len(by_tid) > 1 else None

    def at(self, t: float, tid=None) -> str:
        """The name of the innermost span holding ``t`` (on thread ``tid``
        where given), else :data:`OUTSIDE`."""
        if tid is not None and self._tids is not None:
            inner = self._tids.get(tid)
            return inner.at(t) if inner is not None else OUTSIDE
        for i in range(bisect.bisect_right(self._starts, t) - 1, -1, -1):
            if self._spans[i][1] >= t:
                return self._spans[i][2]
        return OUTSIDE


class SpanData:
    """What a trace's program spans say of its device time, in seconds:
    ``device_s`` (all device operations in the stretch), ``device_by_span``
    and ``walk_by_span`` (the traversal kernels) by innermost span,
    ``idle_by_span`` (the first card's idle gaps by the host's innermost
    span), ``window_s`` and ``spans`` (the count of program spans)."""

    def __init__(self, events: list, devices: list[int] | None = None):
        spans = program_spans(events)
        self.spans = len(spans)
        win = next((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == "bench.window"), None)
        if win is not None:
            lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
        elif spans:
            lo, hi = spans[0][0], max(s[1] for s in spans)
        else:
            lo = hi = 0.0
        inner = Innermost(spans)
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    launch[c] = (float(e["ts"]), e.get("tid"))
        by_dev = defaultdict(list)
        self.device_by_span = defaultdict(float)
        self.walk_by_span = defaultdict(float)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            s = max(float(e["ts"]), lo)
            t = min(float(e["ts"]) + float(e["dur"]), hi)
            if t <= s:
                continue
            by_dev[int(e.get("args", {}).get("device", 0))].append((s, t))
            call = launch.get(e.get("args", {}).get("correlation"))
            name = OUTSIDE if call is None else inner.at(*call)
            self.device_by_span[name] += (t - s) * 1e-6
            if e["cat"] == "kernel" and any(k in e["name"]
                                            for k in WALK_KERNELS):
                self.walk_by_span[name] += (t - s) * 1e-6
        self.device_s = sum(self.device_by_span.values())
        self.window_s = (hi - lo) * 1e-6
        if devices is None:
            devices = sorted(by_dev) or [0]
        self.idle_by_span = defaultdict(float)
        for a, b in gaps(by_dev.get(devices[0], []), lo, hi):
            self.idle_by_span[inner.at(0.5 * (a + b))] += (b - a) * 1e-6

    def prefixed(self, table: dict, prefix: str) -> float:
        """The seconds of ``table`` (``device_by_span`` ...) under the
        spans whose names start with ``prefix``."""
        return sum(v for k, v in table.items() if k.startswith(prefix))

    def breakdown(self) -> dict:
        """The two breakdown lists, top ``TOP`` by seconds, as
        :class:`benchmark.trace.TraceData`'s: ``device_ms_by_span`` and
        ``idle_gaps_by_span``."""
        def top(table):
            return [[n, s] for n, s in
                    sorted(table.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ms_by_span": top(self.device_by_span),
                "idle_gaps_by_span": top(self.idle_by_span)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.spans")
    p.add_argument("trace", help="a Chrome trace JSON of torch.profiler")
    p.add_argument("--device", type=int, default=None,
                   help="the card whose idle gaps are read (default: the "
                        "first that ran an operation)")
    args = p.parse_args(argv)
    with open(args.trace) as f:
        events = json.load(f)["traceEvents"]
    data = SpanData(events, None if args.device is None else [args.device])
    out = {"program_spans": data.spans, "window_s": data.window_s,
           "device_s": data.device_s,
           "walk_by_span": dict(data.walk_by_span),
           "idle_s": sum(data.idle_by_span.values()),
           **data.breakdown()}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
