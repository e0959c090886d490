"""A run of a cell with the program's recorder on, and the numbers its
spans and counters give.

    python -m benchmark.record --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--record <0|1>]

runs the cell as ``benchmark.run`` does (the same set-up, window and
check) inside ``glaze_tpu_torch.utils.runtime.recording()``, and prints
one JSON line: the cell's end-to-end metrics and checks, ``program`` (the
recorder's summaries of the set-up, up to the first timed launch, and of
the window) and ``spans`` (the numbers :func:`program_numbers` reads from
them). ``--record 0`` makes the same run without the recorder, the other
half of a measurement of its cost.

With ``--trace 1`` it prints the set-up's numbers and ``attribution``,
what :class:`benchmark.spans.SpanData` reads of the traced segment, and
leaves the window's host numbers out: the window follows the profiled
segment and still pays the profiler's cost (PERF.md §6).

A stopgap: :mod:`benchmark.drive` keeps no recorder, so the window's
start is taken here as the run's first synchronisation, which ends the
warm-up. The benchmark change of PERF.md §7 item 6, which has
``drive.run_cell`` keep the summaries on ``Run.program``, deletes this
module.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def program_numbers(setup: dict, window: dict, window_s: float) -> dict:
    """The numbers of the recorder's summaries (``Recorder.summary()``
    of the set-up and of the window) that PERF.md §3 names, each left out
    where its spans or counters are missing."""
    ws, wc = window["spans"], window["counters"]
    out = {}

    def total(name):
        return ws[name]["total_s"] if name in ws else 0.0

    if wc.get("integrator.launches"):
        out["integrator.host_ms_per_launch"] = (
            1e3 * total("integrator.launch") / wc["integrator.launches"])
    if "render.sync" in ws and window_s:
        out["render.sync_wait_pct"] = 100.0 * total("render.sync") / window_s
    frames = wc.get("frame.presented")
    if frames:
        out["frame.present_wait_ms"] = (
            1e3 * total("frame.present_wait") / frames)
        # the share of frames that restart the accumulation, and of those
        # that trace the denoiser's G-buffer anew: the frames of the tail
        out["render.restarts_per_frame"] = wc.get("render.restarts",
                                                  0) / frames
        out["denoise.gbuffer_traces_per_frame"] = wc.get(
            "denoise.gbuffer_traces", 0) / frames
    if wc.get("scene.edits"):
        out["edit.host_ms"] = 1e3 * total("scene.edit") / wc["scene.edits"]
    for name in ("setup.parse", "setup.alpha_split"):
        if name in setup["spans"]:
            out[name + "_s"] = setup["spans"][name]["total_s"]
    return out


def attribution(events: list, devices: list, run) -> dict:
    """What the traced segment's program spans say (:mod:`benchmark.spans`):
    the device time and idle time by span, the walks under
    ``integrator.trace`` and ``integrator.nee`` against all the walks, and
    the shares of the device time and of the idle time outside any program
    span; per traced sample or frame where it says so."""
    from benchmark import spans

    data = spans.SpanData(events, devices)
    idle = sum(data.idle_by_span.values())
    n = run.traced_frames or run.traced_samples
    walks = (data.walk_by_span.get("integrator.trace", 0.0)
             + data.walk_by_span.get("integrator.nee", 0.0))
    out = {"program_spans": data.spans, "device_s": data.device_s,
           "walk_ms_trace_nee": 1e3 * walks / n,
           "walk_ms_all": 1e3 * run.trace.walk_s / n,
           "device_outside_share": (
               data.device_by_span.get(spans.OUTSIDE, 0.0) / data.device_s
               if data.device_s else None),
           "idle_outside_share": (data.idle_by_span.get(spans.OUTSIDE, 0.0)
                                  / idle if idle else None),
           "device_by_span": dict(data.device_by_span),
           "idle_by_span": dict(data.idle_by_span),
           **data.breakdown()}
    if run.traced_frames:
        out["denoise.device_ms_per_frame"] = 1e3 * data.prefixed(
            data.device_by_span, "denoise.") / n
    return out


@contextlib.contextmanager
def _first_sync(marks: dict):
    """Notes the run's first synchronisation (``perf_counter_ns``), the
    end of its warm-up, in ``marks["first_sync"]``."""
    from benchmark import drive

    sync = drive._sync

    def noted_sync(devices):
        sync(devices)
        marks.setdefault("first_sync", time.perf_counter_ns())

    drive._sync = noted_sync
    try:
        yield
    finally:
        drive._sync = sync


def record(cell, seed: int, seconds: float, trace: bool, device="cuda",
           on: bool = True, t_start=None) -> dict:
    """One run of ``cell`` (recorded unless ``on`` is False): what
    :func:`main` prints."""
    from benchmark import drive
    from glaze_tpu_torch.utils.runtime import recording

    marks = {}
    with _first_sync(marks), \
            (recording() if on else contextlib.nullcontext()) as rec:
        run, out, checks = drive.run_cell(cell, seed, seconds, trace,
                                          device=device, t_start=t_start)
    res = {"workload": cell.name, "seed": seed, "trace": int(trace),
           "record": int(on), "correct": drive.correct(checks),
           "metrics": drive.metric_values(cell, run, False),
           "checks": {k: v for k, (v, _) in checks.items()},
           "window_s": run.window_s}
    if trace:
        res["per_layer"] = drive.metric_values(cell, run, True)
    if rec is None:
        return res
    w0 = marks["first_sync"]
    setup = rec.summary(end_ns=w0)
    res["program"] = {"setup": setup,
                      "walk_launches": rec.summary()["walk_launches"]}
    window = {"spans": {}, "counters": {}}
    if not trace:
        window = res["program"]["window"] = rec.summary(
            start_ns=w0, end_ns=w0 + int(run.window_s * 1e9))
    res["spans"] = program_numbers(setup, window, run.window_s)
    if trace:
        from benchmark.trace import TRACE_DIR

        with open(os.path.join(TRACE_DIR, f"{cell.name}.json")) as f:
            events = json.load(f)["traceEvents"]
        res["attribution"] = attribution(
            events, [d.index for d in out["devices"]], run)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.record")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    import torch

    from benchmark import cells

    cell = cells.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    res = record(cell, args.seed, args.seconds, bool(args.trace),
                 on=bool(args.record), t_start=T_START)
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
