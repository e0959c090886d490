"""The metric arithmetic on synthetic numbers."""

import numpy as np
import pytest

from benchmark import cells, trace
from benchmark.drive import Run


def _run(**kw):
    run = Run(None, 1, 1.0, False)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_union_counts_overlaps_once():
    assert trace.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert trace.union_length([]) == 0.0
    assert trace.gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [
        (0, 1), (3, 4), (5, 6)]


def _events(kernels, window=(0.0, 100.0), device=0):
    ev = [{"cat": "user_annotation", "name": "bench.window", "ph": "X",
           "ts": window[0], "dur": window[1] - window[0]},
          {"cat": "cpu_op", "name": "aten::add", "ph": "X", "ts": 55.0,
           "dur": 10.0}]
    for name, s, e in kernels:
        ev.append({"cat": "kernel", "name": name, "ph": "X", "ts": s,
                   "dur": e - s, "args": {"device": device}})
    return ev


def test_idle_share_is_a_union():
    ev = _events([("k", 0, 40), ("k", 20, 50), ("closest_kernel<true>", 70,
                                                 80), ("k", 95, 120)])
    data = trace.TraceData(ev, [0])
    # busy: [0, 50] + [70, 80] + [95, 100] (clipped to the window)
    assert data.busy_s == pytest.approx(65e-6)
    assert data.window_s == pytest.approx(100e-6)
    assert data.idle_pct() == pytest.approx(35.0)
    assert data.walk_s == pytest.approx(10e-6)
    assert data.kernels == 4
    gaps = dict(data.breakdown["idle_gaps"])
    assert gaps["aten::add"] == pytest.approx(20e-6)
    assert cells.reader("device_idle_pct.offline")(_run(trace=data)) == \
        pytest.approx(35.0)


def test_idle_share_means_over_cards():
    ev = _events([("k", 0, 100)], device=0) + _events([("k", 0, 50)],
                                                      device=1)[2:]
    data = trace.TraceData(ev, [0, 1])
    assert data.idle_pct() == pytest.approx(25.0)


def test_p95_is_over_all_frames():
    iv = [0.1] * 190 + [0.3] * 10
    run = _run(intervals=iv, window_s=sum(iv))
    p95 = cells.reader("frame_ms_p95")(run)
    assert p95 == pytest.approx(float(np.percentile(np.asarray(iv) * 1e3,
                                                    95)))
    assert 100.0 <= p95 <= 300.0
    assert cells.reader("frame_ms")(run) == pytest.approx(1e3 * sum(iv) / 200)


def test_samples_per_s_from_launches():
    run = _run(pixels=1920 * 1080, launches=384, launches_per_sample=6,
               window_s=32.0)
    assert cells.reader("samples_per_s")(run) == pytest.approx(
        1920 * 1080 * 64 / 32.0 / 1e6)
    assert cells.reader("samples_per_s")(_run(launches=0)) is None


def test_readers_without_a_trace_return_nothing():
    run = _run()
    for name in ("integrator.kernels_per_sample", "frame.kernels_per_frame",
                 "traverse.device_ms_per_sample", "traverse_roofline",
                 "device_idle_pct.interactive"):
        assert cells.reader(name)(run) is None
