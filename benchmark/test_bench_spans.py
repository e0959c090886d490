"""The attribution of device time and idle gaps to the program's spans, on
synthetic Chrome traces, and a real CPU trace of the program."""

import json

import pytest

from benchmark import spans, trace


def _ann(name, s, e, tid=1):
    return {"cat": "user_annotation", "name": name, "ph": "X", "ts": s,
            "dur": e - s, "tid": tid}


def _launch(corr, ts, tid=1):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ph": "X",
            "ts": ts, "dur": 1.0, "tid": tid, "args": {"correlation": corr}}


def _kernel(name, corr, s, e, device=0):
    return {"cat": "kernel", "name": name, "ph": "X", "ts": s, "dur": e - s,
            "args": {"device": device, "correlation": corr}}


def _events():
    """A window 0..100 us. The host: integrator.launch 0..60 holding
    integrator.trace 10..20 and integrator.nee 31..40, then frame.copy
    70..80. The card: a walk launched in .trace, a kernel launched in
    .nee, one launched in the launch's own time, one in frame.copy, one
    launched outside any span and a copy with no launching call."""
    return [
        _ann("bench.window", 0.0, 100.0),
        _ann("integrator.launch", 0.0, 60.0),
        _ann("integrator.trace", 10.0, 20.0),
        _ann("integrator.nee", 31.0, 40.0),
        _ann("frame.copy", 70.0, 80.0),
        {"cat": "cpu_op", "name": "aten::mul", "ph": "X", "ts": 41.0,
         "dur": 5.0, "tid": 1},
        _launch(1, 12.0), _launch(2, 32.0), _launch(3, 25.0),
        _launch(4, 71.0), _launch(5, 90.0),
        _kernel("closest_kernel<true>", 1, 15.0, 25.0),
        _kernel("k_nee", 2, 35.0, 45.0),
        _kernel("k_launch", 3, 45.0, 50.0),
        _kernel("k_copy", 4, 75.0, 85.0),
        _kernel("k_out", 5, 95.0, 105.0),  # clipped to the window
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ph": "X", "ts": 60.0,
         "dur": 2.0, "args": {"device": 0, "correlation": 99}},
    ]


def test_kernels_land_in_the_innermost_span_of_their_launch():
    data = spans.SpanData(_events(), [0])
    d = dict(data.device_by_span)
    assert d["integrator.trace"] == pytest.approx(10e-6)
    assert d["integrator.nee"] == pytest.approx(10e-6)
    assert d["integrator.launch"] == pytest.approx(5e-6)
    assert d["frame.copy"] == pytest.approx(10e-6)
    # launched outside any span, and a copy whose call is not in the trace
    assert d[spans.OUTSIDE] == pytest.approx(7e-6)
    assert dict(data.walk_by_span) == {"integrator.trace": pytest.approx(
        10e-6)}
    assert data.prefixed(data.device_by_span, "integrator.") == \
        pytest.approx(25e-6)
    assert data.spans == 4 and data.window_s == pytest.approx(100e-6)


def test_device_time_by_span_adds_up_to_the_trace():
    ev = _events()
    data = spans.SpanData(ev, [0])
    td = trace.TraceData(ev, [0])
    ops = sum(s for _, s in td.breakdown["device_ops"])
    assert data.device_s == pytest.approx(ops)
    assert sum(data.device_by_span.values()) == pytest.approx(ops)


def test_gap_labels_follow_the_host_span():
    data = spans.SpanData(_events(), [0])
    idle = dict(data.idle_by_span)
    # busy: 15..25, 35..50, 60..62, 75..85, 95..100; the gaps' middles
    # 7.5, 30 and 55 lie in the launch's own time, 68.5 and 90 in none
    assert idle == {"integrator.launch": pytest.approx(35e-6),
                    spans.OUTSIDE: pytest.approx(23e-6)}
    assert sum(idle.values()) == pytest.approx(
        (1.0 - trace.TraceData(_events(), [0]).busy_s / 100e-6) * 100e-6)


def test_breakdown_keys_are_top_lists():
    got = spans.SpanData(_events(), [0]).breakdown()
    assert set(got) == {"device_ms_by_span", "idle_gaps_by_span"}
    for rows in got.values():
        secs = [s for _, s in rows]
        assert secs == sorted(secs, reverse=True) and len(rows) <= trace.TOP


def test_trace_data_is_unchanged_by_program_spans():
    """TraceData gives the same values on the same events with the program
    spans added."""
    ev = _events()
    bare = [e for e in ev if e.get("cat") != "user_annotation"
            or e["name"] == "bench.window"]
    a, b = trace.TraceData(ev, [0]), trace.TraceData(bare, [0])
    for k in ("window_s", "busy_s", "kernels", "walk_s", "busy_by_device",
              "breakdown"):
        assert getattr(a, k) == getattr(b, k), k


def test_spans_by_thread():
    """A launch is matched against its own thread's spans."""
    ev = [_ann("bench.window", 0.0, 100.0), _ann("a", 0.0, 50.0, tid=1),
          _ann("b", 10.0, 20.0, tid=2), _launch(1, 15.0, tid=1),
          _kernel("k", 1, 30.0, 40.0)]
    assert dict(spans.SpanData(ev, [0]).device_by_span) == {
        "a": pytest.approx(10e-6)}


def test_no_program_spans():
    """A trace without program spans (the program did not record) puts
    everything outside."""
    ev = [e for e in _events() if e.get("cat") != "user_annotation"
          or e["name"] == "bench.window"]
    data = spans.SpanData(ev, [0])
    assert data.spans == 0
    assert set(data.device_by_span) == {spans.OUTSIDE}
    assert set(data.idle_by_span) == {spans.OUTSIDE}


def test_cli_trace_of_the_program(tmp_path, capsys):
    """The CLI's ``--profile`` trace on the CPU: program spans, no device
    operation; ``python -m benchmark.spans`` reads it."""
    from glaze_tpu_torch import cli, scenes

    scene = tmp_path / "row.glaze"
    scenes.write_glaze(scenes.MatRowScene(), str(scene))
    code, _, _ = cli.run([str(scene), str(tmp_path / "o.png"), "--res",
                          "16x8", "--spp", "1", "--integrator", "direct",
                          "--device", "cpu", "--profile",
                          str(tmp_path / "p")])
    assert code == 0
    capsys.readouterr()
    assert spans.main([str(tmp_path / "p" / "trace.json")]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["program_spans"] >= 8 and out["device_s"] == 0.0
    assert out["window_s"] > 0


def test_program_numbers_from_summaries():
    from benchmark import record

    def span(total):
        return {"count": 1, "total_s": total, "self_s": total}

    setup = {"spans": {"setup.parse": span(0.25),
                       "setup.alpha_split": span(2.5)}, "counters": {}}
    window = {"spans": {"integrator.launch": span(7.2),
                        "render.sync": span(0.5),
                        "frame.present_wait": span(0.02),
                        "scene.edit": span(0.3)},
              "counters": {"integrator.launches": 100, "frame.presented": 4,
                           "scene.edits": 3, "render.restarts": 2,
                           "denoise.gbuffer_traces": 1}}
    got = record.program_numbers(setup, window, 10.0)
    assert got == pytest.approx({
        "integrator.host_ms_per_launch": 72.0, "render.sync_wait_pct": 5.0,
        "frame.present_wait_ms": 5.0, "edit.host_ms": 100.0,
        "render.restarts_per_frame": 0.5,
        "denoise.gbuffer_traces_per_frame": 0.25,
        "setup.parse_s": 0.25, "setup.alpha_split_s": 2.5})
    # nothing recorded (a run of a program without the spans): nothing read
    empty = {"spans": {}, "counters": {}}
    assert record.program_numbers(empty, empty, 10.0) == {}


@pytest.mark.parametrize("on", [True, False])
def test_a_recorded_run_on_the_cpu(on):
    """A tiny offline run of the material row with the recorder on gives
    the window's numbers; off, the same run gives none."""
    from benchmark import record
    from benchmark.conftest import row_cell

    cell = row_cell()
    cell.traffic["spp_per_draw"] = 1
    cell.config["width"], cell.config["height"] = 64, 32
    res = record.record(cell, 2147483999, 0.5, False, device="cpu", on=on)
    assert res["correct"] and "setup_s" in res["metrics"]
    if not on:
        assert "spans" not in res and "program" not in res
        return
    got = res["spans"]
    assert got["integrator.host_ms_per_launch"] > 0
    assert 0 <= got["render.sync_wait_pct"] < 100
    assert got["setup.parse_s"] > 0
    win = res["program"]["window"]
    assert win["counters"]["integrator.launches"] >= 1
    assert res["program"]["setup"]["spans"]["setup.flatten"]["count"] == 1
    assert "setup.flatten" not in win["spans"]
