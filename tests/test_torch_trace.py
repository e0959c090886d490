"""The port's recorder of spans and counters (``glaze_tpu_torch.utils.runtime``),
on the CPU.

* off, ``span`` is the shared no-op and reaches no torch profiler call, and
  ``count`` moves nothing;
* on, the spans keep their nesting, parents, self times and the counters,
  and export as Chrome trace JSON; without rows the same totals and no
  row; the traversal wrappers' ``.launches`` are reported as they moved;
* under a CPU ``torch.profiler``, each ``integrator.launch`` annotation
  encloses its launch's aten ops: the spans are on the profiler's clock;
* the set-up spans of a scene with an opacity map, the BVH cache's
  counters, pipelined ``RealtimeRenderer`` frames with an edit, the CLI's
  ``--profile`` files, and the CLI's render phase, which holds a resume's
  checkpoint load and keeps no row without ``--profile``;
* the benchmark's ``flatten_span`` still times the program's flatten.
"""

import contextlib
import json
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import glaze_tpu_torch.scenes as ps  # noqa: E402
from glaze_tpu_torch.parser import parse  # noqa: E402
from glaze_tpu_torch.utils import runtime  # noqa: E402
from glaze_tpu_torch.utils.runtime import count, recording, span  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_bvh import _random_soup  # noqa: E402
from test_torch_alpha import LaceScene  # noqa: E402


@pytest.fixture(scope="module")
def row_glaze(tmp_path_factory):
    path = tmp_path_factory.mktemp("scenes") / "row.glaze"
    ps.write_glaze(ps.MatRowScene(), str(path))
    return str(path)


def _raising(*a, **k):
    raise AssertionError("record_function reached while off")


def test_off_is_a_noop(monkeypatch):
    """No recording: the shared object, no torch call even under a running
    profiler, and no counter that a later recording sees."""
    from torch.profiler import ProfilerActivity, profile

    assert runtime._rec is None
    monkeypatch.setattr(torch.profiler, "record_function", _raising)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raising)

    @runtime.traced("t")
    def f(x):
        return x + 1

    with profile(activities=[ProfilerActivity.CPU]):
        assert span("a") is runtime.OFF and span("b") is runtime.OFF
        with span("a") as s:
            assert s is runtime.OFF
            count("c", 5)
        assert f(1) == 2
    monkeypatch.undo()
    with recording() as rec:
        pass
    got = rec.summary()
    assert got["spans"] == {} and got["counters"] == {}


def test_on_records_nesting_self_time_and_counters(tmp_path):
    with recording() as rec:
        with span("outer"):
            with span("inner"):
                time.sleep(0.02)
            with span("outer"):  # a span inside its own name
                time.sleep(0.01)
            count("c", 2)
        count("c")
        count("d", 0)
    assert runtime._rec is None
    rows = {r[0]: r for r in rec.spans if r[3] is None}
    inner = next(r for r in rec.spans if r[0] == "inner")
    assert inner[3] is rows["outer"]
    got = rec.summary()
    s = got["spans"]
    # the nested "outer" adds to neither the count nor the total
    assert s["outer"]["count"] == 1 and s["inner"]["count"] == 1
    outer_s = (rows["outer"][2] - rows["outer"][1]) * 1e-9
    assert s["outer"]["total_s"] == pytest.approx(outer_s)
    assert s["inner"]["total_s"] >= 0.02
    # self times add up to the root's duration; the root's own excludes
    # both children
    assert (s["outer"]["self_s"] + s["inner"]["self_s"]
            == pytest.approx(outer_s))
    assert s["outer"]["self_s"] >= 0.01
    assert s["outer"]["self_s"] < outer_s - 0.02
    assert got["counters"] == {"c": 3, "d": 0}
    assert got["seconds"] >= outer_s
    # a window: only the spans that start in it
    late = rec.summary(start_ns=inner[2])
    assert "inner" not in late["spans"] and late["spans"]["outer"]["count"] == 1
    assert late["counters"] == {"c": 3, "d": 0}

    path = tmp_path / "spans.json"
    rec.export(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert sorted(e["name"] for e in xs) == ["inner", "outer", "outer"]
    assert all(e["dur"] >= 0 and e["cat"] == "program_span" for e in xs)
    assert next(e for e in xs if e["name"] == "inner")["args"] == {
        "parent": "outer"}
    cs = [e for e in events if e["ph"] == "C"]
    assert [e["args"] for e in cs if e["name"] == "c"] == [{"c": 2}, {"c": 3}]


def _nested_spans():
    with span("outer"):
        with span("inner"):
            time.sleep(0.002)
        with span("outer"):
            pass
        count("c", 2)
    with span("inner"):
        pass
    count("c")


def test_without_rows_the_totals_stay_and_no_row_is_kept():
    """``recording(rows=False)`` keeps no row and no counter bump, and its
    summary equals the one a recording with rows gives of the same spans;
    a window's summary and the export need the rows."""
    with recording() as kept:
        _nested_spans()
    with recording(rows=False) as flat:
        _nested_spans()
    assert flat.spans == [] and flat.counts == []
    assert flat.summary()["counters"] == kept.summary()["counters"] == {
        "c": 3}
    got, want = flat.summary()["spans"], kept.summary()["spans"]
    assert set(got) == set(want) == {"outer", "inner"}
    assert got["outer"]["count"] == 1 and got["inner"]["count"] == 2
    # the whole recording's summary: the same totals read either way
    rows = kept.summary(start_ns=kept.start_ns)["spans"]
    for name in want:
        assert rows[name] == pytest.approx(want[name])
    with pytest.raises(ValueError):
        flat.summary(start_ns=flat.start_ns)


def test_walk_launches_reported_as_they_moved(monkeypatch):
    """The wrappers' ``.launches`` stay the one count of the walks; the
    summary reports how far they moved over the recording."""
    from glaze_tpu_torch.accel import traverse_cuda as tc

    monkeypatch.setattr(tc.closest_hit_soa, "launches", 7)
    monkeypatch.setattr(tc.any_hit_soa_masked, "launches",
                        tc.any_hit_soa_masked.launches)
    with recording() as rec:
        tc.closest_hit_soa.launches += 3
        tc.any_hit_soa_masked.launches += 1
    moved = rec.summary()["walk_launches"]
    assert moved["closest_hit_soa"] == 3 and moved["any_hit_soa_masked"] == 1
    assert set(moved) == {fn.__name__ for fn in tc.KERNEL_WRAPPERS}


def _trace_events(prof, tmp_path, name="t.json"):
    path = tmp_path / name
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_launch_spans_enclose_their_aten_ops(row_glaze, tmp_path):
    """Under a CPU profiler, the recorder's spans are user_annotations on
    the profiler's clock: every aten op between the first launch's start
    and the last launch's end lies inside an ``integrator.launch``, and
    each stage inside its launch."""
    from torch.profiler import ProfilerActivity, profile

    from glaze_tpu_torch.render.renderer import Integrator, RayTraceRenderer

    r = RayTraceRenderer(parse(row_glaze), width=16, height=8, seed=3,
                         device="cpu", integrator=Integrator.DIRECT)
    with recording() as rec, profile(activities=[ProfilerActivity.CPU]) \
            as prof:
        r.draw(2, return_image=False)
    events = _trace_events(prof, tmp_path)
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    launches = sorted((e["ts"], e["ts"] + e["dur"]) for e in ann
                      if e["name"] == "integrator.launch")
    assert len(launches) == 2 == rec.summary()["counters"][
        "integrator.launches"]
    assert rec.summary()["spans"]["integrator.launch"]["count"] == 2
    lo, hi = launches[0][0], launches[-1][1]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and lo <= e["ts"] <= hi]
    assert len(ops) > 50
    for e in ops:
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                   for a, b in launches), e["name"]
    for stage in ("camera", "trace", "shade", "nee", "bsdf"):
        got = [e for e in ann if e["name"] == f"integrator.{stage}"]
        assert len(got) == 2, stage
        for e in got:
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                       for a, b in launches), stage
    assert sum(e["name"] == "render.chunk" for e in ann) == 1
    assert sum(e["name"] == "render.sync" for e in ann) == 1


def test_setup_spans_of_a_scene_with_an_opacity_map():
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    with recording() as rec:
        r = RayTraceRenderer(LaceScene("torch"), width=16, height=8,
                             device="cpu")
        mats = list(r.host.materials)
        r.update_materials_and_lights(mats, r.host.lights)
    s = rec.summary()["spans"]
    for name in ("setup.flatten", "setup.parse", "setup.bvh",
                 "setup.alpha_split", "setup.upload", "scene.edit"):
        assert s[name]["count"] >= 1, name
    assert s["setup.flatten"]["count"] == 1
    # the split's own subset trees are builds inside it
    flat = s["setup.flatten"]["total_s"]
    assert s["setup.alpha_split"]["total_s"] < flat
    assert s["setup.bvh"]["total_s"] < flat
    assert rec.summary()["counters"]["scene.edits"] == 1


def test_bvh_cache_counters(tmp_path, monkeypatch):
    from glaze_tpu_torch.accel import bvh as tb

    monkeypatch.setenv("GLAZE_CACHE_DIR", str(tmp_path))
    tri, _ = _random_soup(tb.CACHE_MIN_TRIS + 10, seed=61)
    small, _ = _random_soup(100, seed=62)
    with recording() as rec:
        tb.build_bvh_np(tri)
        tb.build_bvh_np(tri)
        tb.build_bvh_np(small)  # below the cache's size: neither
    assert rec.summary()["counters"] == {"bvh.cache_miss": 1,
                                         "bvh.cache_hit": 1}
    assert rec.summary()["spans"]["setup.bvh"]["count"] == 3


def test_pipelined_frames_with_an_edit(row_glaze):
    """Pipelined, denoised RealtimeRenderer frames with one material edit:
    the frame, filter, present and edit spans, and counters that equal the
    frames and edits driven."""
    from glaze_tpu_torch.render.realtime import RealtimeRenderer

    rr = RealtimeRenderer(parse(row_glaze), width=16, height=16, seed=4,
                          device="cpu")
    rr.denoise = True
    frames = 5
    with recording() as rec:
        for k in range(frames):
            if k == 2:
                mat = rr.materials()[1]
                mat.diffuse_mul = (200, 120, 60)
                rr.change_material(1, mat)
            rr.draw_frame(pipelined=True)
    got = rec.summary()
    s, c = got["spans"], got["counters"]
    assert s["frame"]["count"] == frames
    assert s["frame.present_wait"]["count"] == frames
    assert s["frame.copy"]["count"] == frames
    assert s["denoise.filter"]["count"] == frames
    assert s["scene.edit"]["count"] == 1
    assert s["integrator.launch"]["count"] == frames
    assert c["frame.presented"] == frames
    assert c["integrator.launches"] == frames
    assert c["scene.edits"] == 1
    # the first frame and the edit restart the accumulation
    assert c["render.restarts"] == 2
    # each frame holds its launch and its display
    assert s["frame"]["total_s"] >= (s["integrator.launch"]["total_s"]
                                     + s["denoise.filter"]["total_s"])


def test_cli_profile_carries_the_spans(row_glaze, tmp_path, capsys):
    """``--profile`` writes the profiler's trace with the program's spans
    and the recorder's spans and counters of the whole run; the phase lines
    come from spans."""
    from glaze_tpu_torch import cli

    prof = tmp_path / "prof"
    code, _, t = cli.run([row_glaze, str(tmp_path / "o.png"), "--res",
                          "16x8", "--spp", "1", "--integrator", "direct",
                          "--device", "cpu", "--profile", str(prof)])
    err = capsys.readouterr().err
    assert code == 0
    assert runtime._rec is None
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"render.chunk", "integrator.launch",
            "integrator.trace"} <= names
    spans = json.loads((prof / cli.SPANS_FILE).read_text())["traceEvents"]
    got = {e["name"] for e in spans if e["ph"] == "X"}
    assert {"cli.parse", "setup.parse", "cli.setup", "setup.flatten",
            "setup.bvh", "setup.upload", "cli.render", "cli.save"} <= got
    line = next(ln for ln in err.splitlines() if ln.startswith("Phases:"))
    assert [p.split("=")[0] for p in line[len("Phases:"):].split()] == [
        "parse", "upload+bvh", "render", "save"]
    assert t["render"] > 0 and t["setup"] > 0
    assert t["render"] == pytest.approx(next(
        e["dur"] for e in spans if e["name"] == "cli.render") / 1e3)


def test_cli_render_phase(row_glaze, tmp_path, monkeypatch, capsys):
    """Without ``--profile`` the CLI's recorder keeps no row; its render
    phase, ``cli.render``, holds a resume's checkpoint load as well as the
    launches."""
    from glaze_tpu_torch import cli, utils
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    recs = []
    opened = utils.recording

    @contextlib.contextmanager
    def noted(rows=True):
        with opened(rows) as rec:
            recs.append(rec)
            yield rec

    monkeypatch.setattr(utils, "recording", noted)
    load = RayTraceRenderer.load_checkpoint

    def traced_load(self, *a, **k):
        with span("test.load"):
            return load(self, *a, **k)

    monkeypatch.setattr(RayTraceRenderer, "load_checkpoint", traced_load)
    ckpt = str(tmp_path / "c.npz")
    argv = [row_glaze, str(tmp_path / "o.png"), "--res", "16x8",
            "--integrator", "direct", "--device", "cpu",
            "--checkpoint", ckpt]
    code, _, first = cli.run(argv + ["--spp", "1"])
    assert code == 0 and not recs[0].rows
    assert recs[0].spans == [] and recs[0].counts == []
    s = recs[0].summary()["spans"]
    assert first["render"] == pytest.approx(s["cli.render"]["total_s"] * 1e3)
    assert s["integrator.launch"]["count"] == first["launches"]
    # the resume: the checkpoint's load is a part of the render phase
    prof = tmp_path / "prof"
    code, _, second = cli.run(argv + ["--spp", "2", "--profile", str(prof)])
    assert code == 0 and recs[1].rows
    capsys.readouterr()
    loaded = next(r for r in recs[1].spans if r[0] == "test.load")
    assert loaded[3] is not None and loaded[3][0] == "cli.render"


def test_benchmark_flatten_span_still_times_the_flatten(row_glaze):
    """The benchmark patches ``flatten_scene_np`` by its module attribute:
    the program still calls it through that attribute, and the harness's
    time holds the program's own span."""
    from benchmark import drive

    from glaze_tpu_torch.render.renderer import RayTraceRenderer
    from glaze_tpu_torch.scene import flatten as fl

    run = drive.Run(None, 0, 1.0, False)
    orig = fl.flatten_scene_np
    with recording() as rec, drive.flatten_span(run):
        RayTraceRenderer(parse(row_glaze), width=8, height=8, device="cpu")
    assert fl.flatten_scene_np is orig
    outside = run.spans["setup.flatten_s"]
    inside = rec.summary()["spans"]["setup.flatten"]["total_s"]
    assert 0 < inside <= outside
    assert np.isfinite(outside)
