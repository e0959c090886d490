"""The registry finds configurations, traffic mixes and metrics by name,
and a new cell is new files plus new BENCHMARK.json entries."""

import json
import os
import shutil

from benchmark import cells, drive

ROOT = cells.ROOT


def test_every_cell_resolves():
    spec = cells.load_spec(os.path.join(ROOT, "BENCHMARK.json"))
    for w in spec["workloads"]:
        cell = cells.Cell(w["name"], spec)
        assert cell.traffic["kind"] in ("offline", "interactive")
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.reader(m["name"]))
        assert set(drive.limits(cell)) >= {"lanes_apart_pct", "count_off"}


def test_every_config_is_used_and_files_exist():
    spec = cells.load_spec(os.path.join(ROOT, "BENCHMARK.json"))
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert c["name"] in used
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


def test_throwaway_cell_is_files_and_entries(tmp_path):
    """A cell on a new configuration, a new traffic mix and a new metric,
    added as files beside copies of the benchmark's and one entry each."""
    home = tmp_path / "benchmark"
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(cells.HERE, d), home / d)
    (home / "configs" / "tiny_row.json").write_text(json.dumps(
        {"name": "tiny_row", "scene": "matrow", "width": 64, "height": 32,
         "integrator": "pt", "mesh": None, "reduced": []}))
    (home / "traffic" / "short_draws.json").write_text(json.dumps(
        {"kind": "offline", "warmup_spp": 1, "spp_per_draw": 2,
         "trace_spp": 1}))
    (home / "metrics" / "launches_done.py").write_text(
        "def read(run):\n    return run.launches or None\n")
    spec = cells.load_spec(os.path.join(ROOT, "BENCHMARK.json"))
    spec["configs"].append({"name": "tiny_row", "source": "x",
                            "file": "benchmark/configs/tiny_row.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny_row.short_draws",
                              "config": "tiny_row",
                              "traffic": "short_draws", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "launches_done", "unit": "launches",
                              "better": "higher", "source": "host_clock",
                              "layer": "integrator", "moves": "samples_per_s",
                              "workloads": ["tiny_row.short_draws"]})
    spec["end_to_end"][0]["workloads"].append("tiny_row.short_draws")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.Cell("tiny_row.short_draws", root=str(tmp_path))
    assert cell.config["width"] == 64 and cell.traffic["spp_per_draw"] == 2
    assert [m["name"] for m in cell.per_layer] == ["launches_done"]
    assert {m["name"] for m in cell.end_to_end} == {"samples_per_s",
                                                    "setup_s"}
    run = drive.Run(cell, 1, 1.0, True)
    run.launches = 12
    assert drive.metric_values(cell, run, True) == {
        "launches_done": {"value": 12.0, "unit": "launches"}}
