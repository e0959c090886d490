"""The benchmark's registry: ``BENCHMARK.json`` at the checkout's root
names the cells, and each cell's configuration, traffic mix and metrics
are files found by name:

- ``configs/<config>.json``: the configuration as it is run (the file
  that ``BENCHMARK.json``'s ``configs[].file`` names);
- ``traffic/<traffic>.json``: the traffic mix's parameters, read by the
  loop of its ``kind`` (:mod:`benchmark.drive`);
- ``metrics/<metric>.py``: one reader a metric, ``read(run)``, which
  returns the metric's value from a :class:`benchmark.drive.Run`, or None
  where the run has nothing for it to read. A metric split by the
  end-to-end metric it moves (``device_idle_pct.offline``,
  ``device_idle_pct.interactive``) may share the reader of its base name
  (``metrics/device_idle_pct.py``).

A new cell, configuration, traffic mix or metric is new files and new
entries in ``BENCHMARK.json``: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_spec(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, home: str = HERE):
    """The ``read`` function of ``<home>/metrics/<name>.py`` or, for a
    quantity split by the end-to-end metric it moves (such as
    ``device_idle_pct.interactive``), of the file named without the last
    dotted parts (``device_idle_pct.py``)."""
    stem = name
    while not os.path.exists(os.path.join(home, "metrics", f"{stem}.py")):
        if "." not in stem:
            raise FileNotFoundError(f"no reader for the metric {name!r}")
        stem = stem.rsplit(".", 1)[0]
    path = os.path.join(home, "metrics", f"{stem}.py")
    mod_name = "benchmark.metrics." + stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, cell: str, group: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those that list it under ``workloads``, and those without a list
    (per-layer ones where the cell reports the end-to-end metric they
    move)."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in spec[group]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


class Cell:
    """One ``workloads`` entry of ``BENCHMARK.json`` with its files read:
    ``config`` and ``traffic`` (dicts), ``chips``, and the metrics it
    reports (``end_to_end``, ``per_layer``)."""

    def __init__(self, name: str, spec: dict | None = None,
                 root: str = ROOT):
        spec = spec if spec is not None else load_spec(
            os.path.join(root, "BENCHMARK.json"))
        entry = next((w for w in spec["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
        self.name = name
        self.chips = int(entry["chips"])
        self.config_name = conf["name"]
        self.home = os.path.join(root, "benchmark")
        self.config = _json(os.path.join(root, conf["file"]))
        self.traffic_name = entry["traffic"]
        self.traffic = _json(os.path.join(self.home, "traffic",
                                          f"{entry['traffic']}.json"))
        self.end_to_end = metrics_of(spec, name, "end_to_end")
        self.per_layer = metrics_of(spec, name, "per_layer")
