"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program; top-level module names are
compared whole (``glaze_tpu_torch`` begins with ``glaze_tpu``)."""

import ast
import os
import subprocess
import sys

from benchmark import cells
from benchmark.run import FORBIDDEN

HERE = cells.HERE
REFERENCE = [os.path.join(HERE, "reference.py"), os.path.join(HERE,
                                                              "schedule.py")]
for d, _, files in os.walk(os.path.join(HERE, "ref")):
    REFERENCE += [os.path.join(d, f) for f in files if f.endswith(".py")]


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py") and not f.startswith("test_"):
                path = os.path.join(d, f)
                assert not set(_imported(path)) & set(FORBIDDEN), path


def test_reference_sources_import_nothing_of_the_program():
    for path in REFERENCE:
        assert "glaze_tpu_torch" not in set(_imported(path)), path


_RUN = """
import sys
sys.path.insert(0, {root!r})
from benchmark import drive, run
from benchmark.conftest import row_cell
cell = row_cell()
cell.config["width"], cell.config["height"] = 64, 32
cell.traffic["spp_per_draw"] = 1
r, out, checks = drive.run_cell(cell, 5, 0.5, False, device="cpu")
assert drive.correct(checks), checks
print(sorted(run.forbidden_modules()))
"""

_REF = """
import sys
sys.path.insert(0, {root!r})
from benchmark import drive, reference
ref = reference.Scene(drive.scene_file({{"scene": "matrow"}}), "cpu")
lanes = reference.sample_lanes(64, 32, 3, 50)
reference.replay_offline(ref, 64, 32, 3, [(1, 6)], lanes,
                         [{{"begin": 0, "end": 6, "state": None}}])
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"glaze_tpu_torch", "glaze_tpu", "jax", "jaxlib", "flax"}}))
"""


def _child(code):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c",
                          code.format(root=cells.ROOT)],
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    assert _child(_RUN) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    assert _child(_REF) == "[]"
