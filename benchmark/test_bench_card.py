"""A short run of every one-card cell on the card, end to end."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import cells


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sponza_1080.offline",
                                  "sponza_1080.interactive"])
def test_cell_runs_correct_on_the_card(card, cell):
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", "2147483999", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=cells.ROOT,
        env=dict(os.environ))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
