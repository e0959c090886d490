import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips on machines without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def row_cell():
    """An offline cell on the material row (``configs/mattest_512.json``,
    kept out of BENCHMARK.json) for the CPU tests: the benchmark's entries
    with one for it added."""
    from benchmark import cells

    spec = cells.load_spec(os.path.join(ROOT, "BENCHMARK.json"))
    spec["configs"].append({"name": "mattest_512",
                            "file": "benchmark/configs/mattest_512.json",
                            "reduced": []})
    spec["workloads"].append({"name": "mattest_512.offline",
                              "config": "mattest_512", "traffic": "offline",
                              "chips": 1})
    return cells.Cell("mattest_512.offline", spec)
