"""Tests of the benchmark harness. They run on the CPU at tiny sizes; the
ones marked ``gpu`` need a CUDA card and skip themselves without one:

    python -m pytest port_bench/tests -q            # here
    python3 -m pytest port_bench/tests -q -m gpu    # on the card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; the test skips itself without one")


# a cell cut to a size the CPU runs in seconds: 6 points, 2 steps of 512
# frames a point, every point checked
TINY_CONFIG = {"frames_per_point": 1024,
               "ebn0_db": {"start": -1.0, "stop": 4.0, "step": 1.0}}
TINY_TRAFFIC = {"frames_per_step": 512, "check_points": 6}


@pytest.fixture
def tiny_cell():
    """A loader of a cell of BENCHMARK.json cut to the tiny size."""
    from port_bench.harness.manifest import Manifest

    def load(name):
        cell = Manifest(ROOT).cell(name)
        cell.config = {**cell.config, **TINY_CONFIG}
        cell.traffic = {**cell.traffic, **TINY_TRAFFIC}
        return cell

    return load
