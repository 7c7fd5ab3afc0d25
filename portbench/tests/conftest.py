"""Shared pieces of the benchmark's own tests (``python -m pytest
portbench/tests -q`` from the repository's root; the CPU ones need no card).

``small_cell(workload)`` loads a cell of ``BENCHMARK.json`` cut to a size
the CPU renders in seconds: 4 voices, a 0.25 s IR, 0.4 s offline calls.
The ``cuda`` marker marks tests that need the card; they decide in a
fixture (``card``), never while the module is imported.
"""

from __future__ import annotations

import pytest

from portbench.cell import ROOT, load_cell, load_json

#: every cell of BENCHMARK.json
WORKLOADS = tuple(w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"])
SMALL_CONFIG = {"voices": 4, "ir_seconds": 0.25}
# an offline call of at least two superblocks always holds a whole one to compare
SMALL_TRAFFIC = {"offline_render": {"call_seconds": 0.4}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


def shrink(cell):
    """``cell`` with its configuration and mix cut to SMALL_* (in place)."""
    cell.cfg = dict(cell.cfg, **SMALL_CONFIG)
    cell.traffic = dict(cell.traffic, **SMALL_TRAFFIC.get(cell.traffic["call"], {}))
    return cell


@pytest.fixture
def small_cell():
    return lambda workload: shrink(load_cell(workload))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card tests run on the chip")
    return torch.device("cuda")
