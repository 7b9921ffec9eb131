"""Shared fixtures of the benchmark's tests: the cells of the repository's
BENCHMARK.json, and the SKFlow cell kept out of it, cut to a size the CPU
runs in seconds (the same files, traffic parameters overridden), and the
``card`` marker for tests that need a CUDA device (they skip inside a
fixture, never at import)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "BENCHMARK.json"
SKFLOW = Path(__file__).resolve().with_name("skflow_cell.json")

# each cell's traffic at a size the CPU runs in seconds
TINY = {
    "sf_sintel_infer": dict(height=60, width=96, padded=[64, 96], iters=2,
                            ring=2, draw_from=3, checked=2,
                            trace_seconds=0.5),
    "skflow_sintel_infer": dict(height=60, width=96, padded=[64, 96],
                                iters=2, ring=2, draw_from=3, checked=2,
                                trace_seconds=0.5),
    "sf_sintel_kitti_train": dict(height=64, width=96, batch=2, ref_rows=1,
                                  iters=2, ring=4, trace_steps=1),
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


def bench() -> dict:
    """BENCHMARK.json with the cells kept out of it for the tests
    (``skflow_cell.json``: SKFlow's, which reports what the cell it is
    ``like`` reports)."""
    b = json.loads(BENCH.read_text())
    extra = json.loads(SKFLOW.read_text())
    b["configs"] += extra["configs"]
    b["workloads"] += extra["workloads"]
    for m in b["end_to_end"] + b["per_layer"]:
        if extra["like"] in m.get("workloads", ()):
            m["workloads"] += [w["name"] for w in extra["workloads"]]
    return b


def tiny_cell(name):
    from sfbench import cell as cells

    c = cells.load(name, bench())
    c.traffic.update(TINY[name])
    return c


@pytest.fixture
def tiny():
    return tiny_cell
