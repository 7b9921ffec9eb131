"""What a run loads: no module whose top-level name (the part before the
first dot, compared whole) is jax, jaxlib, flax or streamflow_tpu, the
JAX package whose name the port's begins with; and the plain reference
loads nothing of the port. Each in a fresh interpreter."""

from __future__ import annotations

import json
import subprocess
import sys

from sfbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "streamflow_tpu"}

RUN_CPU = """
import json, sys
sys.path.insert(0, {root!r})
from sfbench import cell as cells
from sfbench.tests.conftest import tiny_cell
for name in ("sf_sintel_infer", "skflow_sintel_infer",
             "sf_sintel_kitti_train"):
    c = tiny_cell(name)
    for trace in (False, True):
        cells.driver(c).run(c, 7, 0.2, trace, device="cpu", t_start=0.0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from sfbench.reference import ops, skflow, streamflow, train
P = {{}}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    p = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level(RUN_CPU)
    assert "streamflow_tpu_torch" in mods and "sfbench" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level(REFERENCE)
    assert "sfbench" in mods
    assert not mods & (FORBIDDEN | {"streamflow_tpu_torch"})
