"""The control, at a size a test run holds: the plain reference in float8
(the step below the bfloat16 the configurations state) put in the
program's place fails a limit of each cell, where the program on the
same seed passes them all. The limits themselves were set on the card at
the cells' own sizes (PERF.md)."""

from __future__ import annotations

import pytest

from sfbench.control import readings

CASES = [("sf_sintel_infer", 1), ("sf_sintel_infer", 2),
         ("skflow_sintel_infer", 1), ("skflow_sintel_infer", 2),
         ("sf_sintel_kitti_train", 1), ("sf_sintel_kitti_train", 2)]


def _fails(cell, r):
    return [k for k, lim in cell.limits.items() if r[k] > lim]


@pytest.mark.parametrize("name,seed", CASES)
def test_control_fails_and_program_passes(tiny, name, seed):
    c = tiny(name)
    prog = readings(c, seed, 0.3, "cpu")
    ctl = readings(c, seed, 0.3, "cpu", control=True)
    assert _fails(c, prog) == [], prog
    assert _fails(c, ctl), ctl
