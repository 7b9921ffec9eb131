"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped, the rest of the run (set-up,
window, check, result line) is driven on the CPU at a tiny size, with one
fault planted in the program's entry points. A fault a cell cannot have
is not planted: the exchange between chips on one chip; half of a batch
only where the batch holds more than one clip (the train cell)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from sfbench import cell as cells
from sfbench import program

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run  # noqa: E402


def _correct(c):
    res = cells.driver(c).run(c, 2 ** 31 + 3, 0.3, False, device="cpu",
                              t_start=0.0)
    line = run.result_line(c, res, False, {"platform": "cpu"})
    return line["correct"], line["checks"]


def _wrap_serving(monkeypatch, fault):
    graphed = program.graphed

    def broken(cell, model):
        fwd, call = graphed(cell, model)
        return fwd, lambda x: fault(call(x))

    monkeypatch.setattr(program, "graphed", broken)


@pytest.mark.parametrize("name", ["sf_sintel_infer", "skflow_sintel_infer"])
def test_sound_inference_run_is_correct(tiny, name):
    ok, checks = _correct(tiny(name))
    assert ok, checks


@pytest.mark.parametrize("name", ["sf_sintel_infer", "skflow_sintel_infer"])
def test_flows_altered_where_produced(tiny, monkeypatch, name):
    """One flow component of every request 5% off."""
    def fault(f):
        f = f.clone()
        f[..., 0] *= 1.05
        return f

    _wrap_serving(monkeypatch, fault)
    ok, checks = _correct(tiny(name))
    assert not ok, checks


@pytest.mark.parametrize("name", ["sf_sintel_infer", "skflow_sintel_infer"])
def test_refinement_that_leaves_its_state_unchanged(tiny, monkeypatch,
                                                    name):
    """The refinement steps return the coordinates they were given: the
    flows stay at zero."""
    _wrap_serving(monkeypatch, torch.zeros_like)
    ok, checks = _correct(tiny(name))
    assert not ok, checks


def test_answer_for_another_clip(tiny, monkeypatch):
    """Every request answered with the flows of another clip: its own
    frames in reverse order (a window of any length)."""
    graphed = program.graphed

    def broken(cell, model):
        fwd, call = graphed(cell, model)
        return fwd, lambda x: call(x.flip(1))

    monkeypatch.setattr(program, "graphed", broken)
    ok, checks = _correct(tiny("sf_sintel_infer"))
    assert not ok, checks


def _wrap_step(monkeypatch, fault):
    train_state = program.train_state

    def broken(cell, model):
        state, step = train_state(cell, model)
        return state, fault(state, step)

    monkeypatch.setattr(program, "train_state", broken)


def test_sound_train_run_is_correct(tiny):
    ok, checks = _correct(tiny("sf_sintel_kitti_train"))
    assert ok, checks


def test_step_that_leaves_the_state_unchanged(tiny, monkeypatch):
    def fault(state, step):
        return lambda s, batch: {"loss": torch.tensor(0.0)}

    _wrap_step(monkeypatch, fault)
    ok, checks = _correct(tiny("sf_sintel_kitti_train"))
    assert not ok, checks
    assert checks["change_median_gap"]["value"] > 0.9


def test_half_of_the_batch_left_out(tiny, monkeypatch):
    """Each step on the first half of its batch, the mean taken over that
    half (the fault the control tool plants on the card)."""
    from sfbench.control import half_batch

    c = tiny("sf_sintel_kitti_train")
    assert c.traffic["batch"] >= 2
    monkeypatch.setattr(program, "train_state", half_batch())
    ok, checks = _correct(c)
    assert not ok, checks


def test_gradient_altered_where_produced(tiny, monkeypatch):
    """Every gradient 30% larger than the backward made it, as AdamW
    reads it (the fault the control tool plants on the card)."""
    from sfbench.control import GRAD_SCALE, scaled_gradients

    monkeypatch.setattr(program, "train_state", scaled_gradients(GRAD_SCALE))
    ok, checks = _correct(tiny("sf_sintel_kitti_train"))
    assert not ok, checks
    assert checks["grad_median_gap"]["value"] > 0.25
