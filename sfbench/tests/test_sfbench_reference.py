"""The plain reference against the port's CPU path, float32, at a tiny
size: the StreamFlow and SKFlow forwards in test mode, the StreamFlow
train-mode flows, and one training step's loss and clipped gradients."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from sfbench import inputs, program
from sfbench.reference import skflow, streamflow
from sfbench.reference import train as reftrain


def _f32(cell):
    return dataclasses.replace(cell, config=dict(cell.config,
                                                 mixed_precision=False))


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("iters", [1, 3])
def test_streamflow_forward(tiny, iters):
    c = _f32(tiny("sf_sintel_infer"))
    c.traffic["iters"] = iters
    model, specs, dtypes = program.build(c, 2 ** 31 + 11, "cpu")
    W = inputs.served(inputs.make_weights(specs, 2 ** 31 + 11, "cpu"),
                      dtypes)
    x, _ = inputs.clips(1, 4, 64, 96, 6.0, 3, 1, "cpu")
    got = model(x, iters=iters, test_mode=True)
    want = streamflow.forward(W, x, c.config, iters)
    assert _rel(got, want) < 1e-5


def test_streamflow_train_mode(tiny):
    c = _f32(tiny("sf_sintel_infer"))
    model, specs, _ = program.build(c, 5, "cpu", train=True)
    W = inputs.make_weights(specs, 5, "cpu")
    x, _ = inputs.clips(1, 4, 64, 96, 6.0, 4, 1, "cpu")
    got = model(x, iters=2, test_mode=False, train=True)
    want = streamflow.forward(W, x, c.config, 2, test_mode=False)
    assert got.shape == want.shape == (2, 1, 3, 64, 96, 2)
    assert _rel(got.detach(), want.detach()) < 1e-5


@pytest.mark.parametrize("iters", [1, 3])
def test_skflow_forward(tiny, iters):
    c = _f32(tiny("skflow_sintel_infer"))
    c.traffic["iters"] = iters
    model, specs, dtypes = program.build(c, 9, "cpu")
    W = inputs.served(inputs.make_weights(specs, 9, "cpu"), dtypes)
    x, _ = inputs.clips(1, 2, 64, 96, 6.0, 5, 1, "cpu")
    got = model(x[:, 0], x[:, 1], iters=iters, test_mode=True)[1]
    want = skflow.forward(W, x, c.config, iters)
    assert _rel(got, want) < 1e-5


def test_train_step_loss_and_gradients(tiny):
    """The port's f32 step and the reference's from the same weights on
    the same batch: the loss, every clipped gradient (as AdamW's first
    moment holds it) and every parameter after the update."""
    from sfbench.drivers import train_steps  # noqa: F401  (a plain import)

    c = _f32(tiny("sf_sintel_kitti_train"))
    c.traffic["checked"] = 2
    loop = train_steps.TrainLoop(c, 17, "cpu")
    loop.setup()
    W = inputs.cell_weights(c, loop.specs, 17, "cpu")
    ref = reftrain.steps(c.reference, W, loop.batches[:2], c.config,
                         c.traffic)
    assert loop.prog["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    for k, g in ref["grad1"].items():
        assert _rel(loop.prog["grad1"][k], g) < 1e-3, k
    for k, p in ref["params"].items():
        d_ref = p - W[k]
        assert float((loop.prog["params"][k] - W[k] - d_ref).norm()) <= \
            1e-3 * float(d_ref.norm()) + 1e-9, k


def test_onecycle_matches_the_port():
    from streamflow_tpu_torch.training.optim import onecycle_linear

    mine, port = reftrain.onecycle(1.75e-4, 180100), onecycle_linear(
        1.75e-4, 180100)
    for step in (0, 1, 2, 3, 9004, 9005, 100000, 180099, 180100, 190000):
        assert mine(step) == pytest.approx(port(step), rel=1e-12)


def test_weights_are_the_seed_s(tiny):
    c = tiny("sf_sintel_infer")
    _, specs, _ = program.build(c, 3, "cpu")
    a = inputs.make_weights(specs, 2 ** 33 + 1, "cpu")
    b = inputs.make_weights(specs, 2 ** 33 + 1, "cpu")
    d = inputs.make_weights(specs, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], d[k]) for k in a)
    assert a[inputs.FLOW_HEAD + "weight"].abs().max() < 0.01
