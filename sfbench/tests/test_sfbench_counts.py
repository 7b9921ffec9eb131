"""The yardstick's counts: the roofline works from the configuration's
shapes alone (the same whatever SK layout runs), equal to the products
that the plain reference's own SK blocks and Twins MLPs compute, and
the model FLOPs of a request and of a step."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from sfbench import program
from sfbench.counts import flops, kernels
from sfbench.counts.flops import conv_backward
from sfbench.reference import skflow, streamflow


@pytest.mark.parametrize("dw_impl", ["auto", "pallas", "banded_chain"])
def test_counts_do_not_depend_on_the_sk_layout(tiny, dw_impl):
    c = tiny("sf_sintel_infer")
    base = {k: kernels.work(k, c.reference, c.config, c.traffic)
            for k in kernels.WORK}
    cfg = dict(c.config, dw_impl=dw_impl)
    assert {k: kernels.work(k, c.reference, cfg, c.traffic)
            for k in kernels.WORK} == base


def _counted(monkeypatch, c, specs):
    """FLOPs of the reference's SK blocks (their products but the
    depthwise convs) and Twins MLPs, and of their depthwise convs, on the
    meta device."""
    got = {"ffn": 0.0, "dw": 0.0}
    sk, blk = streamflow.sk_block, streamflow.twins_block

    def count_sk(pr, p, x):
        with FlopCounterMode(display=False) as fc:
            y = sk(pr, p, x)
        total = fc.get_total_flops()
        k = p("conv_list.1.weight").shape[-1]
        dw = 2 * k * k * x[..., 0].numel() * x.shape[-1]
        got["ffn"] += total - dw - 2 * x.numel()          # minus the k=1
        got["dw"] += dw
        return y

    def count_mlp(pr, p, x, size, nh, sr, windowed):
        c_ = x.shape[-1]
        got["ffn"] += 2 * x.shape[0] * x.shape[1] * (2 * 4 * c_ * c_)
        return blk(pr, p, x, size, nh, sr, windowed)

    monkeypatch.setattr(streamflow, "sk_block", count_sk)
    monkeypatch.setattr(skflow, "sk_block", count_sk)
    monkeypatch.setattr(streamflow, "twins_block", count_mlp)
    flops.infer_flops(c.reference, c.config, c.traffic, specs)
    return got


@pytest.mark.parametrize("name", ["sf_sintel_infer", "skflow_sintel_infer"])
def test_work_matches_the_reference(monkeypatch, tiny, name):
    c = tiny(name)
    model, specs, _ = program.build(c, 1, "cpu")
    got = _counted(monkeypatch, c, specs)
    ffn, _ = kernels.work("ffn_pair", c.reference, c.config, c.traffic)
    dw, _ = kernels.work("dwconv", c.reference, c.config, c.traffic)
    assert ffn == pytest.approx(got["ffn"], rel=1e-12)
    assert dw == pytest.approx(got["dw"], rel=1e-12)


def test_model_flops_bound_the_work(tiny):
    c = tiny("sf_sintel_infer")
    _, specs, _ = program.build(c, 1, "cpu")
    total = flops.infer_flops(c.reference, c.config, c.traffic, specs)
    parts = sum(kernels.work(k, c.reference, c.config, c.traffic)[0]
                for k in kernels.WORK)
    assert parts < total
    t = tiny("sf_sintel_kitti_train")
    _, specs, _ = program.build(t, 1, "cpu", train=True)
    step = flops.train_flops(t.reference, t.config, t.traffic, specs)
    fwd = flops.infer_flops(t.reference, t.config, dict(
        t.traffic, padded=[t.traffic["height"], t.traffic["width"]]), specs)
    # forward (mask head on every iteration) and backward: about 3x
    assert 2.5 * fwd < step < 4 * fwd


def test_grouped_conv_backward_counts_as_two_forwards():
    x = torch.zeros(1, 64, 16, 16, device="meta", requires_grad=True)
    w = torch.zeros(64, 1, 15, 15, device="meta", requires_grad=True)
    mapping = {torch.ops.aten.convolution_backward: conv_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
        y = torch.nn.functional.conv2d(x, w, padding=7, groups=64)
        y.sum().backward()
    assert fc.get_total_flops() == 3 * 2 * 64 * 16 * 16 * 15 * 15
