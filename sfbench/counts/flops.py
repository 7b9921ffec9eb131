"""Model FLOPs of one request or one training step, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's plain
reference on the meta device at the cell's shapes: the products
(linear layers, convolutions, attention, the correlation volume) at 2
flops a multiply-add, whatever implements them in the program. A
training step counts the forward and its backward, without
rematerialisation. The counter's own formula for a convolution's
backward ignores the groups (it counts a depthwise conv's gradients as a
dense conv's); ``conv_backward`` counts each gradient asked for as one
forward of the grouped conv.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode


def conv_backward(grad_out_shape, x_shape, w_shape, *args, out_shape=None,
                  **kwargs):
    """FLOPs of a (non-transposed, grouped) convolution's backward: each
    of the input and weight gradients the output mask asks for costs one
    forward, 2 x output elements x (in / groups) x kernel taps."""
    output_mask = args[-1]
    fwd = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def _meta_params(specs):
    return {k: torch.zeros(s, device="meta") for k, s in specs}


def infer_flops(ref, cfg: dict, traffic: dict, specs) -> float:
    """FLOPs of one request of an inference cell; ``ref`` the model's
    reference module (``cell.reference``)."""
    h, w = traffic["padded"]
    P = _meta_params(specs)
    x = torch.zeros(traffic["batch"], traffic["frames"], h, w, 3,
                    device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.forward(P, x, cfg, traffic["iters"])
    return float(fc.get_total_flops())


def train_flops(ref, cfg: dict, traffic: dict, specs) -> float:
    """FLOPs of one training step: forward and backward."""
    b, t = traffic["batch"], traffic["frames"]
    h, w = traffic["height"], traffic["width"]
    P = {k: v.requires_grad_(True) for k, v in _meta_params(specs).items()}
    x = torch.zeros(b, t, h, w, 3, device="meta")
    mapping = {torch.ops.aten.convolution_backward: conv_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
        preds = ref.forward(P, x, cfg, traffic["iters"], test_mode=False)
        preds.abs().mean().backward()
    return float(fc.get_total_flops())
