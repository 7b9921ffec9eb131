"""Plain SKFlow (Sun et al., NeurIPS 2022, arXiv:2205.14623) as the
two-frame RAFT with the SK decoder and GMA: RAFT's residual CNN encoders
(instance norm for the fnet, BatchNorm with running statistics for the
cnet), the 4-level correlation pyramid averaged in float32,
SKMotionEncoder6, GMA, an SK "gru" of k (1, 7) over net + inp + motion +
aggregated motion (512 channels), an SK flow head (1, 15) to 2 channels,
the mask head and convex upsampling. float32 NHWC over a dict of
parameters named by the reference's torch keys.

``forward(P, frames, cfg, iters, pr)``: a frame pair (B, 2, H, W, 3) in
[0, 255] -> the upsampled flow (B, H, W, 2), test mode (no train mode).
``sk_blocks`` and ``mlps`` list its FFN pair and depthwise work by shape.
"""

from __future__ import annotations

import torch

from sfbench.reference.ops import (Prec, avg_pool2, batch_norm_eval, conv,
                                   convex_upsample, coords_grid, corr_lookup,
                                   instance_norm)
from sfbench.reference.streamflow import (_p, _p_sub, gma_aggregate, gma_qk,
                                          mask_head, motion_encoder, sk_block)


def _norm(p, name, x, kind):
    if kind == "instance":
        return instance_norm(x)
    return batch_norm_eval(x, p(f"{name}.weight"), p(f"{name}.bias"),
                           p(f"{name}.running_mean"),
                           p(f"{name}.running_var"))


def residual_block(pr, p, x, kind, stride):
    y = conv(pr, x, p("conv1.weight"), p("conv1.bias"), stride, 1)
    y = torch.relu(_norm(p, "norm1", y, kind))
    y = conv(pr, y, p("conv2.weight"), p("conv2.bias"), 1, 1)
    y = torch.relu(_norm(p, "norm2", y, kind))
    if stride != 1 or x.shape[-1] != y.shape[-1]:
        x = _norm(p, "norm3", conv(pr, x, p("downsample.0.weight"),
                                   p("downsample.0.bias"), stride), kind)
    return torch.relu(x + y)


def basic_encoder(pr, P, prefix, x, kind):
    """RAFT's CNN: 7x7/s2 conv, norm, relu, three stages of two residual
    blocks (64, 96/s2, 128/s2), a 1x1 conv. (N, H, W, 3) -> (N, H/8, W/8,
    out)."""
    p = _p(P, prefix)
    x = conv(pr, x, p("conv1.weight"), p("conv1.bias"), 2, 3)
    x = torch.relu(_norm(p, "norm1", x, kind))
    for i, stride in enumerate((1, 2, 2), start=1):
        x = residual_block(pr, _p_sub(p, f"layer{i}.0"), x, kind, stride)
        x = residual_block(pr, _p_sub(p, f"layer{i}.1"), x, kind, 1)
    return conv(pr, x, p("conv2.weight"), p("conv2.bias"))


def update_block(pr, P, net, inp, corr, flow, qk, compute_mask):
    p = _p(P, "update_block")
    mf = motion_encoder(pr, _p_sub(p, "encoder"), flow, corr)
    agg = gma_aggregate(pr, _p_sub(p, "aggregator"), qk, mf)
    net = sk_block(pr, _p_sub(p, "gru"), torch.cat([net, inp, mf, agg], -1))
    mask = mask_head(pr, p, net) if compute_mask else None
    return net, mask, sk_block(pr, _p_sub(p, "flow_head"), net)


def forward(P, frames, cfg, iters: int, pr: Prec = Prec(),
            test_mode: bool = True, remat: bool = False):
    if not test_mode:
        raise NotImplementedError("the SKFlow reference has no train mode")
    im1, im2 = frames[:, 0], frames[:, 1]
    b = im1.shape[0]

    def norm(im):
        return 2.0 * (im.float() / 255.0) - 1.0

    x1 = norm(im1)
    fmaps = basic_encoder(pr, P, "fnet", torch.cat([x1, norm(im2)]),
                          "instance")
    cn = basic_encoder(pr, P, "cnet", x1, "batch")
    hid = cfg["hidden_dim"]
    net, inp = torch.tanh(cn[..., :hid]), torch.relu(cn[..., hid:])
    f1 = fmaps[:b]
    levels = [fmaps[b:]]
    for _ in range(cfg["corr_levels"] - 1):
        levels.append(avg_pool2(levels[-1]))
    qk = gma_qk(pr, P, "att", inp)
    h, w = f1.shape[1:3]
    coords0 = coords_grid(b, h, w, im1.device)
    coords1 = coords0
    mask = None
    for i in range(iters):
        corr = corr_lookup(f1, levels, coords1, cfg["corr_radius"])
        net, m, delta = update_block(pr, P, net, inp, corr,
                                     coords1 - coords0, qk, i == iters - 1)
        coords1 = coords1 + delta
        mask = m if m is not None else mask
    return convex_upsample(coords1 - coords0, mask)


def sk_blocks(cfg, b: int, f: int, h: int, w: int):
    """(c_in, c_out, k of the depthwise conv, rows) of every SK block call
    of one refinement iteration at the 1/8 grid (h, w) (f = 1): the
    motion encoder's four, the gru over net + inp + motion + aggregate,
    the flow head."""
    d, ctx = cfg["hidden_dim"], cfg["context_dim"]
    planes = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2
    k, kp = max(cfg["k_conv"]), max(cfg["pc_updater_conv"])
    rows = b * f * h * w
    return [(planes, 256, k, rows), (256, 192, k, rows), (128, 64, k, rows),
            (256, d - 2, k, rows), (d + ctx + 2 * d, d, kp, rows),
            (d, 2, k, rows)]


def mlps(cfg, b: int, t: int, hh: int, ww: int):
    """No FFN pair outside the SK blocks: the encoders are CNNs."""
    return []
