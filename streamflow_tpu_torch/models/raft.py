"""The two-frame baselines: RAFT, RAFT-GMA and SKFlow (port of
streamflow_tpu/models/raft.py::RAFT and its step, :29-126; reference
core/models/raft.py:71-190, raftgma.py, sk_decoder.py).

Images (B, H, W, 3) in [0, 255], a pair -> flows (B, H, W, 2), (x, y).
The fnet (RAFT's CNN, instance norm) runs once on both images stacked
along the batch, the cnet (BatchNorm) on the first; its output splits into
the GRU's hidden state (tanh) and the context (ReLU). GMA's (q, k) are
computed once per forward from the context. Each refinement iteration
looks up the 4-level correlation pyramid at the detached coordinates (K1
through ``FusedCorr``), runs the update block and moves the coordinates.

Dtype policy: the encoders, GMA and the update block compute in bf16
under ``mixed_precision``; coordinates, the flow carry and the convex
upsampling stay f32. JAX casts the fmaps to f32 before its materialised
volume (:87, :96). The fmaps hold bf16 values, so its level-0 volume is
the bf16 x bf16 product accumulated in f32 that K1's bf16 body computes,
and every consumer rounds the lookup to bf16 (the motion encoder's first
conv): the port hands the bf16 fmaps to K1's bf16 body. Its levels 1-3
are averaged in f32, as JAX's, and rounded once to bf16, so each lookup
stays within two bf16 roundings of JAX's
(tests/test_torch_raft_bf16.py). Under f32 the fmaps are f32 and K1 runs
its f32 body. The BatchNorm statistics follow
``forward``'s ``train`` argument (JAX's ``train``), not
``nn.Module.train()``.

Test mode (``test_mode=True``, no autograd) runs the mask head on the
last iteration only and returns (low-res flow, upsampled flow), as JAX's
(:123-126); train mode returns the upsampled flows of every iteration,
(iters, B, H, W, 2).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from streamflow_tpu_torch.config import RAFTConfig
from streamflow_tpu_torch.layers.basic_encoder import BasicEncoder
from streamflow_tpu_torch.layers.gma import GMAAttention
from streamflow_tpu_torch.layers.update import (BasicUpdateBlock,
                                                GMAUpdateBlock,
                                                SKUpdateBlockAllDecoder)
from streamflow_tpu_torch.ops.coords import coords_grid
from streamflow_tpu_torch.ops.kernels.corr_lookup import FusedCorr
from streamflow_tpu_torch.ops.upsample import convex_upsample

RATIO = 8


def make_update_block(cfg: RAFTConfig) -> nn.Module:
    kw = dict(corr_planes=cfg.corr_planes, context_dim=cfg.context_dim)
    if cfg.update_block == "raft":
        return BasicUpdateBlock(hidden_dim=cfg.hidden_dim, **kw)
    if cfg.update_block == "gma":
        return GMAUpdateBlock(hidden_dim=cfg.hidden_dim,
                              num_heads=cfg.num_heads, **kw)
    if cfg.update_block == "sk":
        return SKUpdateBlockAllDecoder(
            embed_dim=cfg.hidden_dim, k_conv=cfg.k_conv,
            pc_updater_conv=cfg.pc_updater_conv, num_heads=cfg.num_heads,
            use_gma=cfg.use_gma, **kw)
    raise ValueError(f"unknown update_block '{cfg.update_block}'")


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        if cfg.encoder != "basic":
            raise ValueError(f"RAFT takes encoder='basic', got "
                             f"'{cfg.encoder}'")
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch")
        self.att = (GMAAttention(cfg.context_dim, cfg.num_heads,
                                 cfg.context_dim) if cfg.uses_gma else None)
        self.update_block = make_update_block(cfg)

    def forward(self, image1, image2, iters=None, flow_init=None,
                test_mode: bool = False, train: bool = False):
        """Test mode: (low-res flow (B, H/8, W/8, 2), flow (B, H, W, 2)),
        f32. Train mode (the default): the per-iteration flows (iters, B,
        H, W, 2) f32. ``flow_init`` (B, H/8, W/8, 2) starts the
        coordinates. ``train``: BatchNorm on batch statistics, updating
        its running statistics; the train step passes it."""
        if test_mode:
            with torch.no_grad():
                return self._run(image1, image2, iters, flow_init, True,
                                 train)
        return self._run(image1, image2, iters, flow_init, False, train)

    def _run(self, image1, image2, iters, flow_init, test_mode: bool,
             train: bool):
        cfg = self.cfg
        iters = cfg.iters if iters is None else iters
        b = image1.shape[0]

        def norm(im):
            return (2.0 * (im.float() / 255.0) - 1.0).to(self.dtype)

        x1 = norm(image1)
        fmaps = self.fnet(torch.cat([x1, norm(image2)]), train)
        net, inp = self.cnet(x1, train).split(cfg.hidden_dim, dim=-1)
        net, inp = torch.tanh(net), torch.relu(inp)
        pyramid = FusedCorr(fmaps[:b], fmaps[b:], cfg.corr_levels,
                            cfg.corr_radius, pool_f32=True)
        attn = None if self.att is None else self.att(inp)

        h, w = fmaps.shape[1], fmaps.shape[2]
        coords0 = coords_grid(b, h, w, image1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init

        def step(net, coords1, compute_mask):
            coords1 = coords1.detach()
            corr = pyramid.lookup(coords1).to(self.dtype)
            net, mask, delta = self.update_block(
                net, inp, corr, coords1 - coords0, attn,
                compute_mask=compute_mask)
            return net, mask, coords1 + delta.float()

        if not test_mode:
            flows = []
            for _ in range(iters):
                net, mask, coords1 = step(net, coords1, True)
                flows.append(convex_upsample(coords1 - coords0, mask, RATIO))
            return torch.stack(flows)

        mask = None
        for i in range(iters):
            net, m, coords1 = step(net, coords1, i == iters - 1)
            if m is not None:
                mask = m
        if mask is None:     # iters=0: JAX's zero mask
            mask = coords1.new_zeros(b, h, w, 9 * RATIO ** 2)
        lowres = coords1 - coords0
        return lowres, convex_upsample(lowres, mask, RATIO)
