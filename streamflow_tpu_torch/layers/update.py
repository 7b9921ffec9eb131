"""Motion encoder and the canonical StreamFlow decoder (port of
streamflow_tpu/layers/update.py: SKMotionEncoder6, MaskHead,
SKUpdateBlockTAMv3; reference core/update.py:313-339, 739-782).

Multi-frame tensors are (B, F, H, W, C); the per-frame layers run on the
flattened (B*F, H, W, C) batch.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from streamflow_tpu_torch.layers.common import conv2d, gelu, pointwise
from streamflow_tpu_torch.layers.gma import GMAAggregate
from streamflow_tpu_torch.layers.sk import SKBlock
from streamflow_tpu_torch.layers.temporal import TemporalLayer


class SKMotionEncoder6(nn.Module):
    """corr -> SK(256) -> gelu -> SK(192); flow -> 1x1(128) -> SK(64);
    concat -> SK(out_dim - 2); concat flow -> out_dim channels."""

    def __init__(self, corr_planes: int = 324, out_dim: int = 128,
                 k_conv: Sequence[int] = (1, 15), dw_impl: str = "auto"):
        super().__init__()
        self.convc1 = SKBlock(corr_planes, 256, k_conv, dw_impl)
        self.convc2 = SKBlock(256, 192, k_conv, dw_impl)
        self.convf1 = nn.Conv2d(2, 128, 1)
        self.convf2 = SKBlock(128, 64, k_conv, dw_impl)
        self.conv = SKBlock(192 + 64, out_dim - 2, k_conv, dw_impl)

    def forward(self, flow, corr):
        cor = self.convc2(gelu(self.convc1(corr)))
        flow = flow.to(cor.dtype)
        flo = self.convf2(pointwise(flow, self.convf1))
        out = self.conv(torch.cat([cor, flo], dim=-1))
        return torch.cat([out, flow], dim=-1)


class SKUpdateBlockTAMv3(nn.Module):
    """SK motion encoder + GMA aggregate + zero-init temporal layer + SK
    "gru" + joint flow head over all F frames + the convex-upsample mask
    head (3x3 conv -> ReLU -> 1x1 conv, scaled by 0.25). ``dw_impl``
    picks the layout of the six SK blocks (layers/sk.py)."""

    def __init__(self, embed_dim: int = 128, num_frames: int = 3,
                 corr_planes: int = 324, k_conv: Sequence[int] = (1, 15),
                 pc_updater_conv: Sequence[int] = (1, 7), num_heads: int = 1,
                 ratio: int = 8, dw_impl: str = "auto"):
        super().__init__()
        d = embed_dim
        self.num_frames = num_frames
        self.encoder = SKMotionEncoder6(corr_planes, d, k_conv, dw_impl)
        self.aggregator = GMAAggregate(d, num_heads, d)
        self.transformer_block = TemporalLayer(d)
        self.gru = SKBlock(5 * d, d, pc_updater_conv, dw_impl)
        self.flow_head = SKBlock(num_frames * d, 2 * num_frames, k_conv,
                                 dw_impl)
        self.mask = nn.Sequential(nn.Conv2d(d, 2 * d, 3, padding=1),
                                  nn.ReLU(), nn.Conv2d(2 * d, 9 * ratio ** 2,
                                                       1))

    def forward(self, net, inp, corr, flow, attn, compute_mask: bool = True):
        """net/inp (B, F, H, W, D), corr (B, F, H, W, 324), flow
        (B, F, H, W, 2); attn is GMA's map or its (q, k). Returns net,
        the mask (B, F, H, W, 9 r^2) or None, and delta (B, F, H, W, 2)."""
        b, f, h, w, d = net.shape
        assert f == self.num_frames

        def flat(x):
            return x.reshape(b * f, h, w, x.shape[-1])

        mf = self.encoder(flat(flow), flat(corr))
        mf_global = self.aggregator(attn, mf)
        mf_temporal = self.transformer_block(mf.reshape(b, f, h, w, d))
        net_f = self.gru(torch.cat(
            [flat(net), flat(inp), mf, mf_global, flat(mf_temporal)], dim=-1))

        joint = net_f.reshape(b, f, h, w, d).permute(0, 2, 3, 1, 4)
        delta = self.flow_head(joint.reshape(b, h, w, f * d))
        delta = delta.reshape(b, h, w, f, 2).permute(0, 3, 1, 2, 4)

        mask = None
        if compute_mask:
            m = torch.relu(conv2d(net_f, self.mask[0]))
            mask = 0.25 * pointwise(m, self.mask[2])
            mask = mask.reshape(b, f, h, w, -1)
        return net_f.reshape(b, f, h, w, d), mask, delta
