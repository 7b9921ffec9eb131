"""Motion encoders and update blocks (port of
streamflow_tpu/layers/update.py): the StreamFlow decoders
(SKMotionEncoder6, MaskHead, SKUpdateBlockTAMv3 with its ablation
branches, :94-216; reference core/update.py:313-339, 691-832) and the
two-frame baselines' (FlowHead, SepConvGRU, BasicMotionEncoder,
BasicUpdateBlock, GMAUpdateBlock, :257-351, reference
core/update.py:1793-1866, 2134-2268; SKUpdateBlockAllDecoder, :219-254,
reference core/update.py:410-448).

Multi-frame tensors are (B, F, H, W, C); the per-frame layers run on the
flattened (B*F, H, W, C) batch. Two-frame tensors are (B, H, W, C).
Every block computes in the dtype of its inputs (the model's compute
dtype): the flow is cast to it where it enters a motion encoder.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from streamflow_tpu_torch.layers.common import (conv2d, gelu, on_slab,
                                                pointwise)
from streamflow_tpu_torch.layers.gma import GMAAggregate
from streamflow_tpu_torch.layers.sk import SKBlock
from streamflow_tpu_torch.layers.temporal import TemporalLayer


def mask_head_module(dim: int, ratio: int = 8) -> nn.Sequential:
    """The convex-upsample mask head's layers (reference keys ``mask.0``,
    ``mask.2``): 3x3 conv dim -> 2 dim, ReLU, 1x1 conv to 9 r^2."""
    return nn.Sequential(nn.Conv2d(dim, 2 * dim, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(2 * dim, 9 * ratio ** 2, 1))


def mask_head(mask: nn.Sequential, net: torch.Tensor) -> torch.Tensor:
    """MaskHead (JAX :62-91): the head's output scaled by 0.25."""
    return 0.25 * pointwise(torch.relu(conv2d(net, mask[0])), mask[2])


class SKMotionEncoder6(nn.Module):
    """corr -> SK(256) -> gelu -> SK(192); flow -> 1x1(128) -> SK(64);
    concat -> SK(out_dim - 2); concat flow -> out_dim channels."""

    def __init__(self, corr_planes: int = 324, out_dim: int = 128,
                 k_conv: Sequence[int] = (1, 15), dw_impl: str = "auto",
                 gelu: str = "erf"):
        super().__init__()
        self.convc1 = SKBlock(corr_planes, 256, k_conv, dw_impl, gelu)
        self.convc2 = SKBlock(256, 192, k_conv, dw_impl, gelu)
        self.convf1 = nn.Conv2d(2, 128, 1)
        self.convf2 = SKBlock(128, 64, k_conv, dw_impl, gelu)
        self.conv = SKBlock(192 + 64, out_dim - 2, k_conv, dw_impl, gelu)

    def forward(self, flow, corr, rows=None):
        """``rows``: the inputs are that slab of the grid's rows; each SK
        block runs on its input's slab extended by its halo."""
        def sk(block, x):
            return on_slab(block, x, block.halo, rows)

        cor = sk(self.convc2, gelu(sk(self.convc1, corr)))
        flow = flow.to(cor.dtype)
        flo = sk(self.convf2, pointwise(flow, self.convf1))
        out = sk(self.conv, torch.cat([cor, flo], dim=-1))
        return torch.cat([out, flow], dim=-1)


class SKUpdateBlockTAMv3(nn.Module):
    """SK motion encoder + GMA aggregate + temporal layer + SK "gru" +
    flow head + the convex-upsample mask head (3x3 conv -> ReLU -> 1x1
    conv, scaled by 0.25). ``dw_impl`` picks the layout of the SK blocks
    (layers/sk.py).

    The ablations share the graph, as in JAX:
    - ``joint_flow_head=False`` (``sk_tam_v1``, SKUpdateBlock_TAM,
      core/update.py:691-735): a per-frame flow head, SKBlock(D -> 2) on
      each of the F frames, in place of the joint SKBlock(F*D -> 2F);
    - ``temporal_zero_init=False`` (``sk_tam_v3_noinit``,
      core/update.py:787-832): the temporal layer starts live;
    - ``use_gma=False``: no ``aggregator``, the motion features stand in
      for the aggregated ones (mf_global = mf)."""

    def __init__(self, embed_dim: int = 128, num_frames: int = 3,
                 corr_planes: int = 324, k_conv: Sequence[int] = (1, 15),
                 pc_updater_conv: Sequence[int] = (1, 7), num_heads: int = 1,
                 ratio: int = 8, dw_impl: str = "auto",
                 use_gma: bool = True, joint_flow_head: bool = True,
                 temporal_zero_init: bool = True, gelu: str = "erf"):
        super().__init__()
        d = embed_dim
        self.num_frames = num_frames
        self.joint_flow_head = joint_flow_head
        self.encoder = SKMotionEncoder6(corr_planes, d, k_conv, dw_impl,
                                        gelu)
        self.aggregator = GMAAggregate(d, num_heads, d) if use_gma else None
        self.transformer_block = TemporalLayer(d, temporal_zero_init)
        self.gru = SKBlock(5 * d, d, pc_updater_conv, dw_impl, gelu)
        if joint_flow_head:
            self.flow_head = SKBlock(num_frames * d, 2 * num_frames, k_conv,
                                     dw_impl, gelu)
        else:
            self.flow_head = SKBlock(d, 2, k_conv, dw_impl, gelu)
        self.mask = mask_head_module(d, ratio)

    def forward(self, net, inp, corr, flow, attn, compute_mask: bool = True,
                rows=None):
        """net/inp (B, F, H, W, D), corr (B, F, H, W, 324), flow
        (B, F, H, W, 2); attn is GMA's (q, k) (None without GMA). Returns
        net, the mask (B, F, H, W, 9 r^2) or None, and delta (B, F, H, W,
        2). ``rows`` (``parallel/seq.py``): the inputs are that slab of the
        grid's rows, attn's k whole; the SK blocks and the mask head run
        on their inputs' slabs extended by their halos; the motion
        features are gathered for GMA's v and the temporal layer, which
        run at the whole grid's shape (per pixel, but the card's batched
        products sum in another order at a slab's)."""
        b, f, h, w, d = net.shape
        assert f == self.num_frames

        def flat(x):
            return x.reshape(b * f, h, w, x.shape[-1])

        def sk(block, x):
            return on_slab(block, x, block.halo, rows)

        mf = self.encoder(flat(flow), flat(corr), rows)
        mf_all = mf if rows is None else rows.gather(mf, 1)
        mf_global = (mf if self.aggregator is None
                     else self.aggregator(attn, mf, mf_all))
        mf_temporal = self.transformer_block(mf_all.reshape(b, f, -1, w, d))
        if rows is not None:
            mf_temporal = mf_temporal[:, :, rows.start:rows.stop]
        net_f = sk(self.gru, torch.cat(
            [flat(net), flat(inp), mf, mf_global, flat(mf_temporal)], dim=-1))

        if self.joint_flow_head:
            joint = net_f.reshape(b, f, h, w, d).permute(0, 2, 3, 1, 4)
            delta = sk(self.flow_head, joint.reshape(b, h, w, f * d))
            delta = delta.reshape(b, h, w, f, 2).permute(0, 3, 1, 2, 4)
        else:
            delta = sk(self.flow_head, net_f).reshape(b, f, h, w, 2)

        mask = None
        if compute_mask:
            mask = on_slab(lambda x: mask_head(self.mask, x), net_f, 1, rows)
            mask = mask.reshape(b, f, h, w, mask.shape[-1])
        return net_f.reshape(b, f, h, w, d), mask, delta


class SKUpdateBlockAllDecoder(nn.Module):
    """The two-frame SKFlow decoder (SKUpdateBlock6_Deep_nopoolres_
    AllDecoder): SK motion encoder [+ GMA aggregate] + SK "gru" + SK flow
    head (D -> 2) + mask head. The gru is sized from its real input, net
    + inp + the motion features [+ the aggregated ones]: 512 channels with
    GMA, 384 without (the JAX NOTE at :243-246: the reference's
    ``embed_dim*4`` type-checks only without GMA)."""

    def __init__(self, corr_planes: int = 324, embed_dim: int = 128,
                 context_dim: int = 128, k_conv: Sequence[int] = (1, 15),
                 pc_updater_conv: Sequence[int] = (1, 7), num_heads: int = 1,
                 ratio: int = 8, use_gma: bool = False, gelu: str = "erf"):
        super().__init__()
        d = embed_dim
        self.encoder = SKMotionEncoder6(corr_planes, d, k_conv, gelu=gelu)
        self.aggregator = GMAAggregate(d, num_heads, d) if use_gma else None
        self.gru = SKBlock(d + context_dim + d * (2 if use_gma else 1), d,
                           pc_updater_conv, gelu=gelu)
        self.flow_head = SKBlock(d, 2, k_conv, gelu=gelu)
        self.mask = mask_head_module(d, ratio)

    def forward(self, net, inp, corr, flow, attn=None,
                compute_mask: bool = True):
        """net (B, H, W, D), inp (B, H, W, context), corr (B, H, W, 324),
        flow (B, H, W, 2); attn GMA's (q, k) or None. Returns net, the
        mask (B, H, W, 9 r^2) or None, delta (B, H, W, 2)."""
        mf = self.encoder(flow, corr)
        parts = [net, inp, mf]
        if self.aggregator is not None:
            parts.append(self.aggregator(attn, mf))
        net = self.gru(torch.cat(parts, dim=-1))
        mask = mask_head(self.mask, net) if compute_mask else None
        return net, mask, self.flow_head(net)


class FlowHead(nn.Module):
    """RAFT flow head: 3x3 conv -> ReLU -> 3x3 conv to 2 channels."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return conv2d(torch.relu(conv2d(x, self.conv1)), self.conv2)


class SepConvGRU(nn.Module):
    """Separable ConvGRU: a 1x5 pass (``convz1``, ``convr1``, ``convq1``,
    W padded by 2) then a 5x1 pass (``...2``, H padded by 2)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 320):
        super().__init__()
        c = hidden_dim + input_dim
        for i, (k, pad) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))),
                                     start=1):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{i}",
                        nn.Conv2d(c, hidden_dim, k, padding=pad))

    def forward(self, h, x):
        for i in (1, 2):
            hx = torch.cat([h, x], dim=-1)
            z = torch.sigmoid(conv2d(hx, getattr(self, f"convz{i}")))
            r = torch.sigmoid(conv2d(hx, getattr(self, f"convr{i}")))
            q = torch.tanh(conv2d(torch.cat([r * h, x], dim=-1),
                                  getattr(self, f"convq{i}")))
            h = (1 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    """RAFT motion encoder: corr -> 1x1(256) -> 3x3(192); flow -> 7x7(128)
    -> 3x3(64); concat -> 3x3(126); concat flow -> 128 channels, each conv
    followed by a ReLU."""

    def __init__(self, corr_planes: int = 324):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = torch.relu(pointwise(corr, self.convc1))
        cor = torch.relu(conv2d(cor, self.convc2))
        flow = flow.to(cor.dtype)
        flo = torch.relu(conv2d(flow, self.convf1))
        flo = torch.relu(conv2d(flo, self.convf2))
        out = torch.relu(conv2d(torch.cat([cor, flo], dim=-1), self.conv))
        return torch.cat([out, flow], dim=-1)


class BasicUpdateBlock(nn.Module):
    """RAFT update block: motion encoder [+ GMA aggregate, the
    ``aggregator`` of GMAUpdateBlock] + SepConvGRU + flow head + mask
    head."""

    def __init__(self, corr_planes: int = 324, hidden_dim: int = 128,
                 context_dim: int = 128, ratio: int = 8,
                 aggregator: nn.Module = None):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.aggregator = aggregator
        self.gru = SepConvGRU(hidden_dim, context_dim + 128
                              * (1 if aggregator is None else 2))
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = mask_head_module(hidden_dim, ratio)

    def forward(self, net, inp, corr, flow, attn=None,
                compute_mask: bool = True):
        """As SKUpdateBlockAllDecoder.forward."""
        mf = self.encoder(flow, corr)
        parts = [inp, mf]
        if self.aggregator is not None:
            parts.append(self.aggregator(attn, mf))
        net = self.gru(net, torch.cat(parts, dim=-1))
        mask = mask_head(self.mask, net) if compute_mask else None
        return net, mask, self.flow_head(net)


class GMAUpdateBlock(BasicUpdateBlock):
    """GMA update block: BasicUpdateBlock with the GMA aggregate of the
    motion features (``dim_head`` = hidden_dim) in the GRU's input."""

    def __init__(self, corr_planes: int = 324, hidden_dim: int = 128,
                 context_dim: int = 128, num_heads: int = 1, ratio: int = 8):
        super().__init__(corr_planes, hidden_dim, context_dim, ratio,
                         GMAAggregate(128, num_heads, hidden_dim))
