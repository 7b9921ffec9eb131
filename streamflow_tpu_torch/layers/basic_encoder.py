"""RAFT's residual CNN encoder, stride 8, and its temporal variant (port of
streamflow_tpu/layers/basic_encoder.py, :24-197; reference
core/extractor.py:11-194, 198-356, 434-511).

conv7x7/s2 -> norm -> relu -> 3 residual stages (64, 96/s2, 128/s2) -> 1x1
to output_dim. The norm is chosen per use: 'instance' for the fnet,
'batch' for the cnet, and 'group' / 'none' (the reference ResidualBlock's
norm dispatch, core/extractor.py:20-43), each as its flax counterpart
computes it (``layers/common.py``).

Tensors are NHWC at the modules' boundaries; the convs run as cuDNN
convolutions on channels-last views, as the JAX package computes them
outside any Pallas kernel. BatchNorm takes the ``train`` argument of
``forward``, JAX's ``train``: batch statistics and a running-statistics
update with it, the running statistics without it.

Each encoder takes ``rows`` (``parallel.exchange.Rows``, at its input's
resolution): the input is one slab of the image's rows, in the
sequence-sharded forward (``parallel/seq.py``), and the output the
slab's rows at stride 8. Every conv runs on the slab through
``conv2d_rows`` (its padding's rows from the neighbours, strided ones
included: the stem's 7x7/s2, the 3x3/s2 and 1x1/s2 of layer2 and
layer3), each InstanceNorm takes its plane's statistics over the seq
group; BatchNorm (test mode: its running statistics) and Res18_3D's
hooks over T are per pixel and run on the slab as they are. The fnet
normalises after every conv, so each conv exchanges its own halo: one
halo for a whole block would count its rows in the statistics.

Module names follow the reference's torch keys where the JAX package's
checkpoint table has them (``conv1``, ``norm1``, ``layer1.0.conv1``, ...,
``downsample.0``, ``norm3``, ``running_mean``); Res18_3D's hooks, which it
does not name, are named after the flax modules (``norm0``,
``temporal_attn``, ``temporal_fc``, ``spatial``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from streamflow_tpu_torch.layers.common import (BatchNorm, GroupNorm,
                                                conv2d, conv2d_rows,
                                                instance_norm, layer_norm,
                                                linear)
from streamflow_tpu_torch.layers.temporal import TinyAttention

DIMS, STRIDES = (64, 96, 128), (1, 2, 2)


class InstanceNorm(nn.Module):
    """Affine-free InstanceNorm2d on NHWC (``common.instance_norm``)."""

    def forward(self, x, rows=None):
        return instance_norm(x, rows=rows)


def make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "batch":
        return BatchNorm(channels)
    if kind == "group":
        return GroupNorm(max(1, channels // 8), channels)
    if kind == "instance":
        return InstanceNorm()
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")


def norm(mod: nn.Module, x: torch.Tensor, train: bool,
         rows=None) -> torch.Tensor:
    """``mod`` on x; ``rows``: x is a slab of the plane's rows (the
    sequence-sharded forward, test mode: the fnet's InstanceNorm and the
    cnet's BatchNorm), where only InstanceNorm exchanges."""
    if isinstance(mod, BatchNorm):
        return mod(x, train)
    if isinstance(mod, InstanceNorm):
        return mod(x, rows)
    return mod(x)


def _coarse(rows, stride: int):
    return rows if rows is None or stride == 1 else rows.coarse(stride)


class ResidualBlock(nn.Module):
    def __init__(self, c_in: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, planes, 3, stride=stride, padding=1)
        self.norm1 = make_norm(norm_fn, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm2 = make_norm(norm_fn, planes)
        if stride != 1 or c_in != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, planes, 1, stride=stride))
            self.norm3 = make_norm(norm_fn, planes)
        else:
            self.downsample = None

    def forward(self, x, train: bool = False, residual=None, rows=None):
        """``residual`` overrides the skip connection's source (Res18_3D:
        the input before the temporal hook, JAX :118-121); ``rows``: x's
        slab (the module docstring)."""
        r = x if residual is None else residual
        out = _coarse(rows, self.conv1.stride[0])
        y = torch.relu(norm(self.norm1, conv2d_rows(x, self.conv1, rows),
                            train, out))
        y = torch.relu(norm(self.norm2, conv2d_rows(y, self.conv2, out),
                            train, out))
        if self.downsample is not None:
            r = norm(self.norm3, conv2d_rows(r, self.downsample[0], rows),
                     train, out)
        return torch.relu(r + y)


def _layers(block, norm_fn: str) -> nn.ModuleList:
    """layer1..3 of two blocks each (64, 96/s2, 128/s2)."""
    out, c = [], 64
    for d, s in zip(DIMS, STRIDES):
        out.append(nn.ModuleList([block(c, d, norm_fn, s),
                                  block(d, d, norm_fn, 1)]))
        c = d
    return nn.ModuleList(out)


class BasicEncoder(nn.Module):
    """(N, H, W, 3) -> (N, H/8, W/8, output_dim)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm_fn, 64)
        self.layer1, self.layer2, self.layer3 = _layers(ResidualBlock,
                                                        norm_fn)
        self.conv2 = nn.Conv2d(DIMS[-1], output_dim, 1)

    def stem(self, x, train, rows=None):
        return torch.relu(norm(self.norm1, conv2d_rows(x, self.conv1, rows),
                               train, _coarse(rows, 2)))

    def forward(self, x, train: bool = False, rows=None):
        x = self.stem(x, train, rows)
        rows = _coarse(rows, 2)
        for layer in (self.layer1, self.layer2, self.layer3):
            for blk in layer:
                x = blk(x, train, rows=rows)
                rows = _coarse(rows, blk.conv1.stride[0])
        return conv2d(x, self.conv2)


class PerFrameBasicEncoder(BasicEncoder):
    """BasicEncoder lifted over T (JAX ``models/streamflow.py::
    _PerFrameBasicEncoder``): (B, T, H, W, 3) -> (B, T, H/8, W/8,
    output_dim), T folded into the batch."""

    def forward(self, x, train: bool = False, rows=None):
        """``rows``: the same slab of every frame's rows."""
        b, t = x.shape[:2]
        y = super().forward(x.reshape(b * t, *x.shape[2:]), train, rows)
        return y.reshape(b, t, *y.shape[1:])


class TemporalResidualBlock(nn.Module):
    """ResidualBlock3D (reference core/extractor.py:198-273): LayerNorm ->
    4-head TinyAttention over each pixel's T tokens (standard init) ->
    zero-init ``temporal_fc``, added to the input, then the spatial
    residual block, whose skip connection takes the input before the
    hook. (B, T, H, W, C) -> (B, T, H', W', planes)."""

    def __init__(self, c_in: int, planes: int, norm_fn: str = "batch",
                 stride: int = 1):
        super().__init__()
        self.norm0 = nn.LayerNorm(c_in, eps=1e-5)
        self.temporal_attn = TinyAttention(c_in, num_heads=4,
                                           zero_init=False)
        self.temporal_fc = nn.Linear(c_in, c_in)
        nn.init.zeros_(self.temporal_fc.weight)
        nn.init.zeros_(self.temporal_fc.bias)
        self.spatial = ResidualBlock(c_in, planes, norm_fn, stride)

    def forward(self, x, train: bool = False, rows=None):
        b, t, h, w, c = x.shape
        tok = layer_norm(x.permute(0, 2, 3, 1, 4), self.norm0)
        gate = linear(self.temporal_attn(tok), self.temporal_fc)
        y = x + gate.permute(0, 3, 1, 2, 4)
        y = self.spatial(y.reshape(b * t, h, w, c), train,
                         residual=x.reshape(b * t, h, w, c), rows=rows)
        return y.reshape(b, t, *y.shape[1:])


class Res18_3D(nn.Module):
    """Res18_3D (reference core/extractor.py:276-356): the RAFT CNN with a
    temporal-attention hook before every residual block.
    (B, T, H, W, 3) -> (B, T, H/8, W/8, output_dim)."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "batch"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm_fn, 64)
        self.layer1, self.layer2, self.layer3 = _layers(
            TemporalResidualBlock, norm_fn)
        self.conv2 = nn.Conv2d(DIMS[-1], output_dim, 1)

    def forward(self, x, train: bool = False, rows=None):
        """``rows``: the same slab of every frame's rows."""
        b, t = x.shape[:2]
        y = conv2d_rows(x.reshape(b * t, *x.shape[2:]), self.conv1, rows)
        rows = _coarse(rows, 2)
        y = torch.relu(norm(self.norm1, y, train, rows))
        y = y.reshape(b, t, *y.shape[1:])
        for layer in (self.layer1, self.layer2, self.layer3):
            for blk in layer:
                y = blk(y, train, rows)
                rows = _coarse(rows, blk.spatial.conv1.stride[0])
        out = conv2d(y.reshape(b * t, *y.shape[2:]), self.conv2)
        return out.reshape(b, t, *out.shape[1:])


class AttnBasicEncoder(BasicEncoder):
    """AttnBasicEncoder (reference core/extractor.py:434-511): a
    BasicEncoder that also returns the (N x N) softmax self-similarity of
    the first images' layer-2 features (f32). Call with (2B, H, W, 3)
    stacked image pairs; returns (feat1, feat2, attn)."""

    def forward(self, x, train: bool = False):
        b = x.shape[0] // 2
        y = self.stem(x, train)
        for i, layer in enumerate((self.layer1, self.layer2, self.layer3)):
            for blk in layer:
                y = blk(y, train)
            if i == 1:    # after layer2 (reference :489-491)
                flat = y[:b].reshape(b, -1, y.shape[-1]).float()
                attn = torch.softmax(flat @ flat.transpose(1, 2), dim=-1)
        out = conv2d(y, self.conv2)
        return out[:b], out[b:], attn
