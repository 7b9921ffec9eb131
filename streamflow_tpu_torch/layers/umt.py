"""UMT video ViT encoder (port of streamflow_tpu/layers/umt.py::_ViTBlock /
UMT, :22-71; reference core/encoders/umt.py:209-368): the first 4 blocks of
a VideoMAE/UMT-style ViT-B/16 with joint space-time attention over all
T*h*w tokens (tubelet size 1), model ratio 16.

The patch embedding keeps the reference's Conv3d weight (768, 3, 1, 16, 16)
and runs it as the 16x16, stride-16 2-D convolution of each frame without
padding, so a remainder of H or W is dropped as JAX's ``VALID`` drops it.
Each block: LayerNorm (eps 1e-5), ``qkv`` with one 3C bias (JAX's flax
Dense; the converter assembles it as [q_bias, 0, v_bias] from a reference
checkpoint), heads split as (b, n, 3, nh, hd), q scaled by hd^-0.5, then
softmax(q k^T) v through the K3 flash-attention wrapper (12 heads of
d=64), ``proj`` and a residual, then the erf-gelu ``Mlp`` (fc1 -> gelu ->
fc2, plain matmuls: JAX computes this unfused Mlp outside Pallas) and a
residual.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from streamflow_tpu_torch.layers.common import Mlp, cast, layer_norm, linear
from streamflow_tpu_torch.ops.kernels.flash_attention import flash_attention


class Attention(nn.Module):
    def __init__(self, dim: int = 768, num_heads: int = 12):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = linear(x, self.qkv).reshape(b, n, 3, nh, hd).permute(
            2, 0, 3, 1, 4)
        q = (qkv[0] * hd ** -0.5).contiguous()
        out = flash_attention(q, qkv[1].contiguous(), qkv[2].contiguous())
        return linear(out.transpose(1, 2).reshape(b, n, c), self.proj)


class ViTBlock(nn.Module):
    def __init__(self, dim: int = 768, num_heads: int = 12,
                 mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)

    def forward(self, x):
        x = x + self.attn(layer_norm(x, self.norm1))
        return x + self.mlp(layer_norm(x, self.norm2))


class PatchEmbed(nn.Module):
    """The reference's tubelet-1 Conv3d, applied per frame as a 2-D conv."""

    def __init__(self, dim: int = 768, patch: int = 16):
        super().__init__()
        self.proj = nn.Conv3d(3, dim, (1, patch, patch),
                              stride=(1, patch, patch))

    def forward(self, x):
        """x (N, H, W, 3) -> (N, H/16, W/16, dim)."""
        w = self.proj.weight
        y = F.conv2d(x.permute(0, 3, 1, 2), cast(w[:, :, 0], x),
                     cast(self.proj.bias, x), stride=self.proj.stride[1:])
        return y.permute(0, 2, 3, 1)


class UMT(nn.Module):
    """(B, T, H, W, 3) -> (B, T, H/16, W/16, 768)."""

    def __init__(self, depth: int = 4, dim: int = 768, num_heads: int = 12):
        super().__init__()
        self.dim = dim
        self.patch_embed = PatchEmbed(dim)
        self.blocks = nn.ModuleList(ViTBlock(dim, num_heads)
                                    for _ in range(depth))

    def forward(self, x, train: bool = False):
        """``train`` is the encoders' common argument; UMT has no
        BatchNorm, so it changes nothing."""
        b, t, h, w, c = x.shape
        y = self.patch_embed(x.reshape(b * t, h, w, c))
        hp, wp = y.shape[1], y.shape[2]
        tokens = y.reshape(b, t * hp * wp, self.dim)
        for blk in self.blocks:
            tokens = blk(tokens)
        return tokens.reshape(b, t, hp, wp, self.dim)
