"""Temporal attention module (port of streamflow_tpu/layers/temporal.py::
TemporalLayer, reference TemporalLayer2, core/update.py:453-513).

A pre-norm ViT block (1 head, mlp ratio 2, qkv without bias) applied along
T: every pixel's T-frame trajectory is a length-T token sequence. Every
parameter starts at zero (the reference's zero_module), so the layer is an
identity at initialisation.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from streamflow_tpu_torch.layers.common import Mlp, layer_norm, linear


class TinyAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        """x (..., T, C)."""
        *lead, t, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = linear(x, self.qkv).reshape(*lead, t, 3, nh, hd)
        q, k, v = (qkv[..., i, :, :].transpose(-2, -3) for i in range(3))
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(-2, -3).reshape(*lead, t, c)
        return linear(out, self.proj)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 1, mlp_ratio: int = 2):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = TinyAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)

    def forward(self, x):
        x = x + self.attn(layer_norm(x, self.norm1))
        return x + self.mlp(layer_norm(x, self.norm2))


class TemporalLayer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.transformer_block = TransformerBlock(dim)
        for p in self.parameters():
            nn.init.zeros_(p)

    def forward(self, x):
        """(B, T, H, W, C) -> (B, T, H, W, C)."""
        tokens = x.permute(0, 2, 3, 1, 4)
        return self.transformer_block(tokens).permute(0, 3, 1, 2, 4)
