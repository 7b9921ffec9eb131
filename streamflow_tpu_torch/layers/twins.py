"""Twins-SVT-Large stages 1-2 with StreamFlow's temporal token grid (port of
streamflow_tpu/layers/twins.py::TwinsCSC; reference
core/encoders/twins_csc.py + timm twins_svt_large).

stage 1: patch 4, dim 128, heads 4, sr 8; stage 2: patch 2, dim 256,
heads 8, sr 4; each stage is [LGA block (7x7 windows), PEG, GSA block].
Tokens of all T frames form one (T*h, w) grid, frames stacked along the
height. Tensors are (B, N, C) tokens; module names follow the reference's
torch keys (``svt.patch_embeds``, ``svt.pos_block``, ``svt.blocks``).

Kernels: the LGA attention is K4; the GSA attention goes through K3
exactly where the JAX package calls flash attention (n > 16384 tokens or
``gsa_flash``); the pre-norm MLP (norm2 + fc1 + gelu + fc2 + residual) is
one K2 ``ln_ffn_pair`` call.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from streamflow_tpu_torch.layers.common import (Mlp, cast, conv2d, layer_norm,
                                                linear)
from streamflow_tpu_torch.ops.kernels.ffn_pair import ln_ffn_pair
from streamflow_tpu_torch.ops.kernels.flash_attention import flash_attention
from streamflow_tpu_torch.ops.kernels.lga_attention import lga_attention

SVT_LARGE = dict(embed_dims=(128, 256), num_heads=(4, 8), mlp_ratio=4,
                 sr_ratios=(8, 4), patch_sizes=(4, 2), ws=7)
GSA_FLASH_TOKENS = 16384


class TemporalPatchEmbed(nn.Module):
    """(B, T, H, W, C_in) -> tokens (B, T*h*w, E), grid (T*h, w)."""

    def __init__(self, c_in: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(c_in, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        b, t, h, w, c = x.shape
        y = conv2d(x.reshape(b * t, h, w, c), self.proj)
        hp, wp = y.shape[1], y.shape[2]
        return (layer_norm(y.reshape(b, t * hp * wp, -1), self.norm),
                (t * hp, wp))


class PosConv(nn.Module):
    """Conditional position encoding: depthwise 3x3 conv + residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, x, size):
        b, n, c = x.shape
        feat = x.reshape(b, size[0], size[1], c)
        return (conv2d(feat, self.proj[0]) + feat).reshape(b, n, c)


class LocallyGroupedAttn(nn.Module):
    """Windowed MHA over ws x ws groups; the grid is zero-padded to window
    multiples BEFORE the qkv projection (padded tokens hold qkv = bias)."""

    def __init__(self, dim: int, num_heads: int, ws: int = 7):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, size):
        b, n, c = x.shape
        ht, w = size
        ws = self.ws
        xg = F.pad(x.reshape(b, ht, w, c),
                   (0, 0, 0, (ws - w % ws) % ws, 0, (ws - ht % ws) % ws))
        out = lga_attention(linear(xg, self.qkv).contiguous(), ws,
                            self.num_heads)
        return linear(out, self.proj)[:, :ht, :w].reshape(b, n, c)


class GlobalSubSampleAttn(nn.Module):
    """Global attention against sr-subsampled keys/values."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, size, gsa_flash: bool = False):
        b, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        q = linear(x, self.q).reshape(b, n, nh, hd).transpose(1, 2)
        q = q * hd ** -0.5
        kvin = conv2d(x.reshape(b, size[0], size[1], c), self.sr)
        kvin = layer_norm(kvin.reshape(b, -1, c), self.norm)
        kv = linear(kvin, self.kv).reshape(b, -1, 2, nh, hd)
        k = kv[:, :, 0].transpose(1, 2)
        v = kv[:, :, 1].transpose(1, 2)
        if gsa_flash or n > GSA_FLASH_TOKENS:
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
        else:
            a = torch.softmax(q.float() @ k.float().transpose(-1, -2), -1)
            out = (a.to(v.dtype).float() @ v.float()).to(v.dtype)
        return linear(out.transpose(1, 2).reshape(b, n, c), self.proj)


class TwinsBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)); x + mlp(LN(x)). ``ws=None`` is a
    GSA block, otherwise LGA with that window."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 sr_ratio: int = 1, ws=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        if ws is None:
            self.attn = GlobalSubSampleAttn(dim, num_heads, sr_ratio)
        else:
            self.attn = LocallyGroupedAttn(dim, num_heads, ws)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)

    def forward(self, x, size, gsa_flash: bool = False):
        if isinstance(self.attn, GlobalSubSampleAttn):
            x = x + self.attn(layer_norm(x, self.norm1), size, gsa_flash)
        else:
            x = x + self.attn(layer_norm(x, self.norm1), size)
        n2, fc1, fc2 = self.norm2, self.mlp.fc1, self.mlp.fc2
        return ln_ffn_pair(x.contiguous(), *(cast(p, x) for p in (
            n2.weight, n2.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)),
            add_res=True)


class _SVT(nn.Module):
    def __init__(self, cfg=SVT_LARGE, in_chans: int = 3):
        super().__init__()
        dims = cfg["embed_dims"]
        self.patch_embeds = nn.ModuleList(
            TemporalPatchEmbed(in_chans if i == 0 else dims[i - 1], dims[i],
                               cfg["patch_sizes"][i]) for i in range(2))
        self.pos_block = nn.ModuleList(PosConv(d) for d in dims)
        self.blocks = nn.ModuleList(
            nn.ModuleList([
                TwinsBlock(dims[i], cfg["num_heads"][i], cfg["mlp_ratio"],
                           cfg["sr_ratios"][i], ws=cfg["ws"]),
                TwinsBlock(dims[i], cfg["num_heads"][i], cfg["mlp_ratio"],
                           cfg["sr_ratios"][i], ws=None)])
            for i in range(2))


class TwinsCSC(nn.Module):
    """(B, T, H, W, 3) -> (B, T, H/8, W/8, 256)."""

    def __init__(self, gsa_flash: bool = False):
        super().__init__()
        self.gsa_flash = gsa_flash
        self.svt = _SVT()

    def forward(self, x):
        t = x.shape[1]
        svt = self.svt
        for i in range(2):
            x, size = svt.patch_embeds[i](x)
            lga, gsa = svt.blocks[i]
            x = svt.pos_block[i](lga(x, size), size)
            x = gsa(x, size, self.gsa_flash)
            ht, w = size
            x = x.reshape(x.shape[0], t, ht // t, w, -1)
        return x
