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

``UMT.forward(x, rows=...)`` runs one slab of each frame's token rows
(``parallel.exchange.Rows`` over the H/16 grid; the sequence-sharded
forward, ``parallel/seq.py``): the patch embed of the slab's 16-row
cells (no halo), LayerNorm, ``qkv``, ``proj``, the Mlp and the residuals
per token; in each block the slab's k and v are gathered whole along
the rows of their (B, T, rows, W, C) view, which keeps the one-process
token order (t, row, col), and K3 runs the slab's queries against every
key. k and v are computed on the slab and gathered, rather than the
normed tokens gathered and k and v computed whole on every rank (as
GSA's are, ``layers/twins.py``): that form would move half the bytes
but repeat the whole clip's k and v products on every rank, and the
products on the slab's tokens (q, ``proj``, the Mlp) run at the slab's
token count either way. On an H100 the sharded UMT forward still gives
the one-process bits (``chip_smoke.py`` phase 39 (e)).
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

    def forward(self, x, rows=None, grid=None):
        """x (B, N, C) tokens; ``rows`` and ``grid`` = (T, W): x is the
        slab's tokens (t, row, col) of a (T, rows.total, W) grid, whose
        keys and values are gathered whole."""
        b, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = linear(x, self.qkv)
        q = qkv[..., :c].reshape(b, n, nh, hd).transpose(1, 2)
        kv = qkv[..., c:]
        if rows is not None and not rows.alone:
            t, w = grid
            kv = rows.gather(kv.reshape(b, t, rows.size, w, 2 * c), 2)
        kv = kv.reshape(b, -1, 2, nh, hd).permute(2, 0, 3, 1, 4)
        out = flash_attention((q * hd ** -0.5).contiguous(),
                              kv[0].contiguous(), kv[1].contiguous())
        return linear(out.transpose(1, 2).reshape(b, n, c), self.proj)


class ViTBlock(nn.Module):
    def __init__(self, dim: int = 768, num_heads: int = 12,
                 mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)

    def forward(self, x, rows=None, grid=None):
        x = x + self.attn(layer_norm(x, self.norm1), rows, grid)
        return x + self.mlp(layer_norm(x, self.norm2))


class PatchEmbed(nn.Module):
    """The reference's tubelet-1 Conv3d, applied per frame as a 2-D conv."""

    def __init__(self, dim: int = 768, patch: int = 16):
        super().__init__()
        self.proj = nn.Conv3d(3, dim, (1, patch, patch),
                              stride=(1, patch, patch))

    def forward(self, x):
        """x (N, H, W, 3) -> (N, H/16, W/16, dim); no rows (an empty
        slab): no rows out, and no call."""
        w = self.proj.weight
        if not x.shape[1]:
            return x.new_empty(x.shape[0], 0, x.shape[2] // w.shape[-1],
                               w.shape[0])
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

    def forward(self, x, train: bool = False, rows=None):
        """``train`` is the encoders' common argument; UMT has no
        BatchNorm, so it changes nothing. ``rows``: x holds the slab's 16
        x ``rows.size`` rows of each frame; returns the slab's tokens (B,
        T, rows.size, W/16, dim) (the module docstring)."""
        b, t, h, w, c = x.shape
        y = self.patch_embed(x.reshape(b * t, h, w, c))
        hp, wp = y.shape[1], y.shape[2]
        tokens = y.reshape(b, t * hp * wp, self.dim)
        for blk in self.blocks:
            tokens = blk(tokens, rows, (t, wp))
        return tokens.reshape(b, t, hp, wp, self.dim)
