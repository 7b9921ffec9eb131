"""Twins-SVT-Large stages 1-2: StreamFlow's temporal token grid and the
per-frame ablation family (port of streamflow_tpu/layers/twins.py::
TwinsCSC, Twins, Twins1DConv, TwinsTemporalAttention, Twins3DConv and the
temporal hooks of TwinsBlock, :243-497; reference
core/encoders/twins_csc.py, twins.py, twins_1dconv.py,
twins_temporal_attention.py, twins_3dconv.py + timm twins_svt_large).

stage 1: patch 4, dim 128, heads 4, sr 8; stage 2: patch 2, dim 256,
heads 8, sr 4; each stage is [LGA block (7x7 windows), PEG, GSA block].
TwinsCSC: tokens of all T frames form one (T*h, w) grid, frames stacked
along the height. The per-frame family folds T into the batch (each frame
its own (h, w) grid), with per-block temporal hooks: ``"attn"``
(TwinsTemporalAttention: norm0, a zero-init TinyAttention over each
pixel's T tokens, a zero-init ``temporal_fc``, before the spatial
attention) or ``"1dconv"`` (Twins1DConv: a dirac-init Conv1d along T on
the MLP branch, before its residual); Twins3DConv adds a dirac-init 3x3x3
conv over (T, H, W) at the end. Tensors are (B, N, C) tokens; module
names follow the reference's torch keys (``svt.patch_embeds``,
``svt.pos_block``, ``svt.blocks``); the hooks, which no reference table
names, are named after the flax modules (``convert.py``).

Kernels: the LGA attention is K4; the GSA attention goes through K3
exactly where the JAX package calls flash attention (n > 16384 tokens an
image, or ``gsa_flash``: per frame that is stage 0 only at 440x1024); the
pre-norm MLP (norm2 + fc1 + gelu + fc2 + residual) is one K2
``ln_ffn_pair`` call, except under the ``"1dconv"`` hook, where the MLP
pair alone is K2 ``ffn_pair(residual=False)`` (JAX's fused ``Mlp``,
layers/common.py:85-101) and the temporal conv and the residual follow.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from streamflow_tpu_torch.layers.common import (Mlp, cast, conv2d, layer_norm,
                                                linear, on_slab)
from streamflow_tpu_torch.layers.temporal import TinyAttention
from streamflow_tpu_torch.ops.kernels.ffn_pair import ffn_pair, ln_ffn_pair
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
        return (layer_norm(y.reshape(b, t * hp * wp, y.shape[-1]),
                           self.norm), (t * hp, wp))


class PosConv(nn.Module):
    """Conditional position encoding: depthwise 3x3 conv + residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, x, size, rows=None):
        """``rows``: x is that slab of the grid's rows (the conv reaches
        one row across its edges)."""
        b, n, c = x.shape
        feat = x.reshape(b, size[0], size[1], c)
        y = on_slab(lambda f: conv2d(f, self.proj[0]), feat, 1, rows)
        return (y + feat).reshape(b, n, c)


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

    def forward(self, x, size, gsa_flash: bool = False, rows=None):
        """``rows``: x is that slab of the grid's rows, aligned to the sr
        cells: its queries attend to the keys and values of the whole
        grid (every slab's reduced tokens, gathered, projected as on one
        rank), and flash or not follows the whole grid's token count. An
        empty slab runs no conv and K3 on no queries."""
        b, n, c = x.shape
        tokens = n                       # the whole grid's
        nh = self.num_heads
        hd = c // nh
        q = linear(x, self.q).reshape(b, n, nh, hd).transpose(1, 2)
        q = q * hd ** -0.5
        feat = x.reshape(b, size[0], size[1], c)
        sr = self.sr_ratio
        if rows is not None and rows.size:
            # the slab at the top of the whole grid's rows, zeros below:
            # cuDNN picks its algorithm by shape, and at the whole grid's
            # each of the slab's cells sums as on one rank (an H100 at f32
            # summed the slab's cells in another order at the slab's own
            # shape)
            feat = F.pad(feat, (0, 0, 0, 0, 0, rows.total - rows.size))
        kvin = conv2d(feat, self.sr)
        if rows is not None:
            kvin = kvin[:, :rows.stop // sr - rows.start // sr]
        kvin = layer_norm(kvin.reshape(b, -1, c), self.norm)
        if rows is not None:   # every slab's cells, then kv at one rank's M
            kvin = rows.coarse(sr).gather(kvin, 1, unit=size[1] // sr)
            tokens = rows.total * size[1]
        kv = linear(kvin, self.kv).reshape(b, -1, 2, nh, hd)
        k = kv[:, :, 0].transpose(1, 2)
        v = kv[:, :, 1].transpose(1, 2)
        if gsa_flash or tokens > GSA_FLASH_TOKENS:
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
        else:
            a = torch.softmax(q.float() @ k.float().transpose(-1, -2), -1)
            out = (a.to(v.dtype).float() @ v.float()).to(v.dtype)
        return linear(out.transpose(1, 2).reshape(b, n, c), self.proj)


def _dirac_(w: torch.Tensor) -> torch.Tensor:
    """A conv kernel (O, I, k...) that passes channel o % I through at the
    centre tap (JAX's dirac init): the identity for O == I."""
    with torch.no_grad():
        w.zero_()
        o, i = w.shape[:2]
        centre = tuple(k // 2 for k in w.shape[2:])
        for c in range(o):
            w[(c, c % i) + centre] = 1.0
    return w


class TwinsBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)); x + mlp(LN(x)). ``ws=None`` is a
    GSA block, otherwise LGA with that window. ``temporal`` is "none",
    "attn" or "1dconv" (the per-frame hooks; tokens (B*T, N, C) of t
    frames)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 sr_ratio: int = 1, ws=None, temporal: str = "none",
                 gelu: str = "erf"):
        super().__init__()
        self.temporal = temporal
        self.gelu = gelu    # K2's gelu variant (config.ffn_gelu_of)
        if temporal == "attn":
            self.norm0 = nn.LayerNorm(dim, eps=1e-5)
            self.temporal_attn = TinyAttention(dim, num_heads)
            self.temporal_fc = nn.Linear(dim, dim)
            nn.init.zeros_(self.temporal_fc.weight)
            nn.init.zeros_(self.temporal_fc.bias)
        elif temporal == "1dconv":
            self.temporal_conv = nn.Conv1d(dim, dim, 3, padding=1)
            _dirac_(self.temporal_conv.weight)
            nn.init.zeros_(self.temporal_conv.bias)
        elif temporal != "none":
            raise ValueError(f"unknown temporal hook {temporal!r}")
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        if ws is None:
            self.attn = GlobalSubSampleAttn(dim, num_heads, sr_ratio)
        else:
            self.attn = LocallyGroupedAttn(dim, num_heads, ws)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)

    def forward(self, x, size, gsa_flash: bool = False, t: int = 1,
                rows=None):
        """``rows``: x is that slab of the grid's rows (GSA blocks;
        ``parallel/seq.py``)."""
        bt, n, c = x.shape

        def to_time(tok):      # (B*T, N, C) -> (B, N, T, C)
            return tok.reshape(bt // t, t, n, c).transpose(1, 2)

        def from_time(tok):
            return tok.transpose(1, 2).reshape(bt, n, c)

        if self.temporal == "attn":
            tok = self.temporal_attn(to_time(layer_norm(x, self.norm0)))
            x = x + from_time(linear(tok, self.temporal_fc))
        if isinstance(self.attn, GlobalSubSampleAttn):
            x = x + self.attn(layer_norm(x, self.norm1), size, gsa_flash,
                              rows)
        else:
            x = x + self.attn(layer_norm(x, self.norm1), size)
        n2, fc1, fc2 = self.norm2, self.mlp.fc1, self.mlp.fc2
        if self.temporal != "1dconv":
            return ln_ffn_pair(x.contiguous(), *(cast(p, x) for p in (
                n2.weight, n2.bias, fc1.weight, fc1.bias, fc2.weight,
                fc2.bias)), add_res=True, gelu=self.gelu)
        y = ffn_pair(layer_norm(x, n2).contiguous(), *(cast(p, x) for p in (
            fc1.weight, fc1.bias, fc2.weight, fc2.bias)), residual=False,
            gelu=self.gelu)
        conv = self.temporal_conv
        # (B*N, C, T)
        tok = to_time(y).reshape(bt // t * n, t, c).transpose(1, 2)
        tok = F.conv1d(tok, cast(conv.weight, x), cast(conv.bias, x),
                       padding=1)
        y = from_time(tok.transpose(1, 2).reshape(bt // t, n, t, c))
        return x + y


class _SVT(nn.Module):
    def __init__(self, cfg=SVT_LARGE, in_chans: int = 3, hook: str = "none",
                 gelu: str = "erf"):
        super().__init__()
        dims = cfg["embed_dims"]
        self.patch_embeds = nn.ModuleList(
            TemporalPatchEmbed(in_chans if i == 0 else dims[i - 1], dims[i],
                               cfg["patch_sizes"][i]) for i in range(2))
        self.pos_block = nn.ModuleList(PosConv(d) for d in dims)
        self.blocks = nn.ModuleList(
            nn.ModuleList([
                TwinsBlock(dims[i], cfg["num_heads"][i], cfg["mlp_ratio"],
                           cfg["sr_ratios"][i], ws=cfg["ws"], temporal=hook,
                           gelu=gelu),
                TwinsBlock(dims[i], cfg["num_heads"][i], cfg["mlp_ratio"],
                           cfg["sr_ratios"][i], ws=None, temporal=hook,
                           gelu=gelu)])
            for i in range(2))


class TwinsEncoder(nn.Module):
    """(B, T, H, W, 3) -> (B, T, H/8, W/8, 256) (JAX ``_TwinsStages`` and
    the encoder classes around it). ``temporal=True`` is Twins_CSC's one
    token grid over all T frames; ``temporal=False`` folds T into the
    batch, each frame its own grid, with the blocks' ``hook`` ("none",
    "attn" or "1dconv") and, with ``conv3d``, the final dirac-init 3x3x3
    ``temporal_conv`` over (T, H, W) added to the output."""

    def __init__(self, gsa_flash: bool = False, temporal: bool = True,
                 hook: str = "none", conv3d: bool = False,
                 gelu: str = "erf"):
        super().__init__()
        self.gsa_flash, self.temporal = gsa_flash, temporal
        self.svt = _SVT(hook=hook, gelu=gelu)
        self.hook = hook
        if conv3d:
            dim = SVT_LARGE["embed_dims"][-1]
            self.temporal_conv = nn.Conv3d(dim, dim, 3, padding=1)
            _dirac_(self.temporal_conv.weight)
            nn.init.zeros_(self.temporal_conv.bias)
        else:
            self.temporal_conv = None

    def forward(self, x, train: bool = False):
        """``train`` is taken for the CNN encoders' sake and unused."""
        b, t = x.shape[:2]
        if not self.temporal:
            x = x.reshape(b * t, 1, *x.shape[2:])
        t_grid = t if self.temporal else 1
        t_hook = t if self.hook != "none" else 1
        svt = self.svt
        for i in range(2):
            x, size = svt.patch_embeds[i](x)
            lga, gsa = svt.blocks[i]
            x = svt.pos_block[i](lga(x, size, t=t_hook), size)
            x = gsa(x, size, self.gsa_flash, t=t_hook)
            ht, w = size
            x = x.reshape(x.shape[0], t_grid, ht // t_grid, w, -1)
        return self.conv3d(x.reshape(b, t, *x.shape[2:]))

    def conv3d(self, x):
        """x (B, T, h, w, C) plus the dirac-init 3x3x3 ``temporal_conv``
        over (T, h, w) of it (Twins3DConv); x itself without one."""
        if self.temporal_conv is None:
            return x
        conv = self.temporal_conv
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), cast(conv.weight, x),
                     cast(conv.bias, x), padding=1)
        return x + y.permute(0, 2, 3, 4, 1)
