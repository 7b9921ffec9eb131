"""GMA global motion aggregation (port of streamflow_tpu/layers/gma.py,
reference core/gma.py:34-300).

GMAAttention / GMAAggregate in the JAX package's "flash" mode only:
GMAAttention returns the pre-scaled (q, k) once per forward, and every
refinement iteration's GMAAggregate runs softmax(q k^T) v through the K3
flash-attention wrapper (the kernel on a CUDA tensor, its plain chunked
version on a CPU tensor; d=128, or d=384 under the UMT encoder's
decoder_dim=768). The (N, N) map of the "full" mode is never
materialised.

The temporal aggregates (JAX :99-263; reference TemporalAttention,
TemporalAggregate, SpatioTemporalAggregate(2), TMMAggregate), which no
model of either package builds: an (N, N) attention map over the joint
spatial grid of the frames (``TemporalAttentionMap``) and the aggregates
that apply such maps, each behind zero-init gammas. Einsums, a softmax
and 1x1 convs, with no kernel in either package; products of ``attn``
accumulate in f32 (JAX's ``preferred_element_type``). Channel-last, as
JAX's; each module takes the channel widths that flax infers at its
first call.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from streamflow_tpu_torch.layers.common import pointwise
from streamflow_tpu_torch.ops.kernels.flash_attention import flash_attention


class GMAAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 1, dim_head: int = 128):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qk = nn.Conv2d(dim, 2 * heads * dim_head, 1, bias=False)

    def forward(self, fmap):
        """fmap (B, H, W, C) -> the pre-scaled (q, k), each
        (B, heads, N, dim_head)."""
        b, h, w, _ = fmap.shape
        q, k = pointwise(fmap, self.to_qk).chunk(2, dim=-1)
        q = q.reshape(b, h * w, self.heads, self.dim_head).transpose(1, 2)
        k = k.reshape(b, h * w, self.heads, self.dim_head).transpose(1, 2)
        q = q * self.dim_head ** -0.5
        return q.contiguous(), k.contiguous()


class GMAAggregate(nn.Module):
    """out = fmap + gamma * (attn @ v(fmap)); gamma starts at zero."""

    def __init__(self, dim: int, heads: int = 1, dim_head: int = 128):
        super().__init__()
        assert heads * dim_head == dim, "the 'project' conv is not ported"
        self.heads, self.dim_head = heads, dim_head
        self.to_v = nn.Conv2d(dim, heads * dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, qk, fmap, whole=None):
        """``whole``: the whole grid's fmap, of which fmap and q are one
        slab of rows (``parallel/seq.py``), k and v the whole's."""
        b, h, w, c = fmap.shape
        v = pointwise(fmap if whole is None else whole, self.to_v)
        v = v.reshape(b, -1, self.heads, self.dim_head).transpose(1, 2)
        out = flash_attention(qk[0], qk[1], v.contiguous())
        out = out.transpose(1, 2).reshape(b, h, w, c).to(fmap.dtype)
        return fmap + self.gamma.to(fmap.dtype) * out


def _heads(x, heads: int):
    """(B, N, C) -> (B, heads, N, C / heads)."""
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).transpose(1, 2)


def _apply(attn, v):
    """attn (B, heads, N, M) . v (B, heads, M, D), accumulated in f32."""
    return attn.float() @ v.float()


class _GammaAggregate(nn.Module):
    """The spatial half shared by the aggregates: ``to_v``, attn . v,
    [``project``], ``gamma``."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 project: bool):
        super().__init__()
        self.heads, inner = heads, heads * dim_head
        self.to_v = nn.Conv2d(dim, inner, 1, bias=False)
        self.project = (nn.Conv2d(inner, dim, 1, bias=False)
                        if project and inner != dim else None)
        self.gamma = nn.Parameter(torch.zeros(1))

    def spatial(self, attn, fmap):
        """fmap (B, H, W, C) -> fmap + gamma * [project](attn . v)."""
        b, h, w, _ = fmap.shape
        v = _heads(pointwise(fmap, self.to_v).reshape(b, h * w, -1),
                   self.heads)
        out = _apply(attn, v).transpose(1, 2).reshape(b, h, w, -1)
        out = out.to(fmap.dtype)
        if self.project is not None:
            out = pointwise(out, self.project)
        return fmap + self.gamma.to(fmap.dtype) * out


class TemporalAttentionMap(nn.Module):
    """Cross-frame attention map: q and k projected from the channel concat
    of the F frames, softmax over the joint spatial grid. x (B, F, H, W, C)
    -> (B, 1, H*W, H*W) f32."""

    def __init__(self, dim: int, num_frames: int):
        super().__init__()
        fc = num_frames * dim
        self.to_qk = nn.Conv2d(fc, 2 * fc, 1, bias=False)

    def forward(self, x):
        b, f, h, w, c = x.shape
        joint = x.permute(0, 2, 3, 1, 4).reshape(b, h, w, f * c)
        q, k = pointwise(joint, self.to_qk).chunk(2, dim=-1)
        q = q * (f * c) ** -0.5
        sim = (q.float().reshape(b, h * w, f * c)
               @ k.float().reshape(b, h * w, f * c).transpose(1, 2))
        return torch.softmax(sim, dim=-1)[:, None]


class TemporalAggregate(nn.Module):
    """fmap + temporal_gamma * temporal_project(attn . to_v(fmap)), the
    projection unconditional."""

    def __init__(self, dim: int, heads: int = 1, dim_head: int = 128):
        super().__init__()
        self.heads, inner = heads, heads * dim_head
        self.to_v = nn.Conv2d(dim, inner, 1, bias=False)
        self.temporal_project = nn.Conv2d(inner, dim, 1, bias=False)
        self.temporal_gamma = nn.Parameter(torch.zeros(1))

    def forward(self, temporal_attn, fmap):
        b, h, w, _ = fmap.shape
        v = _heads(pointwise(fmap, self.to_v).reshape(b, h * w, -1),
                   self.heads)
        out = _apply(temporal_attn, v).transpose(1, 2).reshape(b, h, w, -1)
        out = pointwise(out.to(fmap.dtype), self.temporal_project)
        return fmap + self.temporal_gamma.to(fmap.dtype) * out


class SpatioTemporalAggregate(_GammaAggregate):
    """The spatial GMA aggregate, then a temporal re-aggregation of its
    result behind its own gamma; ``temporal_attn=None`` skips the temporal
    half, ``temporal_project=False`` its projection."""

    def __init__(self, dim: int, heads: int = 1, dim_head: int = 128,
                 temporal_project: bool = True):
        super().__init__(dim, heads, dim_head, project=True)
        self.temporal_project = (nn.Conv2d(dim, dim, 1, bias=False)
                                 if temporal_project else None)
        self.temporal_gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn, temporal_attn, fmap):
        out = self.spatial(attn, fmap)
        if temporal_attn is None:
            return out
        b, h, w, c = out.shape
        t = _apply(temporal_attn, _heads(out.reshape(b, h * w, c),
                                         self.heads))
        t = t.transpose(1, 2).reshape(b, h, w, -1).to(out.dtype)
        if self.temporal_project is not None:
            t = pointwise(t, self.temporal_project)
        return out + self.temporal_gamma.to(out.dtype) * t


class SpatioTemporalAggregate2(_GammaAggregate):
    """The spatial aggregate over the joint (H, F*W) grid of the F frames
    side by side: ``attn`` spans all frames. fmap (B*F, H, W, C)."""

    def __init__(self, num_frames: int, dim: int, heads: int = 1,
                 dim_head: int = 128):
        super().__init__(dim, heads, dim_head, project=True)
        self.num_frames = num_frames

    def forward(self, attn, fmap):
        bf, h, w, c = fmap.shape
        f = self.num_frames
        b = bf // f
        v = pointwise(fmap, self.to_v)
        inner = v.shape[-1]
        v = v.reshape(b, f, h, w, inner).permute(0, 2, 1, 3, 4)
        v = _heads(v.reshape(b, h * f * w, inner), self.heads)
        out = _apply(attn, v).transpose(1, 2).reshape(b, h, f, w, inner)
        out = out.permute(0, 2, 1, 3, 4).reshape(bf, h, w, inner)
        out = out.to(fmap.dtype)
        if self.project is not None:
            out = pointwise(out, self.project)
        return fmap + self.gamma.to(fmap.dtype) * out


class TMMAggregate(_GammaAggregate):
    """The spatial aggregate per frame, then a temporal aggregate over the
    channel concat of the F frames as one token grid, each behind its own
    gamma. fmap (B*F, H, W, C), heads * dim_head == C."""

    def __init__(self, num_frames: int, dim: int, heads: int = 1,
                 dim_head: int = 128):
        super().__init__(dim, heads, dim_head, project=False)
        self.num_frames = num_frames
        self.temporal_gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn, temporal_attn, fmap):
        bf, h, w, c = fmap.shape
        f = self.num_frames
        b = bf // f
        out = self.spatial(attn, fmap)
        joint = out.reshape(b, f, h, w, c).permute(0, 2, 3, 1, 4)
        joint = joint.reshape(b, h * w, f * c)
        t = _apply(temporal_attn, _heads(joint, self.heads))
        t = t.transpose(1, 2).reshape(b, h * w, f * c).to(out.dtype)
        joint = joint + self.temporal_gamma.to(joint.dtype) * t
        joint = joint.reshape(b, h, w, f, c).permute(0, 3, 1, 2, 4)
        return joint.reshape(bf, h, w, c)
