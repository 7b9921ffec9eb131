"""GMA global motion aggregation (port of streamflow_tpu/layers/gma.py::
GMAAttention / GMAAggregate, reference core/gma.py:34-104).

The JAX package's "flash" mode only: GMAAttention returns the pre-scaled
(q, k) once per forward, and every refinement iteration's GMAAggregate runs
softmax(q k^T) v through the K3 flash-attention wrapper (the kernel on a
CUDA tensor, its plain chunked version on a CPU tensor). The (N, N) map of
the "full" mode is never materialised.
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

    def forward(self, qk, fmap):
        b, h, w, c = fmap.shape
        v = pointwise(fmap, self.to_v)
        v = v.reshape(b, h * w, self.heads, self.dim_head).transpose(1, 2)
        out = flash_attention(qk[0], qk[1], v.contiguous())
        out = out.transpose(1, 2).reshape(b, h, w, c).to(fmap.dtype)
        return fmap + self.gamma.to(fmap.dtype) * out
