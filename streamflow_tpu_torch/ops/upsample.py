"""Convex upsampling of low-resolution flow (port of
streamflow_tpu/ops/upsample.py).

``flow`` is (B, h, w, 2); ``mask`` is (B, h, w, 9*r*r) with channel
k*r*r + i*r + j, k = ki*3 + kj the 3x3 position (F.unfold order) and (i, j)
the sub-pixel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _neighborhood3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) -> (B, h, w, 9, C), zero-padded, k = ki*3 + kj."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([xp[:, ki:ki + h, kj:kj + w] for ki in range(3)
                        for kj in range(3)], dim=3)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    ratio: int = 8) -> torch.Tensor:
    """(B,h,w,2), (B,h,w,9*r*r) -> (B, h*r, w*r, 2), computed in f32."""
    b, h, w, _ = flow.shape
    r = ratio
    m = torch.softmax(mask.reshape(b, h, w, 9, r, r).float(), dim=3)
    nb = _neighborhood3x3(ratio * flow.float())               # (B,h,w,9,2)
    up = torch.einsum("bhwkij,bhwkc->bhwijc", m, nb)          # (B,h,w,r,r,2)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, h * r, w * r, 2)
