"""Bilinear sampling at pixel coordinates (port of
streamflow_tpu/ops/sampler.py), matching torch
``F.grid_sample(align_corners=True, padding_mode='zeros')``.

``img`` is (B, H, W, C); ``coords`` is (B, ..., 2) in pixels, (x, y).
Samples outside the image contribute zero.
"""

from __future__ import annotations

import torch


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor,
                     mask: bool = False):
    b, h, w, c = img.shape
    cshape = coords.shape
    assert cshape[0] == b and cshape[-1] == 2
    pts = coords.reshape(b, -1, 2).float()
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat_img = img.reshape(b, h * w, c)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xi_c = xi.clamp(0, w - 1).long()
        yi_c = yi.clamp(0, h - 1).long()
        flat = (yi_c * w + xi_c)[..., None].expand(-1, -1, c)
        return torch.gather(flat_img, 1, flat) * valid[..., None].to(img.dtype)

    out = (tap(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + tap(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
           + tap(y0 + 1, x0) * (wy * (1 - wx))[..., None]
           + tap(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    out = out.reshape(*cshape[:-1], c)
    if mask:
        m = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
        return out, m.reshape(cshape[:-1]).to(img.dtype)
    return out
