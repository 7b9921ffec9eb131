"""All-pairs correlation (port of streamflow_tpu/ops/corr.py::CorrPyramid and
of the pooled-feature pyramid of the fused lookup,
_fused_lookup_kernel.py::pool_pyramid).

- ``CorrPyramid`` materialises the (B, N, Hl, Wl) volume of every level
  (level l = f1 . avgpool^l(f2) / sqrt(C), pooling in f32) and looks up a
  (2r+1)^2 window per query. It is the plain reference the K1 kernel is
  held against.
- ``pool_pyramid`` feeds ``ops.kernels.corr_lookup.FusedCorr``, which keeps
  only f1 and the pooled f2 pyramid and runs K1 per lookup.

Channel order of the L*(2r+1)^2 output: level outermost, then the window
flattened x-major (reference core/corr.py:33-44). Out-of-range taps give
zeros (grid_sample zero padding); pooling is VALID and drops odd rows.
"""

from __future__ import annotations

import math

import torch


def pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool over dims 1, 2 of (B, H, W, C), VALID
    (torch avg_pool2d drops the odd remainder), in x's dtype."""
    h2, w2 = (x.shape[1] // 2) * 2, (x.shape[2] // 2) * 2
    x = x[:, :h2, :w2]
    s = (x[:, 0::2, 0::2] + x[:, 0::2, 1::2]
         + x[:, 1::2, 0::2] + x[:, 1::2, 1::2])
    return s * 0.25


def pool_pyramid(fmap2: torch.Tensor, num_levels: int = 4):
    """Pooled fmap2 pyramid; pooling features commutes with the volume dot
    product, so level l of the pooled-feature volume equals the pooled
    volume."""
    levels = [fmap2]
    for _ in range(num_levels - 1):
        levels.append(pool2(levels[-1]))
    return levels


def lookup_level(corr_l: torch.Tensor, pts: torch.Tensor, level: int,
                 radius: int) -> torch.Tensor:
    """Bilinear (2r+1)^2 window of one level around pts / 2**level.

    corr_l (B, N, Hl, Wl); pts (B, N, 2) level-0 pixel (x, y). Returns
    (B, N, (2r+1)^2) f32, x-major. The (2r+2)^2 integer taps are gathered
    once and combined with the query's two fractional weights."""
    b, n, hl, wl = corr_l.shape
    k = 2 * radius + 1
    if hl == 0 or wl == 0:
        return corr_l.new_zeros((b, n, k * k), dtype=torch.float32)
    ctr = pts.float() / (2.0 ** level)
    x0, y0 = torch.floor(ctr[..., 0]), torch.floor(ctr[..., 1])
    fx = (ctr[..., 0] - x0)[..., None, None]
    fy = (ctr[..., 1] - y0)[..., None, None]
    offs = torch.arange(-radius, radius + 2, device=pts.device,
                        dtype=torch.float32)
    ys, xs = y0[..., None] + offs, x0[..., None] + offs      # (B, N, k+1)
    vy = (ys >= 0) & (ys <= hl - 1)
    vx = (xs >= 0) & (xs <= wl - 1)
    yi = torch.where(vy, ys, 0.0).long()
    xi = torch.where(vx, xs, 0.0).long()
    flat = (yi[..., :, None] * wl + xi[..., None, :]).reshape(b, n, -1)
    taps = torch.gather(corr_l.reshape(b, n, hl * wl).float(), 2, flat)
    taps = taps.reshape(b, n, k + 1, k + 1)
    taps = taps * (vy[..., :, None] & vx[..., None, :])
    rows = (1 - fy) * taps[:, :, :-1] + fy * taps[:, :, 1:]  # (B,N,k_y,k+1)
    out = (1 - fx) * rows[..., :-1] + fx * rows[..., 1:]     # (B,N,k_y,k_x)
    return out.transpose(-1, -2).reshape(b, n, k * k)


class CorrPyramid:
    """Materialised correlation pyramid for a batch of frame pairs."""

    def __init__(self, levels, radius: int):
        self.levels = levels
        self.radius = radius

    @classmethod
    def build(cls, fmap1, fmap2, num_levels: int = 4, radius: int = 4
              ) -> "CorrPyramid":
        b, h, w, c = fmap1.shape
        f1 = fmap1.reshape(b, h * w, c)
        levels = []
        f2 = fmap2
        for lv in range(num_levels):
            if lv:
                f2 = pool2(f2.float())
            hl, wl = f2.shape[1], f2.shape[2]
            vol = torch.bmm(f1.float(), f2.reshape(b, hl * wl, c).to(
                f1.dtype).float().transpose(1, 2)) * (1.0 / math.sqrt(c))
            levels.append(vol.reshape(b, h * w, hl, wl))
        return cls(levels, radius)

    def lookup(self, coords):
        """coords (B, H, W, 2) -> (B, H, W, L*(2r+1)^2) f32."""
        b, h, w, _ = coords.shape
        pts = coords.reshape(b, h * w, 2)
        out = torch.cat([lookup_level(lvl, pts, i, self.radius)
                         for i, lvl in enumerate(self.levels)], dim=-1)
        return out.reshape(b, h, w, -1)

