"""Coordinate grids (port of streamflow_tpu/ops/coords.py::coords_grid).

A coordinate field is (..., H, W, 2) with channel 0 = x (along W) and
channel 1 = y (along H).
"""

from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int, device=None,
                dtype=torch.float32, y0: int = 0) -> torch.Tensor:
    """Identity coordinate grid, shape (batch, ht, wd, 2), channels (x, y);
    its rows are the grid's rows y0 to y0 + ht (a slab's, in the
    sequence-sharded forward)."""
    ys = torch.arange(y0, y0 + ht, device=device, dtype=dtype)
    xs = torch.arange(wd, device=device, dtype=dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)
    return grid[None].expand(batch, ht, wd, 2)
