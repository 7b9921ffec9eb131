"""Tiled high-resolution inference (port of streamflow_tpu/tiling.py;
reference evaluate_mf.py:887-916, 985-1053): overlapping train-size
patches blended with Gaussian weights.

Every tile has the same shape, so a shape-bucketed forward
(``evaluation.GraphedForward``) captures one graph and replays it for each
tile. The blend runs on the device of the images: each weighted tile is
added into its window of one running sum.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

TRAIN_SIZE = (432, 960)


def compute_grid_indices(image_shape: Sequence[int],
                         patch_size: Sequence[int] = TRAIN_SIZE,
                         min_overlap: int = 20) -> List[Tuple[int, int]]:
    """Top-left corners of overlapping patches; final row/col flush with the
    boundary (reference :887-895)."""
    if min_overlap >= patch_size[0] or min_overlap >= patch_size[1]:
        raise ValueError("min_overlap must be smaller than the patch")
    hs = list(range(0, image_shape[0], patch_size[0] - min_overlap))
    ws = list(range(0, image_shape[1], patch_size[1] - min_overlap))
    hs[-1] = image_shape[0] - patch_size[0]
    ws[-1] = image_shape[1] - patch_size[1]
    return [(h, w) for h in hs for w in ws]


def gaussian_patch_weight(patch_size: Sequence[int] = TRAIN_SIZE,
                          sigma: float = 0.05) -> np.ndarray:
    """Radial Gaussian over the patch, peaked at the center (reference
    compute_weight, :898-916)."""
    ph, pw = patch_size
    h = (np.arange(ph) / ph - 0.5)[:, None]
    w = (np.arange(pw) / pw - 0.5)[None, :]
    r = np.sqrt(h ** 2 + w ** 2) / sigma
    denorm = 1.0 / (sigma * math.sqrt(2 * math.pi))
    out = denorm * np.exp(-0.5 * r ** 2)
    # exp(-100) at the corners underflows to subnormals that devices flush to
    # zero -> 0/0 at pixels covered by a single patch corner. Floor the weight
    # (relative blend behavior unchanged).
    return np.maximum(out, 1e-12 * out.max()).astype(np.float32)


def tiled_forward(fwd, images: torch.Tensor,
                  patch_size: Sequence[int] = TRAIN_SIZE,
                  min_overlap: int = 20, sigma: float = 0.05) -> torch.Tensor:
    """Run ``fwd`` ((B, T, ph, pw, 3) -> (B, F, ph, pw, 2)) over overlapping
    tiles of (B, T, H, W, 3) and blend with Gaussian weights.

    Returns (B, F, H, W, 2) f32 on the images' device.
    """
    b, t, hh, ww, _ = images.shape
    ph, pw = patch_size
    assert hh >= ph and ww >= pw, "image smaller than the tile"
    hws = compute_grid_indices((hh, ww), patch_size, min_overlap)
    wpatch = torch.from_numpy(gaussian_patch_weight(patch_size, sigma)).to(
        images.device)

    flow_sum = None
    weight_sum = torch.zeros((hh, ww), dtype=torch.float32,
                             device=images.device)
    for (h, w) in hws:
        # a corner past the last one (the grid can list one, e.g. (0, 44)
        # for a 96-wide image in 64-wide tiles) is clamped to the last
        # position, as JAX's dynamic_slice and dynamic_update_slice do
        h, w = min(h, hh - ph), min(w, ww - pw)
        flows = fwd(images[:, :, h:h + ph, w:w + pw].contiguous())
        if flow_sum is None:
            flow_sum = torch.zeros((b, flows.shape[1], hh, ww, 2),
                                   dtype=torch.float32, device=images.device)
        flow_sum[:, :, h:h + ph, w:w + pw] += flows * wpatch[..., None]
        weight_sum[h:h + ph, w:w + pw] += wpatch
    return flow_sum / weight_sum[..., None]
