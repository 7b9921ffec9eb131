"""Forward interpolation of a flow field for warm-starting the next clip
(reference core/utils/utils.py:34-62). Host-side by design: scatter +
nearest-neighbor fill is data-dependent and tiny (run once per clip window),
so it stays in NumPy/SciPy exactly like the reference's CPU round trip.
The port's own copy of streamflow_tpu/ops/warp.py.
"""

from __future__ import annotations

import numpy as np


def forward_interpolate(flow) -> np.ndarray:
    """flow: (H, W, 2) array-like (x, y channels) -> forward-warped (H, W, 2)
    float32 NumPy array, nearest-filled, zeros where nothing lands."""
    from scipy import interpolate as _interp

    flow = np.asarray(flow, dtype=np.float32)
    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))

    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)

    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dxf, dyf = x1[valid], y1[valid], dxf[valid], dyf[valid]

    if x1.size == 0:
        return np.zeros((ht, wd, 2), dtype=np.float32)

    flow_x = _interp.griddata((x1, y1), dxf, (x0, y0), method="nearest", fill_value=0)
    flow_y = _interp.griddata((x1, y1), dyf, (x0, y0), method="nearest", fill_value=0)
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)


def per_pair_warm_start(lowres) -> np.ndarray:
    """Next-window flow_init from this window's low-res flows, PER PAIR:
    pair i of the next window is initialized from the forward-interpolated
    low-res flow of pair i of this window — the reference's
    `flow_prev = [forward_interpolate(flows_lowres[i][0]) ...]`
    (evaluate_mf.py:304-305).

    lowres: (T-1, h, w, 2) -> (1, T-1, h, w, 2) float32 (batch dim added).
    """
    lowres = np.asarray(lowres)
    return np.stack([forward_interpolate(lowres[p])
                     for p in range(lowres.shape[0])])[None]
