"""Flow -> RGB visualization with the Middlebury color wheel (reference
core/utils/flow_viz.py:21-133; Baker et al. ICCV'07 color coding).

Fully vectorized NumPy; returns uint8 (H, W, 3). The port's own copy of
streamflow_tpu/data/flow_viz.py.
"""

from __future__ import annotations

import numpy as np


def _color_wheel() -> np.ndarray:
    """55-entry RGB color wheel spanning the 6 hue sectors RY/YG/GC/CB/BM/MR."""
    sectors = [("RY", 15), ("YG", 6), ("GC", 4), ("CB", 11), ("BM", 13), ("MR", 6)]
    total = sum(n for _, n in sectors)
    wheel = np.zeros((total, 3))
    col = 0
    for name, n in sectors:
        ramp = np.arange(n) / n
        if name == "RY":
            wheel[col : col + n, 0] = 255
            wheel[col : col + n, 1] = np.floor(255 * ramp)
        elif name == "YG":
            wheel[col : col + n, 0] = 255 - np.floor(255 * ramp)
            wheel[col : col + n, 1] = 255
        elif name == "GC":
            wheel[col : col + n, 1] = 255
            wheel[col : col + n, 2] = np.floor(255 * ramp)
        elif name == "CB":
            wheel[col : col + n, 1] = 255 - np.floor(255 * ramp)
            wheel[col : col + n, 2] = 255
        elif name == "BM":
            wheel[col : col + n, 2] = 255
            wheel[col : col + n, 0] = np.floor(255 * ramp)
        else:  # MR
            wheel[col : col + n, 2] = 255 - np.floor(255 * ramp)
            wheel[col : col + n, 0] = 255
        col += n
    return wheel


_WHEEL = _color_wheel()


def _uv_to_colors(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]

    col = (1 - f) * _WHEEL[k0] / 255.0 + f * _WHEEL[k1] / 255.0
    inside = rad[..., None] <= 1
    # saturate toward white for small motion, darken out-of-range
    col = np.where(inside, 1 - rad[..., None] * (1 - col), col * 0.75)
    return np.floor(255 * col).astype(np.uint8)


def flow_to_image(flow: np.ndarray, clip_flow: float | None = None,
                  rad_max: float | None = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8. Normalizes by the max magnitude
    (or ``rad_max`` if given, for consistent scaling across a video)."""
    flow = np.asarray(flow, np.float32)
    assert flow.ndim == 3 and flow.shape[2] == 2
    if clip_flow is not None:
        flow = np.clip(flow, 0, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    rmax = rad_max if rad_max is not None else max(rad.max(), 1e-5)
    eps = np.finfo(np.float32).eps
    return _uv_to_colors(u / (rmax + eps), v / (rmax + eps))
