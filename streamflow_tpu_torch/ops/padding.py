"""Input padding (port of streamflow_tpu/ops/padding.py::InputPadder, its
'sintel' mode).

Pads (..., H, W, C) images so that H and W are divisible by ``factor``, by
edge replication, split evenly between the two sides; ``unpad`` slices the
same region back out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    def __init__(self, dims, mode: str = "sintel", factor: int = 8):
        self.ht, self.wd = int(dims[-3]), int(dims[-2])
        f = factor
        pad_ht = (((self.ht // f) + 1) * f - self.ht) % f
        pad_wd = (((self.wd // f) + 1) * f - self.wd) % f
        if mode != "sintel":
            raise NotImplementedError(f"the port pads in 'sintel' mode "
                                      f"only, got {mode!r}")
        self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2,
                     pad_ht - pad_ht // 2)

    @property
    def padded_shape(self):
        l, r, t, b = self._pad
        return (self.ht + t + b, self.wd + l + r)

    def pad(self, *inputs):
        out = [self._pad_one(x) for x in inputs]
        return out if len(out) > 1 else out[0]

    def _pad_one(self, x: torch.Tensor) -> torch.Tensor:
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        y = F.pad(nchw, self._pad, mode="replicate").permute(0, 2, 3, 1)
        return y.reshape(*lead, *y.shape[1:])

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        h, w = x.shape[-3], x.shape[-2]
        return x[..., t:h - b, l:w - r, :]
