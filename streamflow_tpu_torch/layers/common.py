"""Shared building blocks (port of streamflow_tpu/layers/common.py).

Tensors are channel-last (NHWC / (B, N, C)) as in the JAX package;
parameters keep torch's layouts and the reference's names, so 1x1 convs
run as ``F.linear`` on the channel axis and kxk convs through a
channels-last view. GELU is exact (erf) everywhere.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def pointwise(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 Conv2d applied to (..., C_in) as a matmul."""
    w = conv.weight
    return F.linear(x, w.reshape(w.shape[0], w.shape[1]), conv.bias)


def conv2d(x: torch.Tensor, conv: nn.Conv2d, bias: bool = True
           ) -> torch.Tensor:
    """A Conv2d applied to NHWC (B, H, W, C) through a channels-last view;
    returns contiguous NHWC. ``bias=False`` leaves the module's bias out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight,
                 conv.bias if bias else None, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


class Mlp(nn.Module):
    """Transformer MLP fc1 -> gelu -> fc2 (timm Mlp), the plain form of the
    K2 ``ln_ffn_pair`` kernel's pair."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))

