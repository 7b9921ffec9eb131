"""Shared building blocks (port of streamflow_tpu/layers/common.py).

Tensors are channel-last (NHWC / (B, N, C)) as in the JAX package;
parameters keep torch's layouts and the reference's names, so 1x1 convs
run as ``F.linear`` on the channel axis and kxk convs through a
channels-last view. GELU is exact (erf) everywhere.

Parameters are cast to the activation's (compute) dtype where they are
used (``cast``), as the JAX package's ``dtype=bf16, param_dtype=f32``
modules do: a training model holds f32 parameters and, since each of the
refinement iterations casts anew, their gradients sum across iterations in
f32; an inference model holds its parameters in the compute dtype, where
the cast is a no-op.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def cast(p, x: torch.Tensor):
    """Parameter ``p`` (or None) in the dtype of the activation ``x``."""
    return None if p is None else p.to(x.dtype)


def linear(x: torch.Tensor, mod: nn.Linear) -> torch.Tensor:
    return F.linear(x, cast(mod.weight, x), cast(mod.bias, x))


def layer_norm(x: torch.Tensor, mod: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, mod.normalized_shape, cast(mod.weight, x),
                        cast(mod.bias, x), mod.eps)


def pointwise(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 Conv2d applied to (..., C_in) as a matmul."""
    w = conv.weight
    return F.linear(x, cast(w.reshape(w.shape[0], w.shape[1]), x),
                    cast(conv.bias, x))


def conv2d(x: torch.Tensor, conv: nn.Conv2d, bias: bool = True
           ) -> torch.Tensor:
    """A Conv2d applied to NHWC (B, H, W, C) through a channels-last view;
    returns contiguous NHWC. ``bias=False`` leaves the module's bias out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), cast(conv.weight, x),
                 cast(conv.bias, x) if bias else None, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


class Mlp(nn.Module):
    """Transformer MLP fc1 -> gelu -> fc2 (timm Mlp), the plain form of the
    K2 ``ln_ffn_pair`` kernel's pair."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return linear(gelu(linear(x, self.fc1)), self.fc2)

