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



def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal`` in place: a normal of variance 1 / fan_in
    truncated at two standard deviations (the spread of the untruncated
    draw restored, as ``variance_scaling`` does)."""
    std = fan_in ** -0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without affine parameters on NHWC (JAX
    ``layers/common.py::InstanceNorm``): each (H, W) plane of each image
    and channel normalised, the statistics in f32, the result in x's
    dtype."""
    xf = x.float()
    mean = xf.mean((1, 2), keepdim=True)
    var = (xf - mean).square().mean((1, 2), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _flax_stats(xf: torch.Tensor, dims):
    """flax's ``_compute_stats``: f32 mean and E[x^2] - mean^2, clipped at
    zero (the biased variance)."""
    mean = xf.mean(dims)
    return mean, (xf.square().mean(dims) - mean.square()).clamp(min=0.0)


class _F32Norm(nn.Module):
    """A norm whose parameters and buffers stay f32 when the model is cast
    to another dtype (an inference model in bf16): flax's BatchNorm and
    GroupNorm keep scale, bias and the running statistics in f32 and
    normalise in f32 under a bf16 ``dtype``."""

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for p in self._parameters.values():
            if p is not None and p.dtype != torch.float32:
                p.data = p.data.float()
        for name, b in self._buffers.items():
            if b is not None and b.dtype != torch.float32:
                self._buffers[name] = b.float()
        return self


class GroupNorm(_F32Norm):
    """flax ``nn.GroupNorm`` on NHWC: ``groups`` contiguous channel groups,
    statistics over (H, W, group) in f32, epsilon 1e-6 (flax's default),
    scale and bias per channel, the result in x's dtype."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, h, w, c = x.shape
        xf = x.float().reshape(b, h, w, self.groups, c // self.groups)
        mean, var = _flax_stats(xf, (1, 2, 4))
        mean, var = mean[:, None, None, :, None], var[:, None, None, :, None]
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(b, h, w, c)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class BatchNorm(_F32Norm):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NHWC, with its
    running statistics as buffers (``running_mean``, ``running_var``: the
    reference's torch keys, JAX's ``batch_stats`` mean and var).

    ``forward(x, train)``: with ``train`` the batch statistics over (N, H,
    W), in f32 whatever x's dtype, normalise x, and the running
    statistics move one step towards them, ra = 0.9 ra + 0.1 s, with the
    BIASED batch variance E[x^2] - E[x]^2 (flax; ``nn.BatchNorm2d`` would
    take the unbiased one). Without it, the running statistics normalise
    x. ``nn.Module.train()`` changes neither: only the argument does, as
    JAX's ``use_running_average=not train``."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            mean, var = _flax_stats(xf, tuple(range(x.ndim - 1)))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)
