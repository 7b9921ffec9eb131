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
    returns contiguous NHWC. ``bias=False`` leaves the module's bias out.
    No rows (an empty slab of the sequence-sharded forward): no rows out,
    and no call."""
    if not x.shape[1]:
        (_, k), (_, s), (_, p), (_, d) = (conv.kernel_size, conv.stride,
                                          conv.padding, conv.dilation)
        wo = (x.shape[2] + 2 * p - d * (k - 1) - 1) // s + 1
        return x.new_empty(x.shape[0], 0, wo, conv.out_channels)
    y = F.conv2d(x.permute(0, 3, 1, 2), cast(conv.weight, x),
                 cast(conv.bias, x) if bias else None, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_rows(x: torch.Tensor, conv: nn.Conv2d, rows=None
                ) -> torch.Tensor:
    """``conv2d`` of any stride; with ``rows`` (``parallel.exchange.Rows``:
    x is one slab of the grid's rows, in the sequence-sharded forward) on
    this rank's slab, returning its rows of the output (``rows.coarse``
    of the stride; every slab starts at a multiple of the stride). The
    slab is extended by the conv's H padding in rows from the ranks that
    hold them, and by zero rows only where the grid itself ends, then
    convolved without H padding: each output row reads the input rows of
    the zero-padded whole grid that it reads on one rank. A 1x1 conv
    exchanges nothing; an empty slab joins the exchange and returns no
    rows."""
    if rows is None or rows.alone:
        return conv2d(x, conv)
    p, pw = conv.padding
    ext, top = rows.halo(x, p)
    if not rows.size:
        return conv2d(x, conv)
    bottom = ext.shape[1] - top - x.shape[1]
    ext = F.pad(ext, (0, 0, 0, 0, p - top, p - bottom))
    y = F.conv2d(ext.permute(0, 3, 1, 2), cast(conv.weight, x),
                 cast(conv.bias, x), conv.stride, (0, pw), conv.dilation,
                 conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


def on_slab(fn, x: torch.Tensor, k: int, rows=None) -> torch.Tensor:
    """``fn(x)``, a layer that reaches ``k`` rows along x's dim 1; with
    ``rows`` (``parallel.exchange.Rows``: x is one slab of the grid's
    rows, in the sequence-sharded forward) run on the slab extended by
    the neighbours' ``k`` rows and cropped back to it."""
    return fn(x) if rows is None else rows.local(fn, x, k)


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


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  rows=None) -> torch.Tensor:
    """InstanceNorm2d without affine parameters on NHWC (JAX
    ``layers/common.py::InstanceNorm``): each (H, W) plane of each image
    and channel normalised, the statistics in f32 (the mean, then the
    mean of the squared deviations), the result in x's dtype. With
    ``rows`` (x is one slab of the plane's rows, in the sequence-sharded
    forward) the same two passes over the whole plane: each a sum over
    the slab, summed over the seq group (``Rows.sum``; an empty slab adds
    zeros), over the whole plane's count."""
    xf = x.float()
    if rows is None or rows.alone:
        mean = xf.mean((1, 2), keepdim=True)
        var = (xf - mean).square().mean((1, 2), keepdim=True)
    else:
        n = rows.total * x.shape[2]
        mean = rows.sum(xf.sum((1, 2), keepdim=True)) / n
        var = rows.sum((xf - mean).square().sum((1, 2), keepdim=True)) / n
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


class _AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over a process group, on every rank; its
    gradient is the sum of the ranks' output gradients (each rank's
    input reaches every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


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
    JAX's ``use_running_average=not train``.

    ``group`` (a ``torch.distributed`` process group, set by
    ``sync_batchnorm``; None: this process alone): the batch statistics
    are those of the group's global batch, as a BatchNorm under JAX's
    data-sharded step takes them. Each rank's f32 E[x] and E[x^2] are
    averaged over the group by one differentiable all-reduce, then the
    biased variance and the running statistics are taken from the global
    values. Every rank must hold as many rows (N H W) as the others; a
    group of one gives the unsynced statistics bit for bit."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.group = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _group_stats(self, xf: torch.Tensor, dims):
        """``_flax_stats`` over the group's global batch."""
        import torch.distributed as dist

        world = dist.get_world_size(self.group)
        c = xf.shape[-1]
        rows = xf.numel() // c
        local = torch.cat([xf.mean(dims), xf.square().mean(dims),
                           xf.new_full((1,), float(rows))])
        total = _AllReduceSum.apply(local, self.group)
        torch._assert_async(total[-1] == rows * world,
                            "BatchNorm: the ranks hold different numbers "
                            "of rows")
        mean = total[:c] / world
        return mean, (total[c:2 * c] / world - mean.square()).clamp(min=0.0)

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            mean, var = (_flax_stats(xf, dims) if self.group is None
                         else self._group_stats(xf, dims))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


def sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Set ``group`` on every BatchNorm of ``model`` (None: each process
    alone again) and return the model."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return model
