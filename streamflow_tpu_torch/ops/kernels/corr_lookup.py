"""K1, the correlation lookup (CUDA source ``csrc/corr_lookup.cu``).

Replaces the Pallas kernel
``streamflow_tpu/ops/pallas/_fused_lookup_kernel.py::fused_corr_lookup_prepared``.
For each query pixel and pyramid level l: the 9x9 bilinear window of
f1 . f2_l^T / sqrt(C) around coords / 2^l, zeros out of range, written
x-major (channel = l*81 + ix*9 + iy). The (N, N) volume is never stored.

On the H100 the kernel is bound by L2 reads of the tapped f2 features; one
warp per query keeps f1 in registers and reads each tap row once (see the
source's header). Its plain version materialises each level's volume and
looks it up like ``CorrPyramid``.

Gradients to f1 and the pooled levels, as the JAX package's custom_vjp of
the Pallas lookup (ops/pallas/corr.py:91-101, whose backward recomputes
through the XLA composite ``_xla_equiv_prepared``): the forward is the
kernel, the backward is autograd of the plain version recomputed from the
saved inputs (``ops.kernels.CompositeVJP``). That backward is ordinary
PyTorch in both packages, not a plain version standing in for a kernel.
"""

from __future__ import annotations

import math

import torch

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.corr import lookup_level, pool_pyramid
from streamflow_tpu_torch.ops.kernels import LAUNCHES, with_composite_vjp

MAX_LEVELS = 4


def corr_lookup_plain(f1, f2_levels, coords, radius: int = 4):
    """Plain PyTorch version: f32 volume per level from the (pooled) f2
    features, then the gather-based window lookup, cast to f1's dtype."""
    b, h, w, c = f1.shape
    n = h * w
    f1f = f1.reshape(b, n, c).float()
    pts = coords.reshape(b, n, 2).float()
    outs = []
    for lvl, f2 in enumerate(f2_levels):
        hl, wl = f2.shape[1], f2.shape[2]
        vol = torch.bmm(f1f, f2.reshape(b, hl * wl, c).float().transpose(1, 2))
        vol = vol * (1.0 / math.sqrt(c))
        outs.append(lookup_level(vol.reshape(b, n, hl, wl), pts, lvl, radius))
    out = torch.cat(outs, dim=-1).to(f1.dtype)
    return out.reshape(b, h, w, -1)


def corr_lookup(f1, f2_levels, coords, radius: int = 4):
    """f1 (B, H, W, C); f2_levels: pooled f2, each (B, Hl, Wl, C) in f1's
    dtype; coords (B, H, W, 2) f32 level-0 pixel (x, y). Returns
    (B, H, W, L*(2r+1)^2) in f1's dtype, accumulated in f32.
    Differentiable (see the module's docstring)."""
    return with_composite_vjp(
        lambda a, c, *lv: _corr_lookup(a, lv, c, radius),
        lambda a, c, *lv: corr_lookup_plain(a, lv, c, radius),
        f1, coords, *f2_levels)


def _corr_lookup(f1, f2_levels, coords, radius: int):
    if not f1.is_cuda:
        return corr_lookup_plain(f1, f2_levels, coords, radius)
    b, h, w, c = f1.shape
    _build.require(f1, "f1", ndim=4)
    _build.require(coords, "coords", torch.float32, 4)
    if coords.shape != (b, h, w, 2):
        raise ValueError(f"coords {tuple(coords.shape)} != {(b, h, w, 2)}")
    if c % 32 or c > 512:
        raise ValueError(f"corr_lookup takes C a multiple of 32 up to 512, "
                         f"got {c}")
    if not 1 <= len(f2_levels) <= MAX_LEVELS or not 0 <= radius <= 4:
        raise ValueError("corr_lookup takes 1..4 levels and radius <= 4")
    dims = []
    for i, f2 in enumerate(f2_levels):
        _build.require(f2, f"f2_levels[{i}]", f1.dtype, 4)
        if f2.shape[0] != b or f2.shape[3] != c or f2.device != f1.device:
            raise ValueError(f"f2_levels[{i}] {tuple(f2.shape)} does not "
                             f"match f1 {tuple(f1.shape)}")
        dims += [f2.shape[1], f2.shape[2]]
    nl = len(f2_levels)
    ptrs = [f2.data_ptr() for f2 in f2_levels] + [None] * (MAX_LEVELS - nl)
    dims += [0, 0] * (MAX_LEVELS - nl)
    k = 2 * radius + 1
    out = torch.empty(b, h, w, nl * k * k, dtype=f1.dtype, device=f1.device)
    lib = _build.library()
    code = lib.sf_corr_lookup(
        f1.data_ptr(), *ptrs, coords.data_ptr(), out.data_ptr(), b, h * w, c,
        nl, *dims, radius, _build.dtype_code(f1.dtype), 1.0 / math.sqrt(c),
        _build.stream_of(f1))
    _build.check(code, "corr_lookup")
    LAUNCHES["corr_lookup"] += 1
    return out


class FusedCorr:
    """f1 and the pooled f2 pyramid, stored once per forward; each lookup is
    one K1 call (counterpart of streamflow_tpu/ops/pallas/corr.py::PallasCorr,
    without its TPU padding)."""

    def __init__(self, fmap1, fmap2, num_levels: int = 4, radius: int = 4):
        self.f1 = fmap1.contiguous()
        self.levels = [lv.contiguous()
                       for lv in pool_pyramid(fmap2, num_levels)]
        self.radius = radius

    def lookup(self, coords):
        return corr_lookup(self.f1, self.levels, coords.contiguous(),
                           self.radius)
