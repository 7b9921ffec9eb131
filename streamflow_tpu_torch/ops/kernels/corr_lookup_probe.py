"""K1's work-split modes (CUDA source ``csrc/corr_lookup.cu``,
``sf_corr_lookup_probe``), for ``tools/probe_lookup.py``.

Replaces the Pallas kernel of ``tools/probe_lookup.py`` (``build`` ->
``pl.pallas_call``, body ``variant_kernel``): K1's bf16 body with parts
of its work dropped, so that its time can be split between the products,
the tap extraction and the box width. Each mode is a compile-time variant
of the production tile kernel (``full`` is its production instance):

- ``full``: the production kernel, bit for bit;
- ``nofori``: the box is the whole level, with no data-dependent bounds
  (JAX's static loop over every row); equals ``full`` within f32 rounding;
- ``l0_only`` / ``l123_only``: ``full``'s values on the kept levels, zeros
  elsewhere, exactly;
- ``mm_only``: the planes, without tap copies or weights: per query and
  level, the sum of every plane value computed for that query (the f1 .
  f2 products over its 8x8 tile's box, unscaled) in the level's first
  channel, zeros in the other 80, so that the products stay live;
- ``ex_only``: the tap copies and bilinear weights, read from a constant
  plane of 1 (0 past the level's last column, as TMA fills), with no wgmma
  and no TMA: the lookup of a constant volume 1/sqrt(C).

JAX's ``mm_only`` and ``ex_only`` outputs are side effects of its 128-lane
layout; the port's two are defined by their plain versions here instead.
The kernel takes bf16 only (K1's tensor-core body); ``LAUNCHES
["corr_lookup_probe"]`` counts its launches, none of the model's.
"""

from __future__ import annotations

import math

import torch

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.corr import lookup_level
from streamflow_tpu_torch.ops.kernels import LAUNCHES
from streamflow_tpu_torch.ops.kernels.corr_lookup import (MAX_LEVELS,
                                                          corr_lookup_plain)

MODES = ("full", "nofori", "l0_only", "l123_only", "mm_only", "ex_only")
TQ = 8   # the kernel's query tile is TQ x TQ


def _windows(coords, level: int, hl: int, wl: int, r: int):
    """Each query's window origin (iy, ix) at a level and whether the
    window meets it, as the kernel computes them (f32)."""
    inv = 1.0 / float(1 << level)
    cy = (coords[..., 1].float() * inv).clamp(-(r + 3.0), hl + r + 3.0)
    cx = (coords[..., 0].float() * inv).clamp(-(r + 3.0), wl + r + 3.0)
    iy = torch.floor(cy).long() - r
    ix = torch.floor(cx).long() - r
    kt = 2 * r + 2
    meets = (iy + kt > 0) & (iy < hl) & (ix + kt > 0) & (ix < wl)
    return iy, ix, meets


def _tile_reduce(v, fill, op, th: int, tw: int):
    """(B, H, W) -> (B, th, tw): op ("amin"/"amax") over each 8x8 tile,
    positions past H and W filled with ``fill``."""
    b, h, w = v.shape
    v = torch.nn.functional.pad(v, (0, tw * TQ - w, 0, th * TQ - h),
                                value=fill)
    v = v.reshape(b, th, TQ, tw, TQ)
    return getattr(v, op)(dim=(2, 4))


def _mm_only_plain(f1, f2_levels, coords, r: int):
    """The sum over each query's tile box of f1 . f2 (f64 box sums of f2
    from prefix sums), in each level's first channel."""
    b, h, w, c = f1.shape
    k, kt = 2 * r + 1, 2 * r + 2
    th, tw = -(-h // TQ), -(-w // TQ)
    big = 1 << 30
    out = torch.zeros(b, h, w, len(f2_levels) * k * k, dtype=torch.float64,
                      device=f1.device)
    bidx = torch.arange(b, device=f1.device)[:, None, None]
    for lvl, f2 in enumerate(f2_levels):
        hl, wl = f2.shape[1], f2.shape[2]
        iy, ix, meets = _windows(coords, lvl, hl, wl, r)
        hlo = _tile_reduce(torch.where(meets, iy.clamp(min=0), big), big,
                           "amin", th, tw)
        hhi = _tile_reduce(torch.where(meets, (iy + kt - 1).clamp(
            max=hl - 1), -big), -big, "amax", th, tw)
        xlo = _tile_reduce(torch.where(meets, ix.clamp(min=0), big), big,
                           "amin", th, tw)
        xhi = _tile_reduce(torch.where(meets, (ix + kt - 1).clamp(
            max=wl - 1), -big), -big, "amax", th, tw)
        active = hlo <= hhi
        # the columns the kernel's planes cover: 128, 64 or 32 at a time,
        # the narrowest that covers the rest of the box row
        xe = xlo.clone()
        while True:
            more = active & (xe <= xhi)
            if not bool(more.any()):
                break
            rest = xhi - xe + 1
            nc = torch.where(rest > 64, 128, torch.where(rest > 32, 64, 32))
            xe = torch.where(more, xe + nc, xe)
        xe = xe.clamp(max=wl)
        pre = torch.zeros(b, hl + 1, wl + 1, c, dtype=torch.float64,
                          device=f1.device)
        pre[:, 1:, 1:] = f2.double().cumsum(1).cumsum(2)
        y0 = torch.where(active, hlo, 0)
        y1 = torch.where(active, hhi + 1, 0)
        x0 = torch.where(active, xlo, 0)
        x1 = torch.where(active, xe, 0)
        box = (pre[bidx, y1, x1] - pre[bidx, y0, x1] - pre[bidx, y1, x0]
               + pre[bidx, y0, x0])                          # (B, th, tw, C)
        box = box.repeat_interleave(TQ, 1).repeat_interleave(TQ, 2)
        out[..., lvl * k * k] = (f1.double() * box[:, :h, :w]).sum(-1)
    return out.to(f1.dtype)


def _ex_only_plain(f1, f2_levels, coords, r: int):
    """The window lookup of a constant volume 1/sqrt(C) at every level."""
    b, h, w, c = f1.shape
    pts = coords.reshape(b, h * w, 2).float()
    outs = []
    for lvl, f2 in enumerate(f2_levels):
        hl, wl = f2.shape[1], f2.shape[2]
        vol = torch.full((1, 1, 1, 1), 1.0 / math.sqrt(c),
                         device=f1.device).expand(b, h * w, hl, wl)
        outs.append(lookup_level(vol, pts, lvl, r))
    return torch.cat(outs, -1).to(f1.dtype).reshape(b, h, w, -1)


def corr_lookup_probe_plain(f1, f2_levels, coords, mode: str,
                            radius: int = 4):
    """Plain PyTorch version of each mode (see the module's docstring)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "mm_only":
        return _mm_only_plain(f1, f2_levels, coords, radius)
    if mode == "ex_only":
        return _ex_only_plain(f1, f2_levels, coords, radius)
    out = corr_lookup_plain(f1, f2_levels, coords, radius)
    kk = (2 * radius + 1) ** 2
    if mode == "l0_only":
        out[..., kk:] = 0
    elif mode == "l123_only":
        out[..., :kk] = 0
    return out


def corr_lookup_probe(f1, f2_levels, coords, mode: str, radius: int = 4):
    """K1 in a work-split mode: f1 (B, H, W, C) bf16, f2_levels pooled f2
    (level 0 H x W), coords (B, H, W, 2) f32; (B, H, W, L*(2r+1)^2). The
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not f1.is_cuda:
        return corr_lookup_probe_plain(f1, f2_levels, coords, mode, radius)
    b, h, w, c = f1.shape
    _build.require(f1, "f1", torch.bfloat16, 4)
    _build.require(coords, "coords", torch.float32, 4)
    if coords.shape != (b, h, w, 2):
        raise ValueError(f"coords {tuple(coords.shape)} != {(b, h, w, 2)}")
    if c % 32 or c > 768 or not 1 <= len(f2_levels) <= MAX_LEVELS:
        raise ValueError("corr_lookup_probe takes C a multiple of 32 up to "
                         "768 and 1..4 levels")
    if not 0 <= radius <= 4:
        raise ValueError("corr_lookup_probe takes radius <= 4")
    dims = []
    for i, f2 in enumerate(f2_levels):
        _build.require(f2, f"f2_levels[{i}]", torch.bfloat16, 4)
        if f2.shape[0] != b or f2.shape[3] != c:
            raise ValueError(f"f2_levels[{i}] {tuple(f2.shape)} does not "
                             f"match f1 {tuple(f1.shape)}")
        dims += [f2.shape[1], f2.shape[2]]
    if tuple(f2_levels[0].shape[1:3]) != (h, w):
        raise ValueError("level 0 must be f1's H x W (the query raster)")
    nl = len(f2_levels)
    ptrs = [f2.data_ptr() for f2 in f2_levels] + [None] * (MAX_LEVELS - nl)
    dims += [0, 0] * (MAX_LEVELS - nl)
    out = torch.empty(b, h, w, nl * (2 * radius + 1) ** 2, dtype=f1.dtype,
                      device=f1.device)
    code = _build.library().sf_corr_lookup_probe(
        f1.data_ptr(), *ptrs, coords.data_ptr(), out.data_ptr(), b, h * w, c,
        nl, *dims, radius, MODES.index(mode), 1.0 / math.sqrt(c),
        _build.stream_of(f1))
    _build.check(code, "corr_lookup_probe")
    LAUNCHES["corr_lookup_probe"] += 1
    return out
