"""Plain operations of the reference models, in float32 NHWC.

Every product (a linear layer, a convolution, an attention product) takes
its two inputs through ``Prec.q``: the identity for the float32 reference,
for the control (the step below the bfloat16 that the configurations
state) a per-tensor scaled round trip through float8, e4m3 forward and
e5m2 for the gradients that come back through it. Everything
else (norms, softmax, gelu, the correlation volume, coordinates and the
upsampling) stays float32 in both, as the configurations keep the
correlation, softmax and coordinates in float32.

No operation here is taken from the program: the correlation lookup uses
``grid_sample`` over the materialised volume (RAFT's own formulation), the
upsampler ``unfold``, attention a chunked softmax.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# float8 formats with their largest finite values: e4m3 for what a product
# reads forward, e5m2 for the gradients that reach it (the usual fp8
# training recipe)
E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def fp8_round(t: torch.Tensor, fmt) -> torch.Tensor:
    """t rounded to a float8 format under one per-tensor scale (its
    largest magnitude to the format's largest finite value)."""
    dtype, top = fmt
    s = top / t.detach().abs().amax().float().clamp(min=1e-30)
    return (t * s).to(dtype).float() / s


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return fp8_round(t, E4M3)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, E5M2)


class Prec:
    """The precision of the products: ``"f32"`` or ``"fp8"`` (e4m3 inputs
    forward, e5m2 gradients backward)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "f32" else _FP8.apply(t)


def gelu(x):
    return F.gelu(x)


def lin(pr: Prec, x, w, b=None):
    """x (..., in) times w (out, in) or a 1x1 conv kernel (out, in, 1, 1)."""
    w = w.reshape(w.shape[0], w.shape[1])
    return F.linear(pr.q(x), pr.q(w), b)


def conv(pr: Prec, x, w, b=None, stride=1, padding=0, groups=1):
    """NHWC convolution with a torch (out, in/groups, kh, kw) kernel."""
    y = F.conv2d(pr.q(x).permute(0, 3, 1, 2), pr.q(w), b, stride, padding,
                 1, groups)
    return y.permute(0, 2, 3, 1)


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def attention(pr: Prec, q, k, v, chunk: int = 8192):
    """softmax(q k^T) v over the last two dims, q already scaled; queries
    in chunks so that the (N, M) map never exists whole."""
    outs = []
    for s in range(0, q.shape[-2], chunk):
        a = pr.q(q[..., s:s + chunk, :]) @ pr.q(k).transpose(-1, -2)
        outs.append(pr.q(torch.softmax(a, dim=-1)) @ pr.q(v))
    return torch.cat(outs, dim=-2)


def avg_pool2(x):
    """2x2 average pool of NHWC, odd rows and columns dropped."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def corr_lookup(f1, levels, coords, radius: int, chunk: int = 2048):
    """The (2r+1)^2 bilinear window of each level of the all-pairs volume
    f1 . level / sqrt(C) around coords / 2^l, zeros outside, channel =
    l (2r+1)^2 + ix (2r+1) + iy. f1 (B, H, W, C), levels [(B, Hl, Wl, C)],
    coords (B, H, W, 2) (x, y) -> (B, H, W, L (2r+1)^2)."""
    b, h, w, c = f1.shape
    n = h * w
    k = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, device=f1.device,
                     dtype=torch.float32)
    # the window's (x, y) offsets, x-major: tap ix*k + iy
    off = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
    off = off.reshape(1, k * k, 2)
    pts = coords.reshape(b, n, 2).float()
    f1f = f1.reshape(b, n, c).float()
    out = []
    for lvl, f2 in enumerate(levels):
        hl, wl = f2.shape[1], f2.shape[2]
        f2f = f2.reshape(b, hl * wl, c).float()
        cols = []
        for s in range(0, n, chunk):
            vol = torch.bmm(f1f[:, s:s + chunk], f2f.transpose(1, 2))
            vol = vol / math.sqrt(c)
            m = vol.shape[1]
            # a border of zeros, so that no side of the sampled plane is
            # one pixel long (align_corners maps such a side to its pixel)
            vol = F.pad(vol.reshape(b * m, 1, hl, wl), (1, 1, 1, 1))
            xy = pts[:, s:s + chunk, None, :] / 2 ** lvl + off[None] + 1
            gx = 2 * xy[..., 0] / (wl + 1) - 1
            gy = 2 * xy[..., 1] / (hl + 1) - 1
            grid = torch.stack([gx, gy], -1).reshape(b * m, 1, k * k, 2)
            taps = F.grid_sample(vol, grid,
                                 mode="bilinear", padding_mode="zeros",
                                 align_corners=True)
            cols.append(taps.reshape(b, m, k * k))
        out.append(torch.cat(cols, dim=1))
    return torch.cat(out, dim=-1).reshape(b, h, w, -1)


def convex_upsample(flow, mask, ratio: int = 8):
    """RAFT's convex upsampling: flow (N, h, w, 2), mask (N, h, w, 9 r^2),
    channel k r^2 + i r + j -> (N, r h, r w, 2)."""
    n, h, w, _ = flow.shape
    r = ratio
    m = torch.softmax(mask.permute(0, 3, 1, 2).reshape(n, 1, 9, r, r, h, w),
                      dim=2)
    up = F.unfold(r * flow.permute(0, 3, 1, 2), [3, 3], padding=1)
    up = up.reshape(n, 2, 9, 1, 1, h, w)
    up = (m * up).sum(dim=2)                        # (N, 2, r, r, h, w)
    up = up.permute(0, 4, 2, 5, 3, 1)               # (N, h, r, w, r, 2)
    return up.reshape(n, r * h, r * w, 2)


def coords_grid(n, h, w, device):
    """(n, h, w, 2) pixel coordinates, (x, y)."""
    f32 = torch.float32
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=f32),
                            torch.arange(w, device=device, dtype=f32),
                            indexing="ij")
    return torch.stack([xs, ys], -1)[None].expand(n, h, w, 2)


def instance_norm(x, eps=1e-5):
    mean = x.mean((1, 2), keepdim=True)
    var = (x - mean).square().mean((1, 2), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def batch_norm_eval(x, w, b, mean, var, eps=1e-5):
    return (x - mean) / torch.sqrt(var + eps) * w + b
