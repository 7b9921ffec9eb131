"""K6-K8, the banded depthwise convs (CUDA sources ``csrc/dw_banded.cu``
and ``csrc/dw_banded_t.cu``), and the ``'banded'`` layout's composite.

Replace the Pallas kernels of ``streamflow_tpu/ops/pallas/
_banded_dw_kernel.py``, which run the SK block's depthwise k x k conv as a
per-channel banded matmul:

- K6 ``dw_banded_mxu`` (``_dw_banded_mxu_fwd``, pallas_call :122) and K7
  ``dw_banded_mxu_t`` (``_dw_banded_mxu_t_fwd``, :223): the kxk conv +
  bias, NHWC in and out, the transposes and the zero halo inside the
  kernel, any C (the TPU kernel's C % 128 == 0 is a lane rule of the TPU).
  JAX pads x and transposes it to a C-major operand (C, B*Wp, Hp) outside
  its K6 kernel, a TPU lane-layout choice, not the function: the wrapper
  hands the launcher x itself and ``torch.empty_like(x)``, as K7's and
  K8's do;
- K8 ``sk_chain_banded`` (``_sk_chain_banded_fwd``, :343): the whole SK dw
  stack for ks = (1,)*n1 + (k,), k=1 stages, zero halo, the banded conv,
  bias, residual and gelu in one kernel, NHWC in and out as K7 (JAX's pad
  and transposes around its kernel are a TPU lane-layout choice): the
  wrapper hands the launcher x itself and ``torch.empty_like(x)``.

Which body is whose:

- bf16 K7: its own kernel, ``csrc/dw_banded_t.cu``: persistent blocks, one
  an SM, walk strips (image, 16 channels, 56 rows, a run of 16-column
  tiles) along W, keeping each channel's planes in a ring so that a tile's
  k - 1 halo columns carry over; each step's NHWC box comes by TMA (by
  cp.async where the pixel pitch is not a multiple of 16 bytes), issued
  two steps ahead, while 16 warps, one a channel, transpose, multiply
  (mma.sync m16n8k16 in the engine's order: K6's sums bit for bit) and
  store 32-byte pixel runs. ``t_plan`` mirrors its strip plan;
- bf16 K6 and K8: the engine of ``csrc/sk_chain.cuh``, shared with K5
  (``dw_chain``) under a policy each: a block per (image, 32 x 32
  outputs, 8 channels) copies the haloed NHWC box into shared memory by
  cp.async, 16-byte pixel runs (8-byte at convc1's C = 324, whose
  648-byte rows take no 16-byte copy), applies K8's k=1 stages once per
  box pixel while writing the per-channel planes of the banded product,
  and stores whole pixel runs;
- f32 K6, K7 and K8: the slab body of ``csrc/dw_banded.cu`` (CUDA-core
  FMAs; K8's with the stages fused).

x is (B, H, W, C); weights are PyTorch's depthwise (C, 1, k, k) (the SK
block's ``nn.Conv2d`` parameters as they are), biases (C,). The kernels
take k odd in [3, 15]; the k=1 stages of the per-stage layouts are
``x * w + b`` outside them, as in JAX.

Rounding points, as the Pallas kernels (their plain versions follow them):
K6 and K7 sum the conv in f32, round once to the io dtype, then add b in
the io dtype. K8 computes A = the k=1 stages (``v + v w + b`` then gelu) in
f32, feeds the conv A rounded to the io dtype, and adds the unrounded A as
the residual: io(gelu(A + conv + b_k)). So K8's plain version is not
``dw_chain_plain`` (K5's, which adds the rounded A). ``dw_banded_xla``
(the ``'banded'`` layout, JAX's XLA composite of the same name, no Pallas
kernel) rounds the product to the io dtype before its k-way shifted add.

Gradients, as the JAX custom_vjps give them: the forward is the kernel,
the backward autograd of the plain version (an f32 depthwise-conv
composite) recomputed from the saved inputs (``ops.kernels.CompositeVJP``).
JAX's backward recomputes through the dot-only ``dw_banded_xla`` instead,
a dodge of an XLA-TPU conv weight-gradient miscompile: the same function
and gradient, and not ported. ``dw_banded_xla`` differentiates through its
own ops, as in JAX.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.kernels import LAUNCHES, with_composite_vjp

_KS = (3, 5, 7, 9, 11, 13, 15)   # conv sizes csrc/dw_banded.cu takes

# csrc/dw_banded_t.cu's tiles (K7, bf16): channels a strip, output columns
# a tile, output rows a strip, box rows loaded, columns of a strip's first
# step, plane positions kept, box stages, consumer warps
T_TILES = dict(CB=16, TW=16, HB=56, LH=72, HALO=16, RING=32, NS=2, NCW=16)
_SMEM_MAX = 232448        # bytes of shared memory a block may use


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def t_smem_bytes() -> int:
    """Shared memory of K7's bf16 block (csrc/dw_banded_t.cu's SMEM): the
    box stages, the channels' plane rings and sums tiles (each 16 bytes
    past a multiple of 128; a sums row 16 bytes past its TW columns), the
    pair tables (18 entries for each of 15 kx) and the mbarriers."""
    t = T_TILES
    stage = t["TW"] * t["LH"] * 2 * t["CB"]
    plane = t["RING"] * t["LH"] * 2 + 16
    sums = t["HB"] * (2 * t["TW"] + 16) + 16
    return (t["NS"] * stage + t["CB"] * (plane + sums + 15 * 18 * 4)
            + t["NS"] * 8)


def t_plan(nb: int, h: int, w: int, c: int, sms: int) -> dict:
    """csrc/dw_banded_t.cu's plan(): K7's strips for an (nb, h, w, c) call
    on ``sms`` SMs. A strip is (image, CB channels, HB rows, a run of
    ``tps`` TW-column tiles); ``tps`` minimises the waves of strips over the
    SMs times a strip's steps (a tile 4, its halo step 1), the longest run
    on a tie; the grid is one block an SM, at most one a strip."""
    t = T_TILES
    tiles_w, ncg, nbands = _cdiv(w, t["TW"]), _cdiv(c, t["CB"]), _cdiv(
        h, t["HB"])
    base, best = nb * ncg * nbands, None
    for tps in range(tiles_w, 0, -1):
        nseg = _cdiv(tiles_w, tps)
        cost = _cdiv(base * nseg, sms) * (4 * tps + 1)
        if best is None or cost < best[0]:
            best = (cost, tps, nseg)
    _, tps, nseg = best
    strips = base * nseg
    return dict(tiles_w=tiles_w, ncg=ncg, nbands=nbands, tps=tps,
                nseg=nseg, strips=strips, grid=min(strips, sms))


def t_strip(plan: dict, s: int):
    """Strip ``s`` of a plan as the kernel decodes it: (image, first
    channel, first row, first tile, tiles)."""
    t = T_TILES
    s, seg = divmod(s, plan["nseg"])
    s, band = divmod(s, plan["nbands"])
    b, cg = divmod(s, plan["ncg"])
    t0 = seg * plan["tps"]
    return (b, cg * t["CB"], band * t["HB"], t0,
            min(plan["tps"], plan["tiles_w"] - t0))


def _conv_f32(a, w):
    """Depthwise SAME conv of NHWC ``a`` in f32 (on a contiguous NCHW copy,
    where ATen's depthwise kernels run it and its backward); NHWC f32."""
    k, c = w.shape[-1], w.shape[0]
    y = F.conv2d(a.float().permute(0, 3, 1, 2).contiguous(), w.float(), None,
                 1, k // 2, 1, c)
    return y.permute(0, 2, 3, 1)


def dw_banded_mxu_plain(x, w, b):
    """K6's function in PyTorch, rounded where the kernel rounds: the conv
    in f32, rounded to x's dtype, + b in that dtype."""
    if w.shape[-1] == 1:
        return x * w.reshape(-1) + b
    return (_conv_f32(x, w).to(x.dtype) + b).contiguous()


# K7 computes K6's function with the layout transposes inside the kernel
dw_banded_mxu_t_plain = dw_banded_mxu_plain


def sk_chain_banded_plain(x, weights, biases, ks):
    """K8's function in PyTorch, rounded where the kernel rounds."""
    a = x.float()
    for w, b in zip(weights[:-1], biases[:-1]):
        a = F.gelu(a + a * w.float().reshape(-1) + b.float())
    y = _conv_f32(a.to(x.dtype), weights[-1])
    return F.gelu(a + y + biases[-1].float()).to(x.dtype).contiguous()


def band_rhs(w, h, dtype):
    """The banded weights R (C, Hp, k*H) of depthwise weights w (C, 1, k, k):
    R[c, hp, kx*H + ho] = w[c, 0, hp - ho, kx] for 0 <= hp - ho < k, else 0
    (``_banded_dw_kernel.py:38``)."""
    c, k = w.shape[0], w.shape[-1]
    hp = h + k - 1
    ar = torch.arange(hp, device=w.device)
    d = ar[:, None] - ar[None, :h]                       # (Hp, H): ky
    wk = w.reshape(c, k, k)[:, d.clamp(0, k - 1)]        # (C, Hp, H, kx)
    band = torch.where(((d >= 0) & (d < k))[None, :, :, None], wk,
                       wk.new_zeros(())).to(dtype)
    return band.permute(0, 1, 3, 2).reshape(c, hp, k * h)


def dw_banded_xla(x, w, b):
    """The ``'banded'`` layout's depthwise conv (``_banded_dw_kernel.py:55``):
    per channel one (B*Wp, Hp) @ (Hp, k*H) product (``torch.bmm``, f32
    accumulation, rounded to x's dtype), then the k-way shifted add in
    x's dtype, + b. Differentiable through its own ops."""
    k = w.shape[-1]
    if k == 1:
        return x * w.reshape(-1) + b
    r = k // 2
    nb, h, wd, c = x.shape
    hp, wp = h + 2 * r, wd + 2 * r
    lhs = F.pad(x, (0, 0, r, r, r, r)).permute(3, 0, 2, 1).reshape(
        c, nb * wp, hp)
    out = torch.bmm(lhs, band_rhs(w, h, x.dtype)).reshape(c, nb, wp, k, h)
    y = None
    for kx in range(k):
        t = out[:, :, kx:kx + wd, kx]
        y = t if y is None else y + t
    return y.permute(1, 3, 2, 0) + b


def dw_banded_mxu(x, w, b):
    """K6: x (B, H, W, C), w (C, 1, k, k), b (C,). Differentiable."""
    return with_composite_vjp(_run_mxu, dw_banded_mxu_plain, x, w, b)


def dw_banded_mxu_t(x, w, b):
    """K7: x (B, H, W, C), w (C, 1, k, k), b (C,). Differentiable."""
    return with_composite_vjp(_run_mxu_t, dw_banded_mxu_t_plain, x, w, b)


def sk_chain_banded(x, weights, biases, ks):
    """K8: x (B, H, W, C); weights[i] (C, 1, k_i, k_i), biases[i] (C,) for
    ks = (1,)*n1 + (k,). Differentiable."""
    ks, n = tuple(ks), len(ks)
    if not (len(weights) == len(biases) == n):
        raise ValueError(f"sk_chain_banded: {len(weights)} weights and "
                         f"{len(biases)} biases for ks={ks}")

    def call(fn):
        return lambda x, *wb: fn(x, wb[:n], wb[n:], ks)
    return with_composite_vjp(call(_run_chain), call(sk_chain_banded_plain),
                              x, *weights, *biases)


def _run_conv(name, x, w, b):
    """K6 or K7 (``name``): one function, one launcher interface."""
    if not x.is_cuda:
        return dw_banded_mxu_plain(x, w, b)
    _check(x, w, b)
    out = torch.empty_like(x)
    _build.check(getattr(_build.library(), "sf_" + name)(
        _build.ptr(x), _build.ptr(w), _build.ptr(b), _build.ptr(out),
        *x.shape, w.shape[-1], _build.dtype_code(x.dtype),
        _build.stream_of(x)), name)
    LAUNCHES[name] += 1
    return out


_run_mxu = functools.partial(_run_conv, "dw_banded_mxu")
_run_mxu_t = functools.partial(_run_conv, "dw_banded_mxu_t")


def _run_chain(x, weights, biases, ks):
    if not x.is_cuda:
        return sk_chain_banded_plain(x, weights, biases, ks)
    if any(k != 1 for k in ks[:-1]):
        raise ValueError(f"sk_chain_banded takes ks = (1,)*n + (k,), got {ks}")
    c, n1 = x.shape[-1], len(ks) - 1
    for i, t in enumerate(weights[:-1]):
        _build.require(t, f"weights[{i}]", x.dtype)
        if tuple(t.shape) != (c, 1, 1, 1):
            raise ValueError(f"weights[{i}] is {tuple(t.shape)}, expected "
                             f"{(c, 1, 1, 1)}")
    for i, t in enumerate(biases[:-1]):
        _build.require(t, f"biases[{i}]", x.dtype)
        if tuple(t.shape) != (c,):
            raise ValueError(f"biases[{i}] is {tuple(t.shape)}, expected "
                             f"{(c,)}")

    def stages(ts):  # the k=1 stages as (n1, C); a view for a single one
        if n1 == 1:
            return ts[0].reshape(c)
        return torch.stack([t.reshape(c) for t in ts]) if n1 else None
    k1w, k1b = stages(weights[:-1]), stages(biases[:-1])
    _check(x, weights[-1], biases[-1])
    out = torch.empty_like(x)
    _build.check(_build.library().sf_sk_chain_banded(
        _build.ptr(x), _build.ptr(k1w), _build.ptr(k1b),
        _build.ptr(weights[-1]), _build.ptr(biases[-1]), _build.ptr(out),
        *x.shape, n1, ks[-1], _build.dtype_code(x.dtype),
        _build.stream_of(x)), "sk_chain_banded")
    LAUNCHES["sk_chain_banded"] += 1
    return out


def _check(x, w, b):
    """What the kernels take: contiguous CUDA tensors of x's dtype,
    w (C, 1, k, k) with k odd in [3, 15], b (C,)."""
    _build.require(x, "x", ndim=4)
    c, k = x.shape[-1], w.shape[-1]
    _build.require(w, "w", x.dtype)
    _build.require(b, "b", x.dtype)
    if k not in _KS or tuple(w.shape) != (c, 1, k, k):
        raise ValueError(f"w is {tuple(w.shape)}, expected (C, 1, k, k) with "
                         f"C={c} and k odd in [3, 15]")
    if tuple(b.shape) != (c,):
        raise ValueError(f"b is {tuple(b.shape)}, expected {(c,)}")

