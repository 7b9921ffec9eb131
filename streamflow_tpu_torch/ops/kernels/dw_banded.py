"""K6-K8, the banded depthwise convs (CUDA source ``csrc/dw_banded.cu``),
and the ``'banded'`` layout's composite.

Replace the Pallas kernels of ``streamflow_tpu/ops/pallas/
_banded_dw_kernel.py``, which run the SK block's depthwise k x k conv as a
per-channel banded matmul:

- K6 ``dw_banded_mxu`` (``_dw_banded_mxu_fwd``, pallas_call :122): the
  wrapper pads x and transposes it to the C-major operand (C, B*Wp, Hp),
  as JAX does outside its kernel, and transposes the (C, B*W, H) result
  back;
- K7 ``dw_banded_mxu_t`` (``_dw_banded_mxu_t_fwd``, :223): NHWC in and out,
  the transposes and the zero halo inside the kernel; any C (the TPU
  kernel's C % 128 == 0 is a lane rule of the TPU);
- K8 ``sk_chain_banded`` (``_sk_chain_banded_fwd``, :343): the whole SK dw
  stack for ks = (1,)*n1 + (k,), k=1 stages, zero halo, the banded conv,
  bias, residual and gelu in one kernel, on K6's operand.

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

import torch
import torch.nn.functional as F

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.kernels import LAUNCHES, with_composite_vjp

_KS = (3, 5, 7, 9, 11, 13, 15)   # conv sizes csrc/dw_banded.cu takes


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


def _run_mxu(x, w, b):
    if not x.is_cuda:
        return dw_banded_mxu_plain(x, w, b)
    lhs, out = _operand(x, w, b)
    _build.check(_build.library().sf_dw_banded_mxu(
        _build.ptr(lhs), _build.ptr(w), _build.ptr(b), _build.ptr(out),
        *x.shape, w.shape[-1], _build.dtype_code(x.dtype),
        _build.stream_of(x)), "dw_banded_mxu")
    LAUNCHES["dw_banded_mxu"] += 1
    return _from_cmajor(out)


def _run_mxu_t(x, w, b):
    if not x.is_cuda:
        return dw_banded_mxu_t_plain(x, w, b)
    _check(x, w, b)
    out = torch.empty_like(x)
    _build.check(_build.library().sf_dw_banded_mxu_t(
        _build.ptr(x), _build.ptr(w), _build.ptr(b), _build.ptr(out),
        *x.shape, w.shape[-1], _build.dtype_code(x.dtype),
        _build.stream_of(x)), "dw_banded_mxu_t")
    LAUNCHES["dw_banded_mxu_t"] += 1
    return out


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
    lhs, out = _operand(x, weights[-1], biases[-1])
    _build.check(_build.library().sf_sk_chain_banded(
        _build.ptr(lhs), _build.ptr(k1w), _build.ptr(k1b),
        _build.ptr(weights[-1]), _build.ptr(biases[-1]), _build.ptr(out),
        *x.shape, n1, ks[-1], _build.dtype_code(x.dtype),
        _build.stream_of(x)), "sk_chain_banded")
    LAUNCHES["sk_chain_banded"] += 1
    return _from_cmajor(out)


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


def _operand(x, w, b):
    """K6's and K8's operand: x zero-padded by k // 2 and C-major,
    (C, B, Wp, Hp) contiguous; and their (C, B, W, H) output."""
    _check(x, w, b)
    nb, h, wd, c = x.shape
    r = w.shape[-1] // 2
    lhs = x.new_zeros((c, nb, wd + 2 * r, h + 2 * r))
    lhs[:, :, r:r + wd, r:r + h] = x.permute(3, 0, 2, 1)
    return lhs, x.new_empty((c, nb, wd, h))


def _from_cmajor(out):
    """(C, B, W, H) -> (B, H, W, C), contiguous."""
    return out.permute(1, 3, 2, 0).contiguous()
