"""K5, the SK block's depthwise chain (CUDA source ``csrc/dw_chain.cu``).

Replaces the Pallas kernel ``streamflow_tpu/ops/pallas/_dw_conv_kernel.py::
_dw_chain_fwd`` (the ``dw_chain`` custom_vjp). For ks = (1,)*n1 + (k,) and
x (B, H, W, C) NHWC: A = gelu(x (1 + w_i) + b_i) over the k=1 stages, in
f32, rounded once to the io dtype; out = gelu(A + dwconv_k(A) + b_k), the
conv with SAME zero padding of A, products, sums and gelu in f32. Weights
are in PyTorch's depthwise layout, (C, 1, k, k) per stage (the SK block's
``nn.Conv2d`` weights as they are); biases (C,).

On the H100 the kernel is bound by the conv's f32 multiply-adds on the
CUDA cores; A never leaves shared memory (see the source's header).

The plain version follows the Pallas kernel's rounding points, not
``chain_xla``'s (which also rounds y = x w + b to the io dtype); in f32
the two agree. Its conv is ``F.conv2d`` (groups=C) in f32 on an NCHW copy.

Gradients to x and to every weight and bias, as the JAX package's
custom_vjp (``_dw_conv_kernel.py:208-229``, backward through
``chain_xla``): the forward is the kernel, the backward is autograd of the
plain version recomputed from the saved inputs (``ops.kernels.
CompositeVJP``). There is no Pallas backward, so there is no backward
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.kernels import LAUNCHES, with_composite_vjp

_KS = (3, 5, 7, 9, 11, 13, 15)   # conv sizes csrc/dw_chain.cu is built for


def dw_chain_plain(x, weights, biases, ks):
    """The chain in PyTorch, rounded where the kernel rounds."""
    dt, c, k = x.dtype, x.shape[-1], ks[-1]
    a = x.float()
    for w, b in zip(weights[:-1], biases[:-1]):
        a = F.gelu(a * (1.0 + w.float().reshape(c)) + b.float())
    a = a.to(dt).float()
    # on a contiguous NCHW copy: there the f32 depthwise conv and its
    # backward take ATen's depthwise kernels; on the channels-last view the
    # k=7 weight gradient took cuDNN's grouped wgrad kernel, 5.9 ms per call
    # at (3, 54, 120, 640) (H100 80GB HBM3, 700 W)
    y = F.conv2d(a.permute(0, 3, 1, 2).contiguous(), weights[-1].float(),
                 None, 1, k // 2, 1, c)
    return F.gelu(a + y.permute(0, 2, 3, 1) + biases[-1].float()).to(dt)


def dw_chain(x, weights, biases, ks):
    """x (B, H, W, C); weights[i] (C, 1, k_i, k_i), biases[i] (C,) for the
    stages of ks. Differentiable (see the module's docstring)."""
    ks, n = tuple(ks), len(ks)
    if not (len(weights) == len(biases) == n):
        raise ValueError(f"dw_chain: {len(weights)} weights and "
                         f"{len(biases)} biases for ks={ks}")

    def call(fn):
        return lambda x, *wb: fn(x, wb[:n], wb[n:], ks)
    return with_composite_vjp(call(_run), call(dw_chain_plain), x, *weights,
                              *biases)


def _run(x, weights, biases, ks):
    if not x.is_cuda:
        return dw_chain_plain(x, weights, biases, ks)
    return _launch(x, weights, biases, ks)


def _launch(x, weights, biases, ks):
    _build.require(x, "x", ndim=4)
    nb, h, w, c = x.shape
    dt, k, n1 = x.dtype, ks[-1], len(ks) - 1
    if any(kk != 1 for kk in ks[:-1]) or k not in _KS:
        raise ValueError(f"dw_chain takes ks = (1,)*n + (k,), k odd in "
                         f"[3, 15]; got {ks}")
    if c % 2:
        raise ValueError(f"dw_chain takes an even channel count (channel "
                         f"pairs), got C={c}")
    for i, (t, kk) in enumerate(zip(weights, ks)):
        _build.require(t, f"weights[{i}]", dt)
        if tuple(t.shape) != (c, 1, kk, kk):
            raise ValueError(f"weights[{i}] is {tuple(t.shape)}, expected "
                             f"{(c, 1, kk, kk)}")
    for i, t in enumerate(biases):
        _build.require(t, f"biases[{i}]", dt)
        if tuple(t.shape) != (c,):
            raise ValueError(f"biases[{i}] is {tuple(t.shape)}, expected "
                             f"{(c,)}")
    def stages(ts):  # the k=1 stages as (n1, C); a view for a single one
        if n1 == 1:
            return ts[0].reshape(c)
        return torch.stack([t.reshape(c) for t in ts]) if n1 else None
    k1w, k1b = stages(weights[:-1]), stages(biases[:-1])
    out = torch.empty_like(x)
    for t in (x, k1w, k1b, weights[-1], biases[-1], out):
        if t is not None and t.data_ptr() % (2 * t.element_size()):
            raise ValueError("dw_chain reads channel pairs: every tensor "
                             "must start at an even element")
    p = _build.ptr
    code = _build.library().sf_dw_chain(
        p(x), p(k1w), p(k1b), p(weights[-1]), p(biases[-1]), p(out), nb, h,
        w, c, n1, k, _build.dtype_code(dt), _build.stream_of(x))
    _build.check(code, "dw_chain")
    LAUNCHES["dw_chain"] += 1
    return out
