"""K4, Twins-SVT locally-grouped (windowed) attention (CUDA source
``csrc/lga_attn.cu``).

Replaces the Pallas kernel ``streamflow_tpu/ops/pallas/_lga_kernel.py::
lga_attention``: per ws x ws window and head, softmax(q k^T) v on the
already-projected qkv grid (B, Hp, Wp, 3C) -> (B, Hp, Wp, C). q is scaled
in the io dtype, the softmax is f32 and the probabilities are rounded to
the io dtype, as in ``layers/twins.py::lga_xla``. Padded grid tokens are
not masked (they hold qkv = bias, as in the JAX composite).

On the H100 the kernel is bound by bytes: the bf16 kernel reads each qkv
row once, a block per window for all heads, and runs the products on the
tensor cores (see the source's header). The plain version is the attention part of
``lga_xla``: window partition, per-head softmax attention, inverse
partition.

Gradients to qkv, as the JAX package's custom_vjp of the Pallas kernel
(layers/twins.py:137-143, backward through ``lga_xla``): the forward is
the kernel, the backward is autograd of the plain version recomputed from
the saved qkv (``ops.kernels.CompositeVJP``), ordinary PyTorch in both
packages, not a plain version standing in for a kernel.
"""

from __future__ import annotations

import torch

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.kernels import LAUNCHES, with_composite_vjp


def _scale(hd: int, dtype) -> float:
    """hd**-0.5 as the io dtype holds it."""
    return float(torch.tensor(hd ** -0.5, dtype=dtype))


def lga_attention_plain(qkv, ws: int, nh: int):
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    gh, gw = hp // ws, wp // ws
    dt = qkv.dtype
    x = qkv.reshape(b, gh, ws, gw, ws, 3, nh, hd)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, gh * gw, nh,
                                                  ws * ws, hd)
    q = (x[0] * _scale(hd, dt)).float()
    attn = torch.softmax(q @ x[1].float().transpose(-1, -2), dim=-1).to(dt)
    out = (attn.float() @ x[2].float()).to(dt)          # (B, G, nh, S, hd)
    out = out.reshape(b, gh, gw, nh, ws, ws, hd)
    return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, hp, wp, c)


def lga_attention(qkv, ws: int, nh: int):
    """qkv (B, Hp, Wp, 3C), Hp and Wp multiples of ws -> (B, Hp, Wp, C).
    Differentiable (see the module's docstring)."""
    return with_composite_vjp(lambda x: _lga_attention(x, ws, nh),
                              lambda x: lga_attention_plain(x, ws, nh), qkv)


def _lga_attention(qkv, ws: int, nh: int):
    if not qkv.is_cuda:
        return lga_attention_plain(qkv, ws, nh)
    _build.require(qkv, "qkv", ndim=4)
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % nh or hp % ws or wp % ws:
        raise ValueError(f"lga_attention: bad qkv {tuple(qkv.shape)} for "
                         f"ws={ws}, nh={nh}")
    if ws * ws > 64 or c // nh > 32:
        raise ValueError("lga_attention takes ws*ws <= 64 and head dim <= 32")
    out = torch.empty(b, hp, wp, c, dtype=qkv.dtype, device=qkv.device)
    lib = _build.library()
    code = lib.sf_lga_attn(qkv.data_ptr(), out.data_ptr(), b, hp, wp, c, nh,
                           ws, _scale(c // nh, qkv.dtype),
                           _build.dtype_code(qkv.dtype),
                           _build.stream_of(qkv))
    _build.check(code, "lga_attention")
    LAUNCHES["lga_attention"] += 1
    return out
