"""The channel-major FFN pair (CUDA source ``csrc/ffn_pair_cmajor.cu``),
for ``tools/probe_cmajor_ffn.py``.

Replaces the Pallas kernel of ``tools/probe_cmajor_ffn.py``
(``ffn_pair_cmajor`` -> ``pl.pallas_call``): K2's pair on a (C, N)
operand, tokens along the rows, which asks whether a channel-major SK
layout keeps K2's rate. ``h = gelu(W1 x + b1)`` rounded to x's dtype,
``y = W2 h + b2``, with the residual ``y = gelu(x + y)``; (Co, N) out.
Weights in nn.Linear layout (out, in) and the biases in x's dtype, as
K2's; products and biases in f32. The kernel (TMA tiles, wgmma with the
weights as A and the tokens as the MN-major B, h in shared memory) takes
bf16 only, widths that are multiples of 64 and a token count of 8;
``LAUNCHES["ffn_pair_cmajor"]`` counts its launches, none of the
model's.
"""

from __future__ import annotations

import torch

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.kernels import LAUNCHES
from streamflow_tpu_torch.ops.kernels.ffn_pair import GELUS, gelu_code


def ffn_pair_cmajor_plain(x, w1, b1, w2, b2, residual=True, gelu="erf"):
    """Plain PyTorch version: the same stages, h rounded to x's dtype."""
    gelu_code(gelu)          # raises on an unknown variant
    act = GELUS[gelu]
    dt = x.dtype
    h = act(w1.float() @ x.float() + b1.float()[:, None]).to(dt)
    y = w2.float() @ h.float() + b2.float()[:, None]
    if residual:
        y = act(x.float() + y)
    return y.to(dt)


def ffn_pair_cmajor(x, w1, b1, w2, b2, residual=True, gelu="erf"):
    """x (C, N); w1 (Ch, C), b1 (Ch,), w2 (Co, Ch), b2 (Co,); (Co, N). The
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    c, n = x.shape
    ch, co = w1.shape[0], w2.shape[0]
    if residual and co != c:
        raise ValueError("a residual needs C_out == C_in")
    if not x.is_cuda:
        return ffn_pair_cmajor_plain(x, w1, b1, w2, b2, residual, gelu)
    _build.require(x, "x", torch.bfloat16, 2)
    for name, t, shape in (("w1", w1, (ch, c)), ("b1", b1, (ch,)),
                           ("w2", w2, (co, ch)), ("b2", b2, (co,))):
        _build.require(t, name, torch.bfloat16)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {shape}")
    if c % 64 or ch % 64 or co % 64 or n % 8:
        raise ValueError(f"ffn_pair_cmajor takes widths that are multiples "
                         f"of 64 and tokens of 8, got C={c}, hidden={ch}, "
                         f"out={co}, N={n}")
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("ffn_pair_cmajor needs 16-byte aligned x and "
                         "weights")
    out = torch.empty(co, n, dtype=x.dtype, device=x.device)
    p = _build.ptr
    code = _build.library().sf_ffn_pair_cmajor(
        p(x), p(w1), p(b1), p(w2), p(b2), p(out), c, ch, co, n,
        int(residual), _build.dtype_code(x.dtype), gelu_code(gelu),
        _build.stream_of(x))
    _build.check(code, "ffn_pair_cmajor")
    LAUNCHES["ffn_pair_cmajor"] += 1
    return out
