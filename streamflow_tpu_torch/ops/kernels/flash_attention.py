"""K3, non-causal flash attention forward (CUDA source
``csrc/flash_attn.cu``).

Replaces the Pallas kernel ``streamflow_tpu/ops/pallas/_attention_kernel.py
::flash_attention_tpu`` (wrapper ops/pallas/attention.py::flash_attention):
softmax(q k^T) v with q already scaled, f32 softmax, without the (N, M)
score matrix in device memory. Users on the main path: the GMA aggregate
(1 head, d=128) and the Twins GSA blocks above 16384 tokens (d=32).

On the H100 the bf16 kernel runs both products on the tensor cores (see
the source's header). The plain version is a port
of ``_flash_xla``: streaming softmax over kv chunks, in f32.
"""

from __future__ import annotations

import torch

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.kernels import LAUNCHES

HEAD_DIMS = (32, 128)  # GSA, GMA


def flash_attention_plain(q, k, v, kv_chunk: int = 2048,
                          q_chunk: int = 16384):
    """q (B, H, N, D) pre-scaled, k/v (B, H, M, D) -> (B, H, N, D) in v's
    dtype; online softmax over kv chunks in f32 (q chunks bound memory)."""
    m = k.shape[2]
    outs = []
    for q0 in range(0, q.shape[2], q_chunk):
        qf = q[:, :, q0:q0 + q_chunk].float()
        acc = torch.zeros_like(qf)
        row_max = torch.full(qf.shape[:-1], float("-inf"), device=q.device)
        row_sum = torch.zeros(qf.shape[:-1], device=q.device)
        for s in range(0, m, kv_chunk):
            kb = k[:, :, s:s + kv_chunk].float()
            vb = v[:, :, s:s + kv_chunk].float()
            sc = qf @ kb.transpose(-1, -2)
            new_max = torch.maximum(row_max, sc.amax(-1))
            corr = torch.exp(row_max - new_max)
            p = torch.exp(sc - new_max[..., None])
            acc = acc * corr[..., None] + p @ vb
            row_sum = row_sum * corr + p.sum(-1)
            row_max = new_max
        outs.append(acc / row_sum[..., None])
    return torch.cat(outs, dim=2).to(v.dtype)


def flash_attention(q, k, v):
    """softmax(q k^T) v, q pre-scaled. q (B, H, N, D), k/v (B, H, M, D)."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    b, h, n, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.dtype, 4)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not match")
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention needs 16-byte aligned tensors")
    lib = _build.library()
    code = lib.sf_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), b * h, n, k.shape[2], d,
                            _build.dtype_code(q.dtype), _build.stream_of(q))
    _build.check(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
