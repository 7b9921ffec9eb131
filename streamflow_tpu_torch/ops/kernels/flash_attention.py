"""K3, non-causal flash attention forward (CUDA source ``csrc/flash_attn.cu``),
and B5, its backward (``csrc/flash_attn_bwd.cu``).

K3 replaces the Pallas kernel ``streamflow_tpu/ops/pallas/_attention_kernel.py
::flash_attention_tpu`` (wrapper ops/pallas/attention.py::flash_attention):
softmax(q k^T) v with q already scaled, f32 softmax, without the (N, M)
score matrix in device memory, and, for the backward, the per-row
logsumexp. B5 replaces ``flash_attention_bwd_tpu``: dq, dk, dv with the
probabilities rebuilt from that logsumexp. Users on the main path: the GMA
aggregate (1 head, d=128; d=384 with the UMT encoder's decoder_dim=768)
and the Twins GSA blocks above 16384 tokens (d=32); the UMT encoder's ViT
blocks (12 heads, d=64). B5 takes the same four head dims, so a UMT model
trains on the card too; any other head dim raises before a launch.

``flash_attention`` is differentiable like the JAX package's custom_vjp
(ops/pallas/attention.py:89-127): when autograd records, the forward keeps
(q, k, v, o, lse), and the backward computes delta = rowsum(dO * O) as a
small PyTorch pass and calls B5; otherwise the forward skips the
logsumexp output. On the H100 the bf16 kernels run their products on
wgmma fed by TMA rings (K3, and both passes of B5; at d=384 both split
the output's columns over two warpgroups; see the sources' headers). The
plain versions are a port of ``_flash_xla`` (streaming softmax over kv
chunks, f32) and the backward's math written out in f32 torch ops,
rounded where the TPU kernels round.
"""

from __future__ import annotations

import torch

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.kernels import LAUNCHES

HEAD_DIMS = (32, 64, 128, 384)  # GSA, UMT's ViT, GMA, UMT's GMA: K3 and B5


def flash_attention_plain(q, k, v, return_lse: bool = False,
                          kv_chunk: int = 2048, q_chunk: int = 16384):
    """q (B, H, N, D) pre-scaled, k/v (B, H, M, D) -> (B, H, N, D) in v's
    dtype [and the per-row logsumexp (B, H, N) f32]; online softmax over
    kv chunks in f32 (q chunks bound memory)."""
    m = k.shape[2]
    outs, lses = [], []
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
        lses.append(row_max + torch.log(row_sum))
    out = torch.cat(outs, dim=2).to(v.dtype)
    return (out, torch.cat(lses, dim=2)) if return_lse else out


def flash_attention_bwd_plain(q, k, v, do, lse, delta, q_chunk: int = 8192):
    """Backward of softmax(q k^T) v in f32 torch ops: P = exp(q k^T - lse),
    dS = P (dO v^T - delta); dS and P rounded to the io dtype before the
    products that take them, as the TPU kernels do. Returns (dq, dk, dv) in
    the input dtypes."""
    dt = q.dtype
    kf, vf = k.float(), v.float()
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dqs = []
    for q0 in range(0, q.shape[2], q_chunk):
        sl = slice(q0, q0 + q_chunk)
        qc, doc = q[:, :, sl].float(), do[:, :, sl].float()
        p = torch.exp(qc @ kf.transpose(-1, -2) - lse[:, :, sl, None])
        ds = p * (doc @ vf.transpose(-1, -2) - delta[:, :, sl, None])
        ds = ds.to(dt).float()
        dqs.append(ds @ kf)
        dv += p.to(dt).float().transpose(-1, -2) @ doc
        dk += ds.transpose(-1, -2) @ qc
    return (torch.cat(dqs, dim=2).to(dt), dk.to(k.dtype), dv.to(v.dtype))


def _check(q, k, v, what="flash_attention"):
    b, h, n, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.dtype, 4)
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} takes head dims {HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not match")


def flash_attention_fwd(q, k, v, return_lse: bool = False):
    """K3: softmax(q k^T) v [and the per-row logsumexp (B, H, N) f32].
    No queries (an empty slab): empty outputs, no launch."""
    if not q.shape[2]:
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = torch.empty_like(q)
        return (out, lse) if return_lse else out
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, return_lse)
    _check(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, n, dtype=torch.float32, device=q.device)
           if return_lse else None)
    # the bf16 kernel's TMA maps need 16-byte aligned bases and row strides
    # (d * 2 bytes: every HEAD_DIMS entry)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention needs 16-byte aligned tensors")
    lib = _build.library()
    code = lib.sf_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), _build.ptr(lse), b * h, n,
                            k.shape[2], d, _build.dtype_code(q.dtype),
                            _build.stream_of(q))
    _build.check(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, do, lse, delta):
    """B5: (dq, dk, dv) of softmax(q k^T) v from dO, the forward's lse and
    delta = rowsum(dO * O) (both (B, H, N) f32); outputs in the input
    dtypes. Launches two kernels, the dq pass and the dk/dv pass, and
    counts each."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, do, lse, delta)
    _check(q, k, v, "flash_attention_bwd")
    _build.require(do, "do", q.dtype, 4)
    b, h, n, d = q.shape
    m = k.shape[2]
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        _build.require(t, name, torch.float32, 3)
        if t.shape != (b, h, n):
            raise ValueError(f"{name} {tuple(t.shape)} != {(b, h, n)}")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_attention_bwd needs 16-byte aligned tensors")
    # f32 buffers that the kernels' blocks add into, rounded once below
    dq, dk, dv = (torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                  for t in (q, k, v))
    lib = _build.library()
    p = _build.ptr
    code = lib.sf_flash_bwd(p(q), p(k), p(v), p(do), p(lse), p(delta), p(dq),
                            p(dk), p(dv), b * h, n, m, d,
                            _build.dtype_code(q.dtype), _build.stream_of(q))
    _build.check(code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 2
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """K3 forward with lse; backward delta = rowsum(dO * O), then B5."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        return flash_attention_bwd(q, k, v, do, lse, delta)


def flash_attention(q, k, v):
    """softmax(q k^T) v, q pre-scaled. q (B, H, N, D), k/v (B, H, M, D).
    Differentiable (B5) when autograd records."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return flash_attention_fwd(q, k, v)
