"""K2, the fused FFN pair (CUDA source ``csrc/ffn_pair.cu``).

Replaces the Pallas kernel ``streamflow_tpu/ops/pallas/_ffn_kernel.py::
_ffn_pair_fwd`` in the three forms the main path runs:

- ``ffn_pair_k1``: the SK block's first FFN pair with the dw chain's k=1
  stage as an epilogue, y = k1(gelu(x + gelu(x W1 + b1) W2 + b2));
- ``dwres_pw_ffn_pair``: the dw conv's bias + residual gelu, the pointwise
  stage and the second pair, no residual;
- ``ln_ffn_pair``: the Twins pre-norm MLP, x + fc2(gelu(fc1(LN(x)))).

On the H100 the bf16 kernel runs its GEMMs on the tensor cores; the hidden
activation never reaches device memory (see the source's header). Weights
are in nn.Linear layout (out, in); 1x1 conv weights are the same matrix.

The plain version is a port of ``ffn_pair_xla``: the same stages, rounded
to the io type at the same points, products accumulated in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.kernels import LAUNCHES

_SMEM_MAX = 232448        # bytes of shared memory a block may use


def _smem_bytes(dt, c: int, ch: int, pw: bool) -> int:
    """Shared memory of the smallest row tile csrc/ffn_pair.cu launches."""
    if dt == torch.float32:                        # 16 rows, f32
        return 4 * 16 * (2 * ((c + 3) // 4 * 4) + (ch + 3) // 4 * 4)

    def ld(k):
        return (k + 15) // 16 * 16 + 8
    # 32 rows, bf16; with the pw stage the hidden tile reuses x's space
    return 2 * 32 * (ld(c) + (max(ld(c), ld(ch)) if pw else ld(ch)))


def _ln_f32(x, g, b, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    return (xf - mean) * torch.rsqrt(var + eps) * g.float() + b.float()


def ffn_pair_plain(x, w1, b1, w2, b2, residual=True, wp=None, bp=None,
                   kw=None, kb=None, yres=None, db=None, ln=None,
                   add_res=False):
    """Port of ffn_pair_xla: exact math of the kernel. Weights (out, in)."""
    dt = x.dtype
    x_raw = x
    if ln is not None:
        x = _ln_f32(x, ln[0], ln[1]).to(dt)
    if yres is not None:
        x = F.gelu(x.float() + yres.float() + db.float()).to(dt)
    if wp is not None:
        p = x.float() @ wp.float().t()
        x = F.gelu(x.float() + p + bp.float()).to(dt)
    h = F.gelu(x.float() @ w1.float().t() + b1.float()).to(dt)
    y = h.float() @ w2.float().t() + b2.float()
    if residual:
        y = F.gelu(x.float() + y)
    if kw is not None:
        y = F.gelu(y + y * kw.float() + kb.float())
    if add_res:
        y = y + x_raw.float()
    return y.to(dt)


def _launch(x, w1, b1, w2, b2, residual, wp=None, bp=None, kw=None, kb=None,
            yres=None, db=None, ln_g=None, ln_b=None, add_res=False):
    c = x.shape[-1]
    ch, co = w1.shape[0], w2.shape[0]
    n = x.numel() // c
    _build.require(x, "x")
    dt = x.dtype
    shapes = {"w1": (w1, (ch, c)), "b1": (b1, (ch,)), "w2": (w2, (co, ch)),
              "b2": (b2, (co,)), "wp": (wp, (c, c)), "bp": (bp, (c,)),
              "kw": (kw, (co,)), "kb": (kb, (co,)), "yres": (yres, x.shape),
              "db": (db, (c,)), "ln_g": (ln_g, (c,)), "ln_b": (ln_b, (c,))}
    for name, (t, shape) in shapes.items():
        if t is None:
            continue
        _build.require(t, name, dt)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {shape}")
    if (residual or add_res) and co != c:
        raise ValueError("a residual needs C_out == C_in")
    if c % 2 or ch % 2:
        raise ValueError(f"ffn_pair takes even widths, got C={c}, "
                         f"hidden={ch}")
    smem = _smem_bytes(dt, c, ch, wp is not None)
    if smem > _SMEM_MAX:
        raise ValueError(f"ffn_pair tile needs {smem} B of shared memory "
                         f"(C={c}, hidden={ch})")
    out = torch.empty(*x.shape[:-1], co, dtype=dt, device=x.device)
    p = _build.ptr
    lib = _build.library()
    code = lib.sf_ffn_pair(
        p(x), p(yres), p(db), p(ln_g), p(ln_b), p(wp), p(bp), p(w1), p(b1),
        p(w2), p(b2), p(kw), p(kb), p(out), n, c, ch, co, int(residual),
        int(add_res), _build.dtype_code(dt), _build.stream_of(x))
    _build.check(code, "ffn_pair")
    LAUNCHES["ffn_pair"] += 1
    return out


def ffn_pair_k1(x, w1, b1, w2, b2, kw, kb):
    """gelu(y + y*kw + kb) of y = gelu(x + gelu(x W1 + b1) W2 + b2)."""
    if not x.is_cuda:
        return ffn_pair_plain(x, w1, b1, w2, b2, True, kw=kw, kb=kb)
    return _launch(x, w1, b1, w2, b2, True, kw=kw, kb=kb)


def dwres_pw_ffn_pair(x, y, db, wp, bp, w1, b1, w2, b2):
    """x' = gelu(x + y + db); x'' = gelu(x' + x' Wp + bp);
    out = gelu(x'' W1 + b1) W2 + b2."""
    if not x.is_cuda:
        return ffn_pair_plain(x, w1, b1, w2, b2, False, wp=wp, bp=bp,
                              yres=y, db=db)
    return _launch(x, w1, b1, w2, b2, False, wp=wp, bp=bp, yres=y, db=db)


def ln_ffn_pair(x, g, be, w1, b1, w2, b2, add_res=True):
    """[x +] gelu(LN(x) W1 + b1) W2 + b2, LN with f32 stats, eps 1e-5."""
    if not x.is_cuda:
        return ffn_pair_plain(x, w1, b1, w2, b2, False, ln=(g, be),
                              add_res=add_res)
    return _launch(x, w1, b1, w2, b2, False, ln_g=g, ln_b=be,
                   add_res=add_res)
