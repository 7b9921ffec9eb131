"""K2, the fused FFN pair (CUDA source ``csrc/ffn_pair.cu``).

Replaces the Pallas kernel ``streamflow_tpu/ops/pallas/_ffn_kernel.py::
_ffn_pair_fwd`` in its five forms:

- ``ffn_pair_k1``: the SK block's first FFN pair with the dw chain's k=1
  stage as an epilogue, y = k1(gelu(x + gelu(x W1 + b1) W2 + b2));
- ``dwres_pw_ffn_pair``: the dw conv's bias + residual gelu, the pointwise
  stage and the second pair, no residual;
- ``ln_ffn_pair``: the Twins pre-norm MLP, x + fc2(gelu(fc1(LN(x))));
- ``ffn_pair``: the plain pair, with or without its residual gelu (the SK
  block's first pair in the ``dw_impl='pallas'`` layout);
- ``pw_ffn_pair``: the pointwise stage and the pair (that layout's second
  pair, no residual).

The first two and the Twins form run in the default layout, the last two
in the ``dw_impl='pallas'`` layout; all five launch the same kernel where
its shared-memory plan holds the widths (every canonical width). Wider
pairs (the UMT decoder's gru, 1920 -> 2880 -> 1920 / 384 with a 1920-wide
pw stage, and joint flow head, 1152 -> 1728 -> 1152 / 6) take the
kernel's wide path in every form but ``ln_ffn_pair``: one launch per
stage (the dw residual's elementwise prologue, each of the two or three
products with its epilogue), each intermediate rounded where
``ffn_pair_xla`` rounds it and kept in device memory between launches.
``LAUNCHES["ffn_pair"]`` counts every launch: 2 for ``ffn_pair_k1`` and
``ffn_pair``, 3 for ``pw_ffn_pair``, 4 for ``dwres_pw_ffn_pair`` on the
wide path (``wide_launches``), 1 otherwise.

On the H100 the bf16 kernel runs its GEMMs on wgmma with the weights
staged by TMA; the hidden activation never reaches device memory (see the
source's header). Weights are in nn.Linear layout (out, in); 1x1 conv
weights are the same matrix. TMA reads rows of whole 16-byte units, so the
bf16 launch pads a weight whose input width is not a multiple of 8 with
zero columns (convc1's 324 and 486 only).

The plain version is a port of ``ffn_pair_xla``: the same stages, rounded
to the io type at the same points, products accumulated in f32.

Every form takes JAX's ``gelu`` argument (``_ffn_kernel.py:40-59``,
``_GELUS``): ``"erf"`` (the exact gelu, the default), ``"poly"`` (JAX's
``_gelu_poly``, which ``StreamFlowConfig.ffn_gelu="poly"`` selects) or
``"tanh"`` (the tanh approximation, which only the gelu probe runs). The
kernel takes it as a compile-time variant of every gelu it computes (the
prologue's, the pw stage's, the hidden layer's, the residual's and k1's,
on the fused and the wide path); the plain version and the backward
compute the same variant.

Gradients to every tensor argument, as the JAX package's custom_vjp of
each Pallas form (``_ffn_kernel.py:319-450``, backward through
``ffn_pair_xla``): the forward is the kernel, the backward is autograd of
the plain version recomputed from the saved inputs
(``ops.kernels.CompositeVJP``), ordinary PyTorch in both packages, not a
plain version standing in for a kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.kernels import LAUNCHES, with_composite_vjp

_SMEM_MAX = 232448        # bytes of shared memory a block may use
_MAX_OUT = 640            # widest output the bf16 kernel takes


# erf(z) ~ z p(z^2) on [0, 3], saturating outside: JAX's _ERF_POLY
# (streamflow_tpu/ops/pallas/_ffn_kernel.py:40-46), max|err| 4.0e-4
_ERF_POLY = (3.64476874220969839e-06, -1.35030047617407806e-04,
             2.10968155734540678e-03, -1.83597971202626026e-02,
             9.98778049755993935e-02, -3.67134565174511318e-01,
             1.12662306241423282e+00)
# the kernel's code of each variant (csrc/common.cuh's Gelu)
GELU_CODES = {"erf": 0, "poly": 1, "tanh": 2}


def gelu_poly(x):
    """JAX's ``_gelu_poly`` on f32: x clipped to +-3 sqrt 2, the degree-6
    Horner polynomial in x^2 / 2, no divide."""
    lim = 3.0 * math.sqrt(2.0)
    xc = x.clamp(-lim, lim)
    t = xc * xc * 0.5
    acc = torch.full_like(t, _ERF_POLY[0])
    for c in _ERF_POLY[1:]:
        acc = acc * t + c
    return x * 0.5 * (1.0 + xc * (1.0 / math.sqrt(2.0)) * acc)


GELUS = {"erf": F.gelu, "poly": gelu_poly,
         "tanh": lambda x: F.gelu(x, approximate="tanh")}


def gelu_code(gelu: str) -> int:
    if gelu not in GELU_CODES:
        raise ValueError(f"gelu must be one of {tuple(GELU_CODES)}, got "
                         f"{gelu!r}")
    return GELU_CODES[gelu]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(c: int, pw: bool):
    """csrc/ffn_pair.cu's make_plan: (bytes, weight stages) of the bf16
    kernel's shared memory for a 64-row tile: x tile, pw output, two
    hidden-chunk buffers and the staging (inside x's space after the pw
    stage where it fits), the ring of 16 KB stages, the mbarriers."""
    xbytes, aux = _cdiv(c, 64) * 8192, 6 * 8192
    off = xbytes * (2 if pw else 1)
    if not (pw and xbytes >= aux):
        off += aux
    stages = min(8, max(0, _SMEM_MAX - 1024 - 256 - off) // 16384)
    return off + stages * 16384 + 16 * stages + 16 + 1024, stages


def _fused_smem(dt, c: int, ch: int, co: int, pw: bool):
    """Shared memory of csrc/ffn_pair.cu's fused launch (bf16: at least
    two weight stages and outputs up to _MAX_OUT), or None where the
    widths cannot fit it."""
    if dt == torch.float32:                        # 16 rows, f32
        smem = 4 * 16 * (2 * ((c + 3) // 4 * 4) + (ch + 3) // 4 * 4)
        return smem if smem <= _SMEM_MAX else None
    smem, stages = _plan(c, pw)
    if co > _MAX_OUT or smem > _SMEM_MAX or stages < 2:
        return None
    return smem


def _smem_bytes(dt, c: int, ch: int, co: int, pw: bool) -> int:
    """Shared memory of csrc/ffn_pair.cu's fused launch; raises where the
    widths cannot fit it."""
    smem = _fused_smem(dt, c, ch, co, pw)
    if smem is None:
        raise ValueError(f"the fused ffn_pair tile cannot hold C={c}, "
                         f"hidden={ch}, out={co} ({dt}; outputs up to "
                         f"{_MAX_OUT} wide in bf16)")
    return smem


def wide_launches(c: int, ch: int, co: int, pw: bool, dwres: bool,
                  dt=torch.bfloat16) -> int:
    """Launches of one K2 call: 1 where the fused kernel holds the widths,
    else the wide path's stages (the dw residual, the pw stage, the two
    products)."""
    if _fused_smem(dt, c, ch, co, pw) is not None:
        return 1
    return 2 + int(pw) + int(dwres)


def _tma_rows(w):
    """w with rows padded by zeros to a multiple of 8 elements (16 bytes),
    as the bf16 kernel's tensor maps read them."""
    k = w.shape[1]
    return w if k % 8 == 0 else F.pad(w, (0, -k % 8))


def _ln_f32(x, g, b, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    return (xf - mean) * torch.rsqrt(var + eps) * g.float() + b.float()


def ffn_pair_plain(x, w1, b1, w2, b2, residual=True, wp=None, bp=None,
                   kw=None, kb=None, yres=None, db=None, ln=None,
                   add_res=False, gelu="erf"):
    """Port of ffn_pair_xla: exact math of the kernel. Weights (out, in)."""
    gelu_code(gelu)          # raises on an unknown variant
    act = GELUS[gelu]
    dt = x.dtype
    x_raw = x
    if ln is not None:
        x = _ln_f32(x, ln[0], ln[1]).to(dt)
    if yres is not None:
        x = act(x.float() + yres.float() + db.float()).to(dt)
    if wp is not None:
        p = x.float() @ wp.float().t()
        x = act(x.float() + p + bp.float()).to(dt)
    h = act(x.float() @ w1.float().t() + b1.float()).to(dt)
    y = h.float() @ w2.float().t() + b2.float()
    if residual:
        y = act(x.float() + y)
    if kw is not None:
        y = act(y + y * kw.float() + kb.float())
    if add_res:
        y = y + x_raw.float()
    return y.to(dt)


def _launch(x, w1, b1, w2, b2, residual, wp=None, bp=None, kw=None, kb=None,
            yres=None, db=None, ln_g=None, ln_b=None, add_res=False,
            gelu="erf"):
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
    if _fused_smem(dt, c, ch, co, wp is not None) is None:
        if ln_g is not None:
            raise ValueError(f"ln_ffn_pair takes the fused tile's widths "
                             f"only, got C={c}, hidden={ch}, out={co}")
        return _launch_wide(x, w1, b1, w2, b2, residual, wp, bp, kw, kb,
                            yres, db, gelu)
    if dt == torch.bfloat16:
        w1, w2 = _tma_rows(w1), _tma_rows(w2)
        wp = None if wp is None else _tma_rows(wp)
        if any(t.data_ptr() % 16 for t in (x, yres, w1, w2, wp)
               if t is not None):
            raise ValueError("ffn_pair needs 16-byte aligned x, y and "
                             "weights")
    out = torch.empty(*x.shape[:-1], co, dtype=dt, device=x.device)
    p = _build.ptr
    lib = _build.library()
    code = lib.sf_ffn_pair_v(
        p(x), p(yres), p(db), p(ln_g), p(ln_b), p(wp), p(bp), p(w1), p(b1),
        p(w2), p(b2), p(kw), p(kb), p(out), n, c, ch, co, int(residual),
        int(add_res), _build.dtype_code(dt), gelu_code(gelu),
        _build.stream_of(x))
    _build.check(code, "ffn_pair")
    LAUNCHES["ffn_pair"] += 1
    return out


def _launch_wide(x, w1, b1, w2, b2, residual, wp, bp, kw, kb, yres, db,
                 gelu):
    """The wide path: one launch per stage (csrc/ffn_pair.cu), each
    intermediate in device memory in the io type."""
    c = x.shape[-1]
    ch, co = w1.shape[0], w2.shape[0]
    n, dt = x.numel() // c, x.dtype
    if dt == torch.bfloat16 and (c % 8 or ch % 8 or co % 2):
        raise ValueError(f"the wide ffn_pair takes C and hidden multiples of "
                         f"8 and an even output, got C={c}, hidden={ch}, "
                         f"out={co}")
    if dt == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (x, w1, w2, wp) if t is not None):
        raise ValueError("ffn_pair needs 16-byte aligned x and weights")
    lib, p = _build.library(), _build.ptr
    code, stream = _build.dtype_code(dt), _build.stream_of(x)
    g = gelu_code(gelu)
    x2 = x.reshape(n, c)

    def gemm(a, w, bias, act=False, res=None, kwt=None, kbt=None):
        out = torch.empty(n, w.shape[0], dtype=dt, device=x.device)
        _build.check(lib.sf_ffn_gemm(
            p(a), p(w), p(bias), p(res), p(kwt), p(kbt), p(out), n,
            w.shape[0], w.shape[1], int(act), code, g, stream), "ffn_pair")
        LAUNCHES["ffn_pair"] += 1
        return out

    xs = x2
    if yres is not None:                 # x = gelu(x + y_dw + b_dw)
        xs = torch.empty_like(x2)
        _build.check(lib.sf_ffn_prologue(p(x2), p(yres), p(db), p(xs), n, c,
                                         code, g, stream), "ffn_pair")
        LAUNCHES["ffn_pair"] += 1
    if wp is not None:                   # x = gelu(x + x Wp + bp)
        xs = gemm(xs, wp, bp, res=xs)
    h = gemm(xs, w1, b1, act=True)
    y = gemm(h, w2, b2, res=xs if residual else None, kwt=kw, kbt=kb)
    return y.reshape(*x.shape[:-1], co)


def _run(x, w1, b1, w2, b2, residual, ln=None, **kw):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor;
    arguments as ``ffn_pair_plain``'s. No rows (an empty slab): no rows
    out, no launch."""
    if not x.numel():
        return x.new_empty(*x.shape[:-1], w2.shape[0])
    if not x.is_cuda:
        return ffn_pair_plain(x, w1, b1, w2, b2, residual, ln=ln, **kw)
    if ln is not None:
        kw.update(ln_g=ln[0], ln_b=ln[1])
    return _launch(x, w1, b1, w2, b2, residual, **kw)


def ffn_pair(x, w1, b1, w2, b2, residual=True, gelu="erf"):
    """[gelu(x +)] gelu(x W1 + b1) W2 + b2."""
    def call(fn):
        return lambda x, w1, b1, w2, b2: fn(x, w1, b1, w2, b2, residual,
                                            gelu=gelu)
    return with_composite_vjp(call(_run), call(ffn_pair_plain),
                              x, w1, b1, w2, b2)


def pw_ffn_pair(x, wp, bp, w1, b1, w2, b2, residual=False, gelu="erf"):
    """x' = gelu(x + x Wp + bp); out = [gelu(x' +)] gelu(x' W1 + b1) W2 +
    b2."""
    def call(fn):
        return lambda x, wp, bp, w1, b1, w2, b2: fn(
            x, w1, b1, w2, b2, residual, wp=wp, bp=bp, gelu=gelu)
    return with_composite_vjp(call(_run), call(ffn_pair_plain),
                              x, wp, bp, w1, b1, w2, b2)


def ffn_pair_k1(x, w1, b1, w2, b2, kw, kb, gelu="erf"):
    """gelu(y + y*kw + kb) of y = gelu(x + gelu(x W1 + b1) W2 + b2)."""
    def call(fn):
        return lambda x, w1, b1, w2, b2, kw, kb: fn(
            x, w1, b1, w2, b2, True, kw=kw, kb=kb, gelu=gelu)
    return with_composite_vjp(call(_run), call(ffn_pair_plain),
                              x, w1, b1, w2, b2, kw, kb)


def dwres_pw_ffn_pair(x, y, db, wp, bp, w1, b1, w2, b2, gelu="erf"):
    """x' = gelu(x + y + db); x'' = gelu(x' + x' Wp + bp);
    out = gelu(x'' W1 + b1) W2 + b2."""
    def call(fn):
        return lambda x, y, db, wp, bp, w1, b1, w2, b2: fn(
            x, w1, b1, w2, b2, False, wp=wp, bp=bp, yres=y, db=db,
            gelu=gelu)
    return with_composite_vjp(call(_run), call(ffn_pair_plain),
                              x, y, db, wp, bp, w1, b1, w2, b2)


def ln_ffn_pair(x, g, be, w1, b1, w2, b2, add_res=True, gelu="erf"):
    """[x +] gelu(LN(x) W1 + b1) W2 + b2, LN with f32 stats, eps 1e-5."""
    def call(fn):
        return lambda x, g, be, w1, b1, w2, b2: fn(
            x, w1, b1, w2, b2, False, ln=(g, be), add_res=add_res,
            gelu=gelu)
    return with_composite_vjp(call(_run), call(ffn_pair_plain),
                              x, g, be, w1, b1, w2, b2)
