"""K1 (the correlation lookup), K2 (the fused FFN pair), B5 (the
flash-attention backward) and the SK blocks' depthwise kernels K5 (the
chain), K6 and K7 (the banded conv) and K8 (the banded chain) on one GPU
at the main path's shapes: each bf16 call checked against its plain version,
timed with CUDA events beside its bound and a yardstick, and optionally
against the kernels of another checkout of the repository, built from
that tree's ``streamflow_tpu_torch/csrc`` and timed in turns (others,
this, this, others in reverse) in the same process, as ``attn_bench``
does for K3 and K4.

    python -m streamflow_tpu_torch.tools.kernel_bench [--other DIR ...]
        [--reps N] [--kernels k1,k2,b5,k5,k6,k7,k8]

``--kernels`` picks the sections (default all) and compiles only their
sources, in every tree: ``--kernels k8`` builds ``dw_banded.cu`` alone
and takes seconds of the card after the build; ``--kernels k7`` builds
``dw_banded.cu`` and ``dw_banded_t.cu`` (another tree's K7 is whatever
its ``sf_dw_banded_mxu_t`` launches: in a checkout from before
``dw_banded_t.cu``, the first design's slab body in ``dw_banded.cu``).

K1's calls are those of one 440x1024 clip (12, one per refinement
iteration, on the 3 frame pairs at 55x128, C=256, 4 levels, radius 4) and
of one 432x960 train step (24 at 54x120), each under three traffics
reported apart: ``smooth`` (a seeded low-frequency flow of tens of px, as
real footage gives), ``jitter30`` (``chip_smoke.py``'s +-30 px per-pixel
case with its far-out rows) and ``uniform`` (every coordinate uniform over
the frame: each tile's box is the whole level, the worst case). Its bound
is bytes (f1, the pyramid and coords read once, the output written once);
no single library call computes it, so it has no yardstick.

K2's calls are those of one 440x1024 clip and of one 432x960 train step
(the refinement blocks twice, for remat) in the default SK layout
(``ffn_pair_k1``, ``dwres_pw_ffn_pair``) and in the pair layouts
(``ffn_pair``, ``pw_ffn_pair``), with the Twins ``ln_ffn_pair`` in both.
Its yardstick is the library composite: the same stages as bf16 PyTorch
ops (``F.linear``, ``F.gelu``, ``F.layer_norm``), the hidden activation
through device memory; the port never calls it. B5's calls are the train
step's (GMA and the four GSA blocks at 432x960); its yardstick is SDPA's
backward.

K5's and K8's calls are the six SK blocks' dw stacks, ks (1, 15) and the
gru's (1, 7), on (B, H/8, W/8, C): 12 per block per 440x1024 clip
(3x55x128, the flow head 1x55x128x384) and 24 per 432x960 step
(3x54x120); K6's and K7's are their kxk stages alone, ks (15,) and (7,).
Beside K5, K6 and K8: the default layout's cuDNN depthwise conv of the
same tensor, copies included, as ``chip_smoke.py`` times it beside K5 and
K8. Beside K7: the engine's K6 of this tree (the same function behind the
same launcher interface) and K7's library call as ``chip_smoke.py`` times
it, cuDNN's bf16 depthwise conv + bias on the channels-last view, one
call. The bound is bytes: x, the weights and biases read once, the output
written once.
Another checkout whose K6 or K8 still takes the padded C-major operand
(before NHWC) is timed as its wrapper runs it, pad and permute copies
included, and its kernel alone apart.

One JSON object per case on stdout, then per-clip and per-step sums;
exits non-zero when a kernel disagrees with its plain version. Needs a
GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.coords import coords_grid
from streamflow_tpu_torch.ops.corr import pool_pyramid
from streamflow_tpu_torch.ops.kernels import corr_lookup as K1
from streamflow_tpu_torch.ops.kernels import dw_banded as K8
from streamflow_tpu_torch.ops.kernels import dw_chain as K5
from streamflow_tpu_torch.ops.kernels import ffn_pair as K2
from streamflow_tpu_torch.ops.kernels import flash_attention as K3
from streamflow_tpu_torch.tools.attn_bench import (HBM, PEAK_BF16, T, timed,
                                                   ulp_check)

# the six SK blocks (c_in, out of the second pair, frame pairs): convc1,
# convc2, convf2, conv, gru, flow head
SK = [(324, 256, 3), (256, 192, 3), (128, 64, 3), (256, 126, 3),
      (640, 128, 3), (384, 6, 1)]
# the SK blocks' dw conv sizes (the k of their dw stack (1, k))
DW_K = (15, 15, 15, 15, 7, 15)
# kernel_bench sections and the csrc sources each needs
SECTIONS = {"k1": ("corr_lookup",), "k2": ("ffn_pair",),
            "b5": ("flash_attn_bwd",), "k5": ("dw_chain", "dw_banded"),
            "k6": ("dw_banded",), "k7": ("dw_banded", "dw_banded_t"),
            "k8": ("dw_banded",)}
# the dw sections: the kernel's name and the SK layout that runs it
DW = {"k5": ("dw_chain", "pallas"), "k6": ("dw_banded_mxu", "banded_mxu"),
      "k7": ("dw_banded_mxu_t", "banded_mxu_t"),
      "k8": ("sk_chain_banded", "banded_chain")}
# which SK layouts run each K2 form
LAYOUTS = {"ffn_pair_k1": ("default",), "dwres_pw_ffn_pair": ("default",),
           "ffn_pair": ("pair",), "pw_ffn_pair": ("pair",),
           "ln_ffn_pair": ("default", "pair")}


TRAFFICS = ("smooth", "jitter30", "uniform")


def corr_cases(hp, wp, train):
    """(traffic, pairs, h, w, c, levels, radius, calls per clip or step) of
    K1: one call per refinement iteration (twice per step, for remat) on
    the B*(T-1) = 3 frame pairs at 1/8 of the padded frame."""
    return [(traffic, T - 1, hp // 8, wp // 8, 256, 4, 4, 24 if train else 12)
            for traffic in TRAFFICS]


def corr_bytes(pairs, h, w, c, levels, radius, itemsize=2):
    """Bytes a K1 call must move: f1, the pooled pyramid (VALID 2x2 pools)
    and the f32 coords read once, the output written once."""
    n, pyramid, hl, wl = h * w, 0, h, w
    for _ in range(levels):
        pyramid += hl * wl
        hl, wl = hl // 2, wl // 2
    k = 2 * radius + 1
    return pairs * (itemsize * c * (n + pyramid) + 8 * n
                    + itemsize * n * levels * k * k)


def corr_coords(traffic, pairs, h, w, gen, dev):
    """Seeded level-0 pixel coordinates (x, y), (pairs, h, w, 2) f32."""
    grid = coords_grid(pairs, h, w, dev)
    if traffic == "smooth":
        # a 3x4 field of N(0, 20^2) px displacements, bilinearly upsampled
        coarse = 20.0 * torch.randn(pairs, 2, 3, 4, generator=gen, device=dev)
        flow = F.interpolate(coarse, size=(h, w), mode="bilinear",
                             align_corners=True)
        return (grid + flow.permute(0, 2, 3, 1)).contiguous()
    if traffic == "uniform":
        u = torch.rand(pairs, h, w, 2, generator=gen, device=dev)
        return (u * torch.tensor([w, h], device=dev)).contiguous()
    coords = grid + 30.0 * (
        2 * torch.rand(pairs, h, w, 2, generator=gen, device=dev) - 1)
    coords[0, :4] = torch.tensor([1e4, -1e4], device=dev)  # far out
    coords[1:2, :2] = torch.tensor([-20.0, 70.0], device=dev)
    return coords.contiguous()


def corr_flops(coords, shapes, c, radius):
    """FLOPs of the taps these coords need (those inside each level): a
    C-long dot product per tap of the (2r+2)^2 window."""
    offs = torch.arange(-radius, radius + 2, device=coords.device)
    taps = 0
    for lvl, (hl, wl) in enumerate(shapes):
        ctr = torch.floor(coords.clamp(-1e6, 1e6) / 2 ** lvl)
        nx = ((ctr[..., 0, None] + offs >= 0)
              & (ctr[..., 0, None] + offs <= wl - 1)).sum(-1)
        ny = ((ctr[..., 1, None] + offs >= 0)
              & (ctr[..., 1, None] + offs <= hl - 1)).sum(-1)
        taps += int((nx * ny).sum())
    return 2 * c * taps


def ffn_cases(hp, wp, train):
    """(form, rows, c, hidden, out, calls per clip or step) of K2."""
    h8, w8 = hp // 8, wp // 8
    refine = 24 if train else 12
    cases = []
    for c, co, pairs in SK:
        ch, rows = int(1.5 * c), pairs * h8 * w8
        cases += [("ffn_pair_k1", rows, c, ch, c, refine),
                  ("dwres_pw_ffn_pair", rows, c, ch, co, refine),
                  ("ffn_pair", rows, c, ch, c, refine),
                  ("pw_ffn_pair", rows, c, ch, co, refine)]
    for c, rows in ((128, T * 4 * h8 * w8), (128, (T - 1) * 4 * h8 * w8),
                    (256, T * h8 * w8), (256, (T - 1) * h8 * w8)):
        cases.append(("ln_ffn_pair", rows, c, 4 * c, c, 2))
    return cases


def ffn_inputs(form, rows, c, ch, co, rnd):
    """The kernel's arguments by name, bf16, seeded."""
    def w(i, o):
        return rnd(o, i, scale=i ** -0.5)

    def b(n):
        return rnd(n, scale=0.1)
    a = {"x": rnd(rows, c), "w1": w(c, ch), "b1": b(ch), "w2": w(ch, co),
         "b2": b(co)}
    if form in ("pw_ffn_pair", "dwres_pw_ffn_pair"):
        a.update(wp=w(c, c), bp=b(c))
    if form == "dwres_pw_ffn_pair":
        a.update(yres=rnd(rows, c), db=b(c))
    if form == "ffn_pair_k1":
        a.update(kw=rnd(co, scale=0.3), kb=b(co))
    if form == "ln_ffn_pair":
        a.update(ln_g=1.0 + rnd(c, scale=0.1), ln_b=b(c))
    return a


def ffn_flags(form):
    """(residual, add_res) of a form."""
    return form in ("ffn_pair", "ffn_pair_k1"), form == "ln_ffn_pair"


def ffn_plain(form, a):
    residual, add_res = ffn_flags(form)
    ln = (a["ln_g"], a["ln_b"]) if "ln_g" in a else None
    return K2.ffn_pair_plain(a["x"], a["w1"], a["b1"], a["w2"], a["b2"],
                             residual, wp=a.get("wp"), bp=a.get("bp"),
                             kw=a.get("kw"), kb=a.get("kb"),
                             yres=a.get("yres"), db=a.get("db"), ln=ln,
                             add_res=add_res)


def ffn_composite(form, a):
    """The library composite of a K2 form: bf16 PyTorch ops, each rounding
    its own output, the hidden activation through device memory (a
    yardstick, not a reference)."""
    x = a["x"]
    if "ln_g" in a:
        x = F.layer_norm(x, x.shape[-1:], a["ln_g"], a["ln_b"])
    if "yres" in a:
        x = F.gelu(x + a["yres"] + a["db"])
    if "wp" in a:
        x = F.gelu(x + F.linear(x, a["wp"], a["bp"]))
    y = F.linear(F.gelu(F.linear(x, a["w1"], a["b1"])), a["w2"], a["b2"])
    residual, add_res = ffn_flags(form)
    if residual:
        y = F.gelu(x + y)
    if "kw" in a:
        y = F.gelu(y + y * a["kw"] + a["kb"])
    return y + a["x"] if add_res else y


def ffn_flops(form, rows, c, ch, co):
    pw = form in ("pw_ffn_pair", "dwres_pw_ffn_pair")
    return 2 * rows * (c * ch + ch * co + (c * c if pw else 0))


def chain_cases(hp, wp, train, stack=True):
    """(nb, h, w, c, ks, calls per clip or step) of K5 and K8: each SK
    block's dw stack once per refinement iteration (twice per step, for
    remat); of K6 and K7 (``stack=False``): its kxk stage alone, ks
    (k,)."""
    refine = 24 if train else 12
    return [(pairs, hp // 8, wp // 8, c, (1, k) if stack else (k,), refine)
            for (c, _, pairs), k in zip(SK, DW_K)]


def chain_bytes(nb, h, w, c, ks, itemsize=2):
    """Bytes a K5-K8 call must move: x, the weights and the biases
    read once, the output written once."""
    return itemsize * (2 * nb * h * w * c + sum(c * k * k + c for k in ks))


def nhwc_chain(root, kernel="k8"):
    """Whether the K8 (or K6) launcher of the checkout at ``root`` reads x
    as NHWC (else the padded C-major operand of the first version)."""
    wrapper = root / "streamflow_tpu_torch/ops/kernels/dw_banded.py"
    call = {"k6": "_operand(x, w, b)", "k8": "_operand(x, weights[-1]"}
    return call[kernel] not in wrapper.read_text()


def bwd_cases(hp, wp):
    """(label, bh shape, n, m, d, calls per train step) of B5."""
    h8, w8 = hp // 8, wp // 8
    cases = [("gma", (3, 1), h8 * w8, h8 * w8, 128, 12)]
    for stage, nh, sr, hh, ww in ((0, 4, 8, 2 * h8, 2 * w8),
                                  (1, 8, 4, h8, w8)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            cases.append((f"gsa{stage} {enc}", (1, nh), t * hh * ww,
                          (t * hh // sr) * (ww // sr), 32, 1))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="root of another checkout whose kernels to time "
                         "beside this tree's (repeatable; named by its "
                         "directory)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default=",".join(SECTIONS),
                    help="comma-separated sections to run, of "
                         + ", ".join(SECTIONS))
    args = ap.parse_args()
    run_sec = args.kernels.split(",")
    if not set(run_sec) <= set(SECTIONS):
        raise SystemExit(f"kernel_bench: --kernels takes {list(SECTIONS)}")
    only = None if set(run_sec) == set(SECTIONS) else sorted(
        {s for k in run_sec for s in SECTIONS[k]})
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    # per library: (ctypes library, whether its K2 reads weight rows padded
    # to 16 bytes, as this tree's wrapper hands them, which of K6 and K8
    # read NHWC)
    libs = {"this": (_build.library() if only is None else _build.build(
        _build._CSRC, _build._BUILD, only), True, {"k5", "k6", "k7", "k8"})}
    for other in args.other:
        root = other.resolve()
        wrapper = root / "streamflow_tpu_torch/ops/kernels/ffn_pair.py"
        libs[root.name] = (
            _build.build(root / "streamflow_tpu_torch" / "csrc",
                         root / "build" / "kernel_bench", only),
            "_tma_rows" in wrapper.read_text(),
            {"k5", "k7"} | {k for k in ("k6", "k8")
                            if nhwc_chain(root, k)})
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "others": [str(o) for o in args.other]}), flush=True)
    print(_build.ptxas_summary(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _build.ptr

    def rnd(*shape, scale=1.0, dt=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dt)

    ok = True
    sums = {}

    def record(key, row, calls, flops, nbytes, run, outs, want, asides,
               clear=None):
        """``run(name)`` launches the kernel of library ``name`` into
        ``outs``; ``clear()`` zeroes them before a checked call;
        ``asides`` maps a name to a call timed beside the kernel (its
        yardstick, another kernel at the same shape)."""
        nonlocal ok
        for name in libs:
            if clear:
                clear()
            run(name)
            torch.cuda.synchronize()
            # B5's f32 sums seen as the wrapper rounds them
            errs = [ulp_check(a.to(b.dtype), b) for a, b in zip(outs, want)]
            row[f"ok_{name}"] = all(e[0] for e in errs)
            row[f"max_abs_err_{name}"] = max(e[1] for e in errs)
        ok &= row["ok_this"]
        t_mem, t_ops = 1e3 * nbytes / HBM, 1e3 * flops / PEAK_BF16
        row["bound_ms"] = max(t_mem, t_ops)
        row["bound_by"] = "operations" if t_ops >= t_mem else "bytes"
        others = [name for name in libs if name != "this"]
        times = {}
        for name in others + ["this", "this"] + others[::-1]:
            times.setdefault(name, []).append(
                timed(lambda: run(name), args.reps))
        for name, ts in times.items():
            row[f"ms_{name}"] = ts
            row[f"tflops_{name}"] = flops / min(ts) / 1e9
        for name, fn in asides.items():
            row[f"{name}_ms"] = timed(fn, args.reps)
        print(json.dumps(row), flush=True)
        for k in key:
            s = sums.setdefault(k, {})
            for name, ts in times.items():
                s[name] = s.get(name, 0.0) + calls * min(ts)
            for name in ("bound", *asides):
                s[name] = s.get(name, 0.0) + calls * row[f"{name}_ms"]

    def ffn(path, form, rows, c, ch, co, calls):
        a = ffn_inputs(form, rows, c, ch, co, rnd)
        residual, add_res = ffn_flags(form)
        padded = {k: K2._tma_rows(a[k]) for k in ("w1", "w2", "wp")
                  if k in a}
        out = torch.empty(rows, co, dtype=torch.bfloat16, device=dev)

        def run(name):
            lib, pad, _ = libs[name]
            w = {**a, **padded} if pad else a
            _build.check(lib.sf_ffn_pair(
                p(w["x"]), p(w.get("yres")), p(w.get("db")),
                p(w.get("ln_g")), p(w.get("ln_b")), p(w.get("wp")),
                p(w.get("bp")), p(w["w1"]), p(w["b1"]), p(w["w2"]),
                p(w["b2"]), p(w.get("kw")), p(w.get("kb")), p(out), rows, c,
                ch, co, int(residual), int(add_res), 1, stream), "ffn_pair")
        key = [("ffn_pair", path, lt) for lt in LAYOUTS[form]]
        record(key, {"kernel": "ffn_pair", "path": path, "form": form,
                     "case": f"{rows}x{c}-{ch}-{co}", "calls": calls},
               calls, ffn_flops(form, rows, c, ch, co),
               2 * (sum(t.numel() for t in a.values()) + out.numel()),
               run, [out], [ffn_plain(form, a)],
               {"yardstick": lambda: ffn_composite(form, a)})

    def bwd(label, bh_shape, n, m, d, calls):
        q = rnd(*bh_shape, n, d, scale=d ** -0.5)
        k, v, do = rnd(*bh_shape, m, d), rnd(*bh_shape, m, d), rnd(
            *bh_shape, n, d)
        o, lse = K3.flash_attention_plain(q, k, v, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        outs = [torch.zeros(t.shape, device=dev) for t in (q, k, v)]
        bh = math.prod(bh_shape)

        def run(name):
            _build.check(libs[name][0].sf_flash_bwd(
                p(q), p(k), p(v), p(do), p(lse), p(delta), *map(p, outs),
                bh, n, m, d, 1, stream), "flash_attention_bwd")

        def clear():
            for t in outs:
                t.zero_()
        want = K3.flash_attention_bwd_plain(q, k, v, do, lse, delta)
        qs, ks, vs = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        ref = F.scaled_dot_product_attention(qs, ks, vs, scale=1.0)
        record([("flash_attention_bwd", "step", "all")],
               {"kernel": "flash_attention_bwd", "path": "step",
                "case": f"{label} bh{bh} n{n} m{m} d{d}", "calls": calls},
               calls, 10 * bh * n * m * d,
               2 * (3 * q.numel() + 3 * k.numel()) + 8 * bh * n,
               run, outs, want,
               {"yardstick": lambda: torch.autograd.grad(
                   ref, (qs, ks, vs), do, retain_graph=True)}, clear)
        del ref

    def corr(path, traffic, pairs, h, w, c, levels, radius, calls):
        f1 = rnd(pairs, h, w, c)
        lv = [t.contiguous() for t in pool_pyramid(rnd(pairs, h, w, c),
                                                   levels)]
        coords = corr_coords(traffic, pairs, h, w, g, dev)
        shapes = [(t.shape[1], t.shape[2]) for t in lv]
        k = 2 * radius + 1
        out = torch.empty(pairs, h, w, levels * k * k, dtype=torch.bfloat16,
                          device=dev)
        ptrs = [p(t) for t in lv] + [None] * (K1.MAX_LEVELS - levels)
        dims = [d for s in shapes for d in s] + [0, 0] * (K1.MAX_LEVELS
                                                          - levels)

        def run(name):
            _build.check(libs[name][0].sf_corr_lookup(
                p(f1), *ptrs, p(coords), p(out), pairs, h * w, c, levels,
                *dims, radius, 1, 1.0 / math.sqrt(c), stream), "corr_lookup")
        record([("corr_lookup", path, traffic)],
               {"kernel": "corr_lookup", "path": path, "traffic": traffic,
                "case": f"{pairs}x{h}x{w}x{c} {levels} levels r{radius}",
                "calls": calls},
               calls, corr_flops(coords, shapes, c, radius),
               corr_bytes(pairs, h, w, c, levels, radius), run, [out],
               [K1.corr_lookup_plain(f1, lv, coords, radius)], {})

    def dw(sec, path, nb, h, w, c, ks, calls):
        """K5, K6, K7 or K8 (``sec``) at one SK block's shape; ks (1, k),
        K6's and K7's (k,)."""
        k, name = ks[-1], DW[sec][0]
        x = rnd(nb, h, w, c)
        ws = (rnd(c, 1, 1, 1, scale=0.3), rnd(c, 1, k, k, scale=1 / k))
        bs = (rnd(c, scale=0.1), rnd(c, scale=0.1))
        ws, bs = ws[-len(ks):], bs[-len(ks):]
        out, out6 = torch.empty_like(x), torch.empty_like(x)

        def launch(lib, xin, o):
            if sec in ("k6", "k7"):
                code = getattr(lib, "sf_" + name)(
                    p(xin), p(ws[0]), p(bs[0]), p(o), nb, h, w, c, k, 1,
                    stream)
            else:   # sf_dw_chain and sf_sk_chain_banded take one form
                code = getattr(lib, "sf_" + name)(
                    p(xin), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(o), nb,
                    h, w, c, 1, k, 1, stream)
            _build.check(code, name)

        def cmajor():
            # the first version's operand and output, as its wrapper made
            # them: x zero-padded and C-major, (C, B, W, H) out
            r = k // 2
            lhs = x.new_zeros((c, nb, w + 2 * r, h + 2 * r))
            lhs[:, :, r:r + w, r:r + h] = x.permute(3, 0, 2, 1)
            return lhs, x.new_empty((c, nb, w, h))

        def run(lib_name):
            lib, _, nhwc = libs[lib_name]
            if sec in nhwc:
                launch(lib, x, out)
            else:
                lhs, o = cmajor()
                launch(lib, lhs, o)
                out.copy_(o.permute(1, 3, 2, 0))

        def conv():
            # the default layout's conv of the same tensor, copies
            # included (chip_smoke.py's cuDNN yardstick of K5 and K8)
            y = x.permute(0, 3, 1, 2)
            y = y.contiguous() if k > 7 else y
            y = F.conv2d(y, ws[-1], None, 1, k // 2, 1, c)
            return y.permute(0, 2, 3, 1).contiguous()
        if sec == "k7":
            # the engine's K6 of this tree, and K7's library call
            asides = {"k6": lambda: _build.check(
                libs["this"][0].sf_dw_banded_mxu(
                    p(x), p(ws[0]), p(bs[0]), p(out6), nb, h, w, c, k, 1,
                    stream), "dw_banded_mxu"),
                "library": lambda: F.conv2d(x.permute(0, 3, 1, 2), ws[0],
                                            bs[0], 1, k // 2, 1, c)}
        else:
            asides = {"cudnn": conv}
        for lib_name, (lib, _, nhwc) in libs.items():
            if sec not in nhwc:   # the first version's kernel, no copies
                lhs, o = cmajor()
                asides[f"{lib_name}_kernel_only"] = (
                    lambda lib=lib, lhs=lhs, o=o: launch(lib, lhs, o))
        if sec in ("k6", "k7"):
            want = K8.dw_banded_mxu_plain(x, ws[0], bs[0])
        else:
            plain = K5.dw_chain_plain if sec == "k5" else (
                K8.sk_chain_banded_plain)
            want = plain(x, ws, bs, ks)
        record([(name, path, DW[sec][1])],
               {"kernel": name, "path": path,
                "case": f"{nb}x{h}x{w}x{c} ks {ks}", "calls": calls},
               calls, 2 * k * k * x.numel() + 3 * (len(ks) - 1) * x.numel(),
               chain_bytes(nb, h, w, c, ks), run, [out], [want], asides)

    for path, (hp, wp, train) in (("clip", (440, 1024, False)),
                                  ("step", (432, 960, True))):
        if "k1" in run_sec:
            for case in corr_cases(hp, wp, train):
                corr(path, *case)
        if "k2" in run_sec:
            for case in ffn_cases(hp, wp, train):
                ffn(path, *case)
        for sec in DW:
            if sec in run_sec:
                for case in chain_cases(hp, wp, train,
                                        sec not in ("k6", "k7")):
                    dw(sec, path, *case)
        torch.cuda.empty_cache()
    if "b5" in run_sec:
        for case in bwd_cases(432, 960):
            bwd(*case)
            torch.cuda.empty_cache()
    for (kernel, path, layout), s in sums.items():
        # layout: K2's SK layout, K1's traffic, "all" for B5
        print(json.dumps({"sum": kernel, "per": path, "layout": layout, **{
            f"{k}_ms": v for k, v in s.items()}}), flush=True)
    print(json.dumps({"ok": ok, "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
