#!/usr/bin/env python3
"""Smoke test of streamflow_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py      (from the root of a checkout, one GPU)

Phases, each printed on its own line; any failure raises (exit code != 0):
  1. device check (CUDA required; card name and power limit; TF32 off);
  2. kernel build (nvcc, from csrc/, into build/streamflow_tpu_torch/);
  3. every kernel against its plain PyTorch version, on the card, at the
     main path's shapes, in f32 and bf16, with times from CUDA events:
     the default SK layout's K2 forms, the pair layouts' (K2 ffn_pair and
     pw_ffn_pair), K5 dw_chain (dw_impl='pallas', with the cuDNN depthwise
     conv of the default layout timed beside it), K6 dw_banded_mxu and K7
     dw_banded_mxu_t (with cuDNN's bf16 depthwise conv as their library
     yardstick) and K8 sk_chain_banded (cuDNN's conv beside it, as K5);
     K1 under three traffics (chip_smoke's +-30 px jitter, a smooth flow
     field, coordinates uniform over the frame; tools/kernel_bench.py
     makes the last two), each timed, and checked at the branches of its
     bf16 body (empty, mixed and multi-plane tiles at ragged sizes, C =
     32, 96, 128 and 512, fewer levels, a smaller radius, a level of size
     zero), K3 and K4 also at the tails of their tiles (one query row,
     fewer keys than a tile, one-window grids of two images), K2 at ragged row
     counts (1, 65, 21121) in all five forms at every width of the path,
     each K2 call timed beside its library composite (bf16 torch ops, the
     hidden activation through device memory: a yardstick, not a
     library_ms), and every timed case with its achieved TFLOP/s and GB/s;
  4. the full forward: StreamFlow, seeded random weights, 436x1024 padded
     to 440x1024, B=1, T=4, 12 iterations, bf16, test mode; launch counts
     of every kernel checked exactly; ms/clip, frames/s, peak memory; a
     torch.profiler breakdown of one forward (table in chiprun_out/);
  5. accuracy guards: the same clip at iters=1 through the kernel path on
     the card and the plain path on the CPU, in f32 and in bf16, relative
     EPE against the f32 plain path bounded (that f32 reference is the
     same function in every layout: computed once, reused by 10, 14, ...);
  6. the training path's kernels at its own shapes (432x960): every
     forward kernel against its plain version as in phase 3 (K3 with its
     logsumexp), B5 against its plain version (also at the tails of its
     tiles: one query row, fewer keys than a tile, ragged counts at d=128
     and d=32), and each kernel wrapper's forward and gradient against its
     plain version;
  7. the train step: seeded weights and batch, 432x960, T=4, 12
     iterations, bf16 compute with f32 parameters, remat, AdamW; launch
     counts checked exactly; ms/step, peak memory, every parameter moves,
     a torch.profiler breakdown of one step;
  8. training guard: one step's loss and gradients at 128x256 through the
     kernel path on the card against the plain path on the CPU;
  9-24. the other SK layouts (StreamFlowConfig.dw_impl), at the same sizes
     and depths: phases 4, 5, 7 and 8 again for 'pallas' (9-12: K2
     ffn_pair, K5 dw_chain, K2 pw_ffn_pair), 'banded_mxu' (13-16: K6 in
     place of K5) and 'banded_chain' (17-20: K8), phases 4 and 5 for
     'banded_mxu_t' (21-22: K7) and 'banded' (23-24: the banded composite,
     no dw kernel).
The line before the kernels line gives ms/clip for the six layouts. The
line before the last is a JSON object with one entry per kernel and path
("inference": phases 3-4, per clip; "train_step": phases 6-7, per step;
"inference_dw_<layout>" and "train_step_dw_<layout>": the same for each
other layout, phases 3, 6 and that layout's forward and train step):
"launches" is the path's count, "ms", "plain_ms", "bound_ms" and
"library_ms" are summed over the same calls at the path's shapes (K1's
under the jitter traffic; its "ms_by_traffic" gives all three). The
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

B, T, H, W = 1, 4, 436, 1024
ITERS = 12
SEED = 0
REPS = 5  # timed repetitions, after warm-up

# Tolerances of the kernel-vs-plain checks, elementwise.
# f32: |kernel - plain| <= 1e-4 + 1e-4 |plain|. Both sides accumulate in
# f32 in different orders (reductions of up to 1024 terms, O(1) values): a
# few 1e-6 relative (at most 2.4e-6 read on an H100); 1e-4 leaves margin.
# bf16: |kernel - plain| <= 2 ulp(plain) + 2^-9 max|plain|, ulp() the bf16
# spacing at that value. Both sides round to bf16 at the same points, so an
# output differs only where the two f32 sums straddle a rounding boundary:
# one ulp of that element (every bf16 reading on an H100 so far is at most
# one ulp of the output's largest magnitude). The 2^-9 max|plain| term
# covers a flipped intermediate reaching an output near zero. A wrong tile,
# mask or rounding point is many ulps.
F32_TOL = 1e-4
BF16_ULPS, BF16_FLOOR = 2, 2.0 ** -9

# Accuracy guards (phase 5), on the global relative EPE (max EPE /
# max(1, max |flow_ref|), as bench.py) and the per-pixel p99 of EPE /
# max(1, |flow_ref|); the reference is the f32 plain path on the CPU.
# f32 kernels on the card: both paths run the same math and differ only by
# summation order (1.6e-5 read on an H100); a wrong window, channel order
# or mask is O(1). Bound 1e-2 outright.
# bf16 kernels on the card: bf16 rounding alone moves these random-weight
# flows by up to ~9% (the bf16 plain path on the CPU reads 9.4e-2 global
# against f32 on an H100's host, and differs from the kernel path by as
# much), so bf16 is held to the plain bf16 path: its error against the
# f32 reference may exceed the plain path's by at most 1.5x. A kernel
# fault adds its own O(1) error on top.
F32_GUARD_TOL = 1e-2
BF16_GUARD_RATIO = 1.5

# Random weights make a feedback loop through the flow input of the motion
# encoder: at the fan-in scale the flows grow ~2.7x per iteration, to
# ~1e8 px after 12, where K1's windows all fall out of range. The flow
# head's output layer is scaled down so that the 12-iteration flows stay
# in the range of real footage (tens of px, a few hundred at most).
FLOW_HEAD_SCALE = 2e-3

KERNELS = {
    "corr_lookup": ("streamflow_tpu_torch/csrc/corr_lookup.cu",
                    "streamflow_tpu/ops/pallas/_fused_lookup_kernel.py:325"),
    "ffn_pair": ("streamflow_tpu_torch/csrc/ffn_pair.cu",
                 "streamflow_tpu/ops/pallas/_ffn_kernel.py:304"),
    "flash_attention": ("streamflow_tpu_torch/csrc/flash_attn.cu",
                        "streamflow_tpu/ops/pallas/_attention_kernel.py:176"),
    "flash_attention_bwd": (
        "streamflow_tpu_torch/csrc/flash_attn_bwd.cu",
        "streamflow_tpu/ops/pallas/_attention_kernel.py:327"),
    "lga_attention": ("streamflow_tpu_torch/csrc/lga_attn.cu",
                      "streamflow_tpu/ops/pallas/_lga_kernel.py:116"),
    "dw_chain": ("streamflow_tpu_torch/csrc/dw_chain.cu",
                 "streamflow_tpu/ops/pallas/_dw_conv_kernel.py:170"),
    "dw_banded_mxu": ("streamflow_tpu_torch/csrc/dw_banded.cu",
                      "streamflow_tpu/ops/pallas/_banded_dw_kernel.py:122"),
    "dw_banded_mxu_t": ("streamflow_tpu_torch/csrc/dw_banded.cu",
                        "streamflow_tpu/ops/pallas/_banded_dw_kernel.py:223"),
    "sk_chain_banded": ("streamflow_tpu_torch/csrc/dw_banded.cu",
                        "streamflow_tpu/ops/pallas/_banded_dw_kernel.py:343"),
}
# launches of each kernel in one 12-iteration forward: K1 once per
# iteration; K2 2 per SK block (6 blocks) per iteration + 8 Twins MLPs;
# K3 12 GMA + 4 GSA; K4 2 LGA blocks in each of fnet and cnet
EXPECTED_LAUNCHES = dict(dict.fromkeys(KERNELS, 0), corr_lookup=ITERS,
                         ffn_pair=12 * ITERS + 8, flash_attention=ITERS + 4,
                         lga_attention=4)
# launches in one train step with remat: the refinement kernels run in the
# forward and again in each step's recompute (K1 2x12, K2 2x144 + the 8 of
# the encoders, K3 2x12 GMA + 4 GSA), K4 once; B5's two kernels (dq pass,
# dk/dv pass) once per K3 forward that the loss reaches (12 GMA + 4 GSA)
EXPECTED_TRAIN_LAUNCHES = dict(EXPECTED_LAUNCHES,
                               corr_lookup=2 * ITERS,
                               ffn_pair=2 * 12 * ITERS + 8,
                               flash_attention=2 * ITERS + 4,
                               flash_attention_bwd=2 * (ITERS + 4))


def pair_layout(suffix, dw_kernel=None):
    """A pair layout: each SK block runs K2 twice (ffn_pair, pw_ffn_pair)
    in place of the default's two K2 forms, and its dw stack through
    ``dw_kernel`` once (the kxk stage; k=1 stages and gelus are elementwise
    or inside it), or through no kernel ('banded', the XLA composite)."""
    dw = {dw_kernel: 6} if dw_kernel else {}
    return (suffix,
            dict(EXPECTED_LAUNCHES, **{k: n * ITERS for k, n in dw.items()}),
            dict(EXPECTED_TRAIN_LAUNCHES,
                 **{k: 2 * n * ITERS for k, n in dw.items()}))


# per SK layout (the port's dw_impl): the suffix of its paths in the
# kernels line and the profile files, its launches per clip and per step
LAYOUTS = {"auto": ("", EXPECTED_LAUNCHES, EXPECTED_TRAIN_LAUNCHES),
           "pallas": pair_layout("_dw_pallas", "dw_chain"),
           "banded_mxu": pair_layout("_dw_banded_mxu", "dw_banded_mxu"),
           "banded_chain": pair_layout("_dw_banded_chain", "sk_chain_banded"),
           "banded_mxu_t": pair_layout("_dw_banded_mxu_t", "dw_banded_mxu_t"),
           "banded": pair_layout("_dw_banded")}
# the layouts whose train step and training guard run (phases 7-8, 11-12,
# 15-16, 19-20); the others run their forward and accuracy guards
TRAINED = ("auto", "pallas", "banded_mxu", "banded_chain")

# the training shapes (tools/train.py's sintel_kitti stage)
TRAIN_H, TRAIN_W = 432, 960
TRAIN_STEPS = 3          # timed, after one warm-up step
GUARD_H, GUARD_W, GUARD_ITERS = 128, 256, 2
# phase 8, f32: relative L2 error of each gradient <= GRAD_TOL +
# PERTURB_SLACK x its change under a 1e-6 relative weight perturbation, and
# of all gradients together <= GRAD_GLOBAL_TOL (read on an H100: 1.966e-7
# for the kernel path, 3.835e-6 for the perturbation; a kernel fault in a
# leaf of 1% of the gradient norm moves it by 1e-2 x that leaf's error)
GRAD_TOL, PERTURB_SLACK, GRAD_GLOBAL_TOL = 1e-3, 4.0, 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of FLOPs / peak rate of its io type and bytes / memory rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    """Print a line, and keep it in OUT_DIR/chip_smoke.log (the whole
    run's lines; a runner may return only the end of the output)."""
    print(msg, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.log"), "a") as fh:
        fh.write(msg + "\n")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, dt) -> tuple:
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[str(dt)[6:]]
    t_mem = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_mem),
            "operations" if t_ops >= t_mem else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def init_weights(model, seed: int) -> None:
    """Fan-in-scaled random weights (like the JAX package's oracle tests):
    every >= 2-D parameter r / sqrt(fan_in), LayerNorm weights 1 + 0.1 r,
    other vectors 0.05 r; then the flow head's output layer times
    FLOW_HEAD_SCALE. GMA's gamma and the temporal layer's zero-init
    weights become live, so K3's GMA output is not multiplied by zero."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.ndim >= 2:
                p.copy_(r / math.sqrt(p[0].numel()))
            elif "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * r)
            else:
                p.copy_(0.05 * r)
        out = model.update_block.flow_head.ffn2[2]
        out.weight.mul_(FLOW_HEAD_SCALE)
        out.bias.mul_(FLOW_HEAD_SCALE)


def bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    import torch

    e = torch.floor(torch.log2(x.abs().float().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


# ---------------------------------------------------------------- phase 3
def check_close(label, got, want, dt) -> float:
    """Elementwise check of a kernel output against its plain version
    (F32_TOL / the bf16 ulp rule); returns the max abs error."""
    import torch

    assert got.shape == want.shape and got.dtype == want.dtype, (
        label, got.shape, want.shape, got.dtype, want.dtype)
    want_abs = want.float().abs()
    top = float(want_abs.max())
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if dt == torch.float32:
        bound = F32_TOL + F32_TOL * want_abs
        rule = f"atol = rtol = {F32_TOL}"
    else:
        bound = BF16_ULPS * bf16_ulp(want_abs) + BF16_FLOOR * top
        rule = (f"{BF16_ULPS} ulp + 2^-9 max|plain|; err = "
                f"{err / float(bf16_ulp(torch.tensor(top))):.3g} ulp of "
                f"max|plain|")
    ok = bool((diff <= bound).all()) and math.isfinite(err)
    line = (f"check {label} {str(dt)[6:]}: max_abs_err {err:.3e} "
            f"max_rel_err {err / max(top, 1e-30):.3e} ({rule}; |plain| max "
            f"{top:.3e})")
    log(line)
    if not ok:
        raise AssertionError(f"{label} {dt} disagrees with its plain "
                             f"version: {line}")
    return err


def new_summary():
    return {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "ops_ms": 0.0, "mem_ms": 0.0, "library_ms": None}
            for k in KERNELS}


def add_timing(s, calls, ms, pms, flops, nbytes_, dt, lib_ms=None):
    """Add one case's per-call numbers, times its calls, to summary s."""
    b, _ = bound_ms(flops, nbytes_, dt)
    s["ms"] += calls * ms
    s["plain_ms"] += calls * pms
    s["bound_ms"] += calls * b
    s["ops_ms"] += calls * 1e3 * flops / PEAK_FLOPS[str(dt)[6:]]
    s["mem_ms"] += calls * 1e3 * nbytes_ / HBM_BYTES_PER_S
    if lib_ms is not None:
        s["library_ms"] = (s["library_ms"] or 0.0) + calls * lib_ms
    return b


def kernel_checks(dev, summaries, hp, wp, train):
    """Every forward kernel against its plain version at the shapes of an
    hp x wp clip (padded size, T frames, B=1), in f32 and bf16; per-kernel
    bf16 numbers summed into ``summaries[layout]`` (per SK layout, the
    keys of LAYOUTS) over the calls of one inference clip, or of one train
    step (``train``: the refinement kernels run twice, forward and remat's
    recompute, and K3 also returns its logsumexp)."""
    import torch
    import torch.nn.functional as F

    from streamflow_tpu_torch.ops.corr import pool_pyramid
    from streamflow_tpu_torch.ops.coords import coords_grid
    from streamflow_tpu_torch.ops.kernels import corr_lookup as K1
    from streamflow_tpu_torch.ops.kernels import dw_banded as K6
    from streamflow_tpu_torch.ops.kernels import dw_chain as K5
    from streamflow_tpu_torch.ops.kernels import ffn_pair as K2
    from streamflow_tpu_torch.ops.kernels import flash_attention as K3
    from streamflow_tpu_torch.ops.kernels import lga_attention as K4
    from streamflow_tpu_torch.tools import kernel_bench as KB

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dt)

    # each make(dt) -> (kernel fn, plain fn, FLOPs, inputs, library fn,
    # None or (what, fn) timed beside it as a yardstick: the default
    # layout's cuDNN conv beside K5 and K8, K2's library composite)
    def ffn_case(variant, rows, c, ch, co):
        def make(dt):
            run, plain, flops, args, _, _ = make_k2(dt)
            names = {"ffn_pair": "x w1 b1 w2 b2",
                     "pw_ffn_pair": "x wp bp w1 b1 w2 b2",
                     "ffn_pair_k1": "x w1 b1 w2 b2 kw kb",
                     "dwres_pw_ffn_pair": "x yres db wp bp w1 b1 w2 b2",
                     "ln_ffn_pair": "x ln_g ln_b w1 b1 w2 b2"}[variant]
            a = dict(zip(names.split(), args))
            return (run, plain, flops, args, None,
                    ("the library composite (bf16 torch ops, the hidden "
                     "activation through device memory)",
                     lambda: KB.ffn_composite(variant, a)))

        def make_k2(dt):
            w = lambda i, o: rnd(o, i, scale=i ** -0.5, dt=dt)  # noqa: E731
            b = lambda n: rnd(n, scale=0.1, dt=dt)  # noqa: E731
            x = rnd(rows, c, dt=dt)
            flops = 2 * rows * (c * ch + ch * co)
            if variant == "ffn_pair":
                args = (x, w(c, ch), b(ch), w(ch, co), b(co))
                return (lambda: K2.ffn_pair(*args),
                        lambda: K2.ffn_pair_plain(*args, True),
                        flops, args, None, None)
            if variant == "pw_ffn_pair":
                args = (x, w(c, c), b(c), w(c, ch), b(ch), w(ch, co), b(co))
                return (lambda: K2.pw_ffn_pair(*args),
                        lambda: K2.ffn_pair_plain(x, *args[3:], False,
                                                  wp=args[1], bp=args[2]),
                        flops + 2 * rows * c * c, args, None, None)
            if variant == "ffn_pair_k1":
                args = (x, w(c, ch), b(ch), w(ch, co), b(co),
                        rnd(co, scale=0.3, dt=dt), b(co))
                return (lambda: K2.ffn_pair_k1(*args),
                        lambda: K2.ffn_pair_plain(*args[:5], True,
                                                  kw=args[5], kb=args[6]),
                        flops, args, None, None)
            if variant == "dwres_pw_ffn_pair":
                args = (x, rnd(rows, c, dt=dt), b(c), w(c, c), b(c),
                        w(c, ch), b(ch), w(ch, co), b(co))
                return (lambda: K2.dwres_pw_ffn_pair(*args),
                        lambda: K2.ffn_pair_plain(
                            x, *args[5:], False, wp=args[3], bp=args[4],
                            yres=args[1], db=args[2]),
                        flops + 2 * rows * c * c, args, None, None)
            args = (x, 1.0 + rnd(c, scale=0.1, dt=dt), b(c), w(c, ch),
                    b(ch), w(ch, co), b(co))
            return (lambda: K2.ln_ffn_pair(*args),
                    lambda: K2.ffn_pair_plain(x, *args[3:], False,
                                              ln=args[1:3], add_res=True),
                    flops, args, None, None)
        return make

    def dw_case(kind, nimg, c, k):
        """The SK block's dw stack (1, k) of one (nimg, h8, w8, c) tensor:
        K5 or K8 (the whole stack; cuDNN's conv of the default layout
        timed beside it), K6 or K7 (the kxk stage; the library yardstick
        is cuDNN's bf16 depthwise conv + bias, one call on the same
        tensor). The work counted is the conv's, 2 k^2 N C FLOP, and K8's
        k=1 stage, 3 N C."""
        def make(dt):
            x = rnd(nimg, h8, w8, c, dt=dt)
            ws = (rnd(c, 1, 1, 1, scale=0.3, dt=dt),
                  rnd(c, 1, k, k, scale=1 / k, dt=dt))
            bs = (rnd(c, scale=0.1, dt=dt), rnd(c, scale=0.1, dt=dt))
            flops = 2 * k * k * x.numel()

            def conv():
                # the default layout's conv of the same tensor, copies
                # included (layers/sk.py)
                y = x.permute(0, 3, 1, 2)
                y = y.contiguous() if k > 7 else y
                y = F.conv2d(y, ws[1], None, 1, k // 2, 1, c)
                return y.permute(0, 2, 3, 1).contiguous()
            cudnn = ("the default layout's cuDNN conv of the same tensor",
                     conv)
            if kind in ("dw_chain", "sk_chain_banded"):
                mod = K5 if kind == "dw_chain" else K6
                run, plain = getattr(mod, kind), getattr(mod, kind + "_plain")
                return (lambda: run(x, ws, bs, (1, k)),
                        lambda: plain(x, ws, bs, (1, k)),
                        flops + 3 * (kind != "dw_chain") * x.numel(),
                        (x, *ws, *bs), None, cudnn)
            run, plain = getattr(K6, kind), getattr(K6, kind + "_plain")
            return (lambda: run(x, ws[1], bs[1]),
                    lambda: plain(x, ws[1], bs[1]), flops,
                    (x, ws[1], bs[1]),
                    lambda: F.conv2d(x.permute(0, 3, 1, 2), ws[1], bs[1], 1,
                                     k // 2, 1, c), None)
        return make

    def flash_case(bh_shape, n, m, d):
        def make(dt):
            q = rnd(*bh_shape, n, d, scale=d ** -0.5, dt=dt)
            k, v = rnd(*bh_shape, m, d, dt=dt), rnd(*bh_shape, m, d, dt=dt)
            bh = math.prod(bh_shape)
            return (lambda: K3.flash_attention_fwd(q, k, v, return_lse=train),
                    lambda: K3.flash_attention_plain(q, k, v,
                                                     return_lse=train),
                    4 * bh * n * m * d, (q, k, v),
                    lambda: F.scaled_dot_product_attention(q, k, v,
                                                           scale=1.0), None)
        return make

    def lga_case(hp, wp, c, nh, b=1):
        def make(dt):
            qkv = rnd(b, hp, wp, 3 * c, dt=dt)
            hd, ws = c // nh, 7
            windows = b * (hp // ws) * (wp // ws)
            # the yardstick: SDPA on the window-partitioned q, k, v
            parts = qkv.reshape(b, hp // ws, ws, wp // ws, ws, 3, nh, hd)
            parts = parts.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(
                3, windows, nh, ws * ws, hd).contiguous()
            return (lambda: K4.lga_attention(qkv, ws, nh),
                    lambda: K4.lga_attention_plain(qkv, ws, nh),
                    4 * windows * nh * (ws * ws) ** 2 * hd, (qkv,),
                    lambda: F.scaled_dot_product_attention(
                        parts[0], parts[1], parts[2], scale=hd ** -0.5),
                    None)
        return make

    def corr_case():
        def make(dt):
            bf, h, w, c, r = 3, h8, w8, 256, 4
            f1 = rnd(bf, h, w, c, dt=dt)
            levels = [lv.contiguous() for lv in
                      pool_pyramid(rnd(bf, h, w, c, dt=dt), 4)]
            coords = coords_grid(bf, h, w, dev) + 30.0 * (
                2 * torch.rand(bf, h, w, 2, generator=g, device=dev) - 1)
            coords[0, :4] = torch.tensor([1e4, -1e4], device=dev)  # far out
            coords[1, :2] = torch.tensor([-20.0, 70.0], device=dev)
            coords = coords.contiguous()
            shapes = [(lv.shape[1], lv.shape[2]) for lv in levels]
            return (lambda: K1.corr_lookup(f1, levels, coords, r),
                    lambda: K1.corr_lookup_plain(f1, levels, coords, r),
                    KB.corr_flops(coords, shapes, c, r),
                    (f1, *levels, coords), None, None)
        return make

    def corr_traffic_case(traffic, b, h, w, c, nl, r, patch=None):
        """K1 under one of kernel_bench's traffics; ``patch(coords)`` edits
        the coordinates in place (far-out tiles, mixed tiles)."""
        def make(dt):
            f1 = rnd(b, h, w, c, dt=dt)
            levels = [lv.contiguous() for lv in
                      pool_pyramid(rnd(b, h, w, c, dt=dt), nl)]
            coords = KB.corr_coords(traffic, b, h, w, g, dev)
            if patch is not None:
                patch(coords)
            shapes = [(lv.shape[1], lv.shape[2]) for lv in levels]
            return (lambda: K1.corr_lookup(f1, levels, coords, r),
                    lambda: K1.corr_lookup_plain(f1, levels, coords, r),
                    KB.corr_flops(coords, shapes, c, r),
                    (f1, *levels, coords), None, None)
        return make

    def mixed_tiles(coords):
        """Pair 0: whole 8x8 tiles far out (empty boxes at every level);
        pair 1: tiles whose first rows are far out; pair 2: rows 20 on
        uniform over the frame (boxes wider than one 128-column plane)."""
        coords[0, :16, :24] = torch.tensor([1e4, 1e4], device=dev)
        coords[1, :4] = torch.tensor([-1e4, 1e4], device=dev)
        h, w = coords.shape[1:3]
        coords[2, 20:] = KB.corr_coords("uniform", 1, h, w, g, dev)[0, 20:]

    # token grids at 1/8 and 1/4 of the padded clip; the refinement kernels
    # (SK pairs, GMA, K1) run on B*(T-1) = 3 frame pairs, the flow head's
    # pair on one grid with the pairs in its channels; the Twins encoders
    # (fnet on T frames, cnet on T-1) at 1/4 (stage 0) and 1/8 (stage 1)
    h8, w8 = hp // 8, wp // 8
    h4, w4 = 2 * h8, 2 * w8
    path = "train step" if train else "clip"
    refine = 2 * ITERS if train else ITERS
    # the six SK blocks (c_in, out_dim, images, dw k): convc1, convc2,
    # convf2, conv, gru, flow_head; cases tagged with the SK layouts whose
    # path runs them (LAYOUTS' keys: the default "auto" and the pair
    # layouts, each with its own dw kernel, none for "banded")
    sk = [(324, 256, 3, 15), (256, 192, 3, 15), (128, 64, 3, 15),
          (256, 126, 3, 15), (640, 128, 3, 7), (384, 6, 1, 15)]
    every, auto = tuple(LAYOUTS), ("auto",)
    pair = tuple(lt for lt in LAYOUTS if lt != "auto")
    dw_kernels = (("dw_chain", "pallas"), ("dw_banded_mxu", "banded_mxu"),
                  ("dw_banded_mxu_t", "banded_mxu_t"),
                  ("sk_chain_banded", "banded_chain"))
    cases = []  # (kernel, label, make, calls per clip or step, layouts)
    for c, co, pairs, k in sk:
        ch, rows = int(1.5 * c), pairs * h8 * w8
        cases.append(("ffn_pair", f"ffn_pair_k1 {rows}x{c}-{ch}-{c}",
                      ffn_case("ffn_pair_k1", rows, c, ch, c), refine, auto))
        cases.append(("ffn_pair", f"dwres_pw_ffn_pair {rows}x{c}-{ch}-{co}",
                      ffn_case("dwres_pw_ffn_pair", rows, c, ch, co),
                      refine, auto))
        cases.append(("ffn_pair", f"ffn_pair {rows}x{c}-{ch}-{c}",
                      ffn_case("ffn_pair", rows, c, ch, c), refine, pair))
        for kernel, layout in dw_kernels:
            cases.append((kernel, f"{pairs}x{h8}x{w8}x{c} ks (1, {k})",
                          dw_case(kernel, pairs, c, k), refine, (layout,)))
        cases.append(("ffn_pair", f"pw_ffn_pair {rows}x{c}-{ch}-{co}",
                      ffn_case("pw_ffn_pair", rows, c, ch, co), refine,
                      pair))
    for c, rows in ((128, T * h4 * w4), (128, (T - 1) * h4 * w4),
                    (256, T * h8 * w8), (256, (T - 1) * h8 * w8)):
        cases.append(("ffn_pair", f"ln_ffn_pair {rows}x{c}-{4 * c}-{c}",
                      ffn_case("ln_ffn_pair", rows, c, 4 * c, c), 2, every))
    # K2's tails (64-row tiles): one row, one row past a tile, one row past
    # the main path's 21120, in every form at every width of the path
    if not train:
        for rows in (1, 65, 3 * h8 * w8 + 1):
            for c, co, _, _ in sk:
                ch = int(1.5 * c)
                for form, out in (("ffn_pair_k1", c), ("dwres_pw_ffn_pair", co),
                                  ("ffn_pair", c), ("pw_ffn_pair", co)):
                    cases.append(("ffn_pair",
                                  f"tail {form} {rows}x{c}-{ch}-{out}",
                                  ffn_case(form, rows, c, ch, out), 0, every))
            for c in (128, 256):
                cases.append(("ffn_pair",
                              f"tail ln_ffn_pair {rows}x{c}-{4 * c}-{c}",
                              ffn_case("ln_ffn_pair", rows, c, 4 * c, c), 0,
                              every))
    n = h8 * w8
    cases.append(("flash_attention", f"gma bh3 n{n} m{n} d128",
                  flash_case((3, 1), n, n, 128), refine, every))
    # GSA: keys from a stride-sr conv of the frames stacked along H
    for stage, nh, sr, hh, ww in ((0, 4, 8, h4, w4), (1, 8, 4, h8, w8)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            n, m = t * hh * ww, (t * hh // sr) * (ww // sr)
            cases.append(("flash_attention",
                          f"gsa{stage} {enc} h{nh} n{n} m{m} d32",
                          flash_case((1, nh), n, m, 32), 1, every))
    # tails of K3's tiles (128 query rows; 128 keys at d=128, 64 at d=32):
    # fewer keys than one tile, ragged query and key counts, one query row
    for bh_shape, n, m, d in (((1, 2), 300, 1000, 128), ((2, 1), 1, 1000, 128),
                              ((1, 4), 300, 50, 32), ((1, 8), 1000, 1312, 32),
                              ((1, 4), 1, 70, 32)):
        cases.append(("flash_attention",
                      f"tail bh{math.prod(bh_shape)} n{n} m{m} d{d}",
                      flash_case(bh_shape, n, m, d), 0, every))
    # LGA: the qkv grid of the frames stacked along H, padded to 7x7 windows
    for stage, c, nh, hh, ww in ((0, 128, 4, h4, w4), (1, 256, 8, h8, w8)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            hq, wq = -(-t * hh // 7) * 7, -(-ww // 7) * 7
            cases.append(("lga_attention",
                          f"stage{stage} {enc} {hq}x{wq}x{3 * c} h{nh}",
                          lga_case(hq, wq, c, nh), 1, every))
    # K4's tails: one-window grids and a stage-1 grid, two images each
    for hq, wq, c, nh in ((7, 7, 128, 4), (7, 7, 256, 8), (14, 21, 256, 8)):
        cases.append(("lga_attention", f"tail b2 {hq}x{wq}x{3 * c} h{nh}",
                      lga_case(hq, wq, c, nh, b=2), 0, every))
    cases.append(("corr_lookup", f"3x{h8}x{w8}x256 4 levels r4", corr_case(),
                  refine, every, "jitter30"))
    # K1 under the other traffics (timed apart: the kernels line's ms is
    # the jitter30 case's), then checked only: the branches of its bf16
    # body (128-, 64- and 32-column planes, empty boxes, box rows of
    # several planes) at ragged sizes, channel counts that leave a part
    # or most of a 64-channel panel empty (96, 32), C = 128 and 512,
    # fewer levels, a smaller radius and a level of size zero
    for traffic in ("smooth", "uniform"):
        cases.append(("corr_lookup", f"{traffic} 3x{h8}x{w8}x256 4 levels r4",
                      corr_traffic_case(traffic, 3, h8, w8, 256, 4, 4),
                      refine, every, traffic))
    for label, args in (
            ("mixed tiles 3x45x150x96 4 levels r4",
             ("smooth", 3, 45, 150, 96, 4, 4, mixed_tiles)),
            (f"jitter30 3x{h8}x{w8}x128 4 levels r4",
             ("jitter30", 3, h8, w8, 128, 4, 4)),
            ("uniform 2x13x21x32 2 levels r2",
             ("uniform", 2, 13, 21, 32, 2, 2)),
            ("uniform 1x20x40x512 3 levels r3",
             ("uniform", 1, 20, 40, 512, 3, 3)),
            ("jitter30 1x5x6x64 4 levels r4", ("jitter30", 1, 5, 6, 64, 4, 4)),
            ("uniform 1x30x300x256 4 levels r4",
             ("uniform", 1, 30, 300, 256, 4, 4))):
        cases.append(("corr_lookup", f"tail {label}",
                      corr_traffic_case(*args), 0, every))

    for kernel, label, make, calls, layouts, *traffic in cases:
        traffic = traffic[0] if traffic else None
        for dt in (torch.float32, torch.bfloat16):
            run, plain, flops, inputs, library, aside = make(dt)
            got, want = run(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            # the output, and K3's logsumexp (f32) when it returns one
            err = max(check_close(f"{kernel}{' lse' if i else ''} [{label}]",
                                  a, b, a.dtype)
                      for i, (a, b) in enumerate(zip(got, want)))
            if dt == torch.bfloat16 and calls:   # tails: checked only
                ms, pms = cuda_ms(run, REPS), cuda_ms(plain, REPS)
                lib_ms = cuda_ms(library, REPS) if library else None
                io = nbytes(*inputs, *got)
                b, _ = bound_ms(flops, io, dt)
                for layout in layouts:
                    s = summaries[layout][kernel]
                    s["err"] = max(s["err"], err)
                    if traffic is not None:   # K1: ms per traffic
                        s.setdefault("ms_by_traffic", {})[traffic] = (
                            calls * ms)
                    if traffic in (None, "jitter30"):
                        add_timing(s, calls, ms, pms, flops, io, dt, lib_ms)
                extra = ""
                if aside is not None:
                    extra = f"; {aside[0]} {cuda_ms(aside[1], REPS):.4f} ms"
                if kernel in ("dw_chain", "sk_chain_banded"):
                    extra += (f", f32 FMA floor (67 TFLOP/s) "
                              f"{1e3 * flops / PEAK_FLOPS['float32']:.4f} ms")
                log(f"time {kernel} [{label}] bf16: kernel {ms:.4f} ms "
                    f"plain {pms:.4f} ms bound {b:.4f} ms ({flops:.4g} "
                    f"FLOP, {io:.4g} B; achieved {flops / ms / 1e9:.1f} "
                    f"TFLOP/s, {io / ms / 1e6:.0f} GB/s) library "
                    + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none")
                    + f"; calls per {path} {calls} ({'/'.join(layouts)})"
                    + extra)
            del got, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4/5
def make_clip(dev):
    import torch

    from streamflow_tpu_torch.ops.padding import InputPadder

    g = torch.Generator().manual_seed(SEED)
    imgs = torch.randint(0, 256, (B, T, H, W, 3), generator=g).float()
    padder = InputPadder((H, W, 3), mode="sintel")
    imgs = padder.pad(imgs.reshape(B * T, H, W, 3))
    return imgs.reshape(B, T, *padder.padded_shape, 3).to(dev)


def full_forward(dev, dw_impl):
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    suffix, expected, _ = LAYOUTS[dw_impl]
    cfg = StreamFlowConfig(T=T, iters=ITERS, mixed_precision=True,
                           dw_impl=dw_impl)
    model = create_model("streamflow", cfg=cfg)
    init_weights(model, SEED)
    imgs = make_clip(dev)
    hp, wp = imgs.shape[2], imgs.shape[3]

    flows = model(imgs, test_mode=True)       # warm-up (builds nothing new)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    flows = model(imgs, test_mode=True)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    log(f"forward dw_impl={dw_impl!r} launches {json.dumps(counts)} expected "
        f"{json.dumps(expected)}")
    assert counts == expected, "launch counts differ"
    assert flows.shape == (B, T - 1, hp, wp, 2), flows.shape
    assert bool(torch.isfinite(flows).all()), "non-finite flows"
    peak = torch.cuda.max_memory_allocated()
    mag = flows.norm(dim=-1)

    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(imgs, test_mode=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * sum(times) / len(times)
    log(f"forward dw_impl={dw_impl!r} {tuple(flows.shape)} finite; ms/clip "
        f"{ms:.3f} (mean of "
        f"{REPS}, min {1e3 * min(times):.3f}); frames/s {T / (ms / 1e3):.3f};"
        f" max_memory_allocated {peak / 2 ** 30:.3f} GiB; |flow| px mean "
        f"{float(mag.mean()):.4g} p99 "
        f"{float(torch.quantile(mag.flatten()[::7], 0.99)):.4g} max "
        f"{float(mag.max()):.4g}")
    profile_device(lambda: model(imgs, test_mode=True), ms,
                   "forward" + suffix)
    return counts, ms


def profile_device(fn, wall_ms: float, name: str) -> dict:
    """Device time of one call of ``fn`` by kernel group; the idle share
    compares the summed device time with the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=60)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as fh:
        fh.write(smi() + "\n" + table)
    total = 0.0
    by = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if ev.device_type.name != "CUDA" or t <= 0:
            continue
        total += t
        key = ev.key.lower()
        for pat, group in (("corr_lookup", "corr_lookup"),
                           ("ffn_pair", "ffn_pair"),
                           ("flash_fwd", "flash_fwd"),
                           ("dw_chain", "dw_chain"),
                           ("dw_banded", "dw_banded"),
                           ("bwd_dq_", "flash_bwd"), ("bwd_dkv_", "flash_bwd"),
                           ("lga_kernel", "lga_kernel"), ("conv", "conv"),
                           ("gemm", "gemm"), ("elementwise", "elementwise"),
                           ("reduce", "reduce"), ("softmax", "softmax"),
                           ("layer_norm", "layer_norm"), ("cat", "cat"),
                           ("copy", "copy")):
            if pat in key:
                by[group] = by.get(group, 0.0) + t
                break
        else:
            by["other"] = by.get("other", 0.0) + t
    idle = max(0.0, 1 - total / 1e3 / wall_ms)
    log(f"profile {name} device time by group (ms): " + json.dumps(
        {k: round(v / 1e3, 3) for k, v in sorted(by.items(),
                                                 key=lambda kv: -kv[1])})
        + f" total {total / 1e3:.3f}; K1 share "
        f"{by.get('corr_lookup', 0.0) / max(total, 1e-9):.4f}; device idle "
        f"share {idle:.4f} of {wall_ms:.3f} ms")
    return {"total_ms": total / 1e3, "idle": idle}


def accuracy_guards(dev, dw_impl, refs) -> None:
    """iters=1, one clip, the same weights, the SK layout ``dw_impl``: the
    kernel path on the card and the plain path on the CPU, each in f32 and
    bf16, against the f32 plain path. Every layout computes the same
    function in f32, so that reference is made once, by the first call,
    and kept in ``refs``."""
    import copy

    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model

    imgs = make_clip("cpu")
    flows = {}
    for dtype in ("float32", "bfloat16"):
        cfg = StreamFlowConfig(T=T, iters=1,
                               mixed_precision=dtype == "bfloat16",
                               dw_impl=dw_impl)
        cpu_model = create_model("streamflow", cfg=cfg, device="cpu")
        init_weights(cpu_model, SEED + 1)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        flows[dtype, "card"] = gpu_model(imgs.to(dev),
                                         test_mode=True).float().cpu()
        if dtype == "bfloat16" or "f32" not in refs:
            flows[dtype, "cpu"] = cpu_model(imgs, test_mode=True).float()
        if dtype == "float32" and "f32" not in refs:
            refs["f32"] = (flows[dtype, "cpu"], dw_impl)
    ref, ref_layout = refs["f32"]
    mag = ref.norm(dim=-1)

    def rel_epe(x):
        epe = (x - ref).norm(dim=-1)
        per_px = (epe / mag.clamp(min=1.0)).flatten()[::7].double()
        return (float(epe.max()) / max(1.0, float(mag.max())),
                float(torch.quantile(per_px, 0.99)))

    f32 = rel_epe(flows["float32", "card"])
    bf16, bf16_plain = (rel_epe(flows["bfloat16", where])
                        for where in ("card", "cpu"))
    log(f"accuracy guard dw_impl={dw_impl!r} iters=1 against the f32 plain "
        f"path (of dw_impl={ref_layout!r}; |flow_ref| px "
        f"mean {float(mag.mean()):.4g} max {float(mag.max()):.4g}), rel EPE "
        f"global / per-pixel p99: f32 kernels {f32[0]:.3e} / {f32[1]:.3e} "
        f"(bound {F32_GUARD_TOL} each); bf16 kernels {bf16[0]:.3e} / "
        f"{bf16[1]:.3e}, bf16 plain {bf16_plain[0]:.3e} / "
        f"{bf16_plain[1]:.3e} (bound {BF16_GUARD_RATIO}x the plain)")
    assert all(math.isfinite(v) and v < F32_GUARD_TOL for v in f32), f32
    assert all(math.isfinite(k) and k <= BF16_GUARD_RATIO * p
               for k, p in zip(bf16, bf16_plain)), (bf16, bf16_plain)


# ---------------------------------------------------------------- phase 6
def backward_checks(dev, summaries) -> None:
    """B5, with K3's output and lse, against their plain versions at the
    training shapes (f32, bf16; bf16 timed beside its bound and SDPA's
    backward, summed over one train step's calls into each of
    ``summaries``), and each kernel wrapper's forward (f32, bf16) and
    gradient (f32) against its plain version."""
    import torch
    import torch.nn.functional as F

    from streamflow_tpu_torch.ops.corr import pool_pyramid
    from streamflow_tpu_torch.ops.coords import coords_grid
    from streamflow_tpu_torch.ops.kernels import corr_lookup as K1
    from streamflow_tpu_torch.ops.kernels import dw_banded as K6
    from streamflow_tpu_torch.ops.kernels import dw_chain as K5
    from streamflow_tpu_torch.ops.kernels import ffn_pair as K2
    from streamflow_tpu_torch.ops.kernels import flash_attention as K3
    from streamflow_tpu_torch.ops.kernels import lga_attention as K4

    g = torch.Generator(device=dev).manual_seed(SEED + 2)

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dt)

    # GMA over 3 pairs of (432/8) x (960/8) tokens; the four GSA blocks
    # (fnet on 4 frames, cnet on 3, stacked along H; keys from a stride-sr
    # conv, stage 0 sr 8, stage 1 sr 4), each above the 16384-token switch;
    # calls per train step
    h8, w8 = TRAIN_H // 8, TRAIN_W // 8
    cases = [("gma", (3, 1), h8 * w8, h8 * w8, 128, ITERS)]
    for stage, nh, sr, hh, ww in ((0, 4, 8, 2 * h8, 2 * w8),
                                  (1, 8, 4, h8, w8)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            cases.append((f"gsa{stage} {enc}", (1, nh), t * hh * ww,
                          (t * hh // sr) * (ww // sr), 32, 1))
    # B5's tails (128 resident and 64 walked rows a block): one query row,
    # fewer keys than one tile, ragged query and key counts
    for bh_shape, n, m, d in (((1, 2), 1, 1000, 128), ((2, 1), 300, 50, 128),
                              ((1, 2), 333, 777, 128), ((1, 4), 1, 70, 32),
                              ((1, 4), 300, 50, 32), ((1, 8), 1001, 1313, 32)):
        cases.append(("tail", bh_shape, n, m, d, 0))
    for label, bh_shape, n, m, d, calls in cases:
        label = f"{label} bh{math.prod(bh_shape)} n{n} m{m} d{d}"
        for dt in (torch.float32, torch.bfloat16):
            q = rnd(*bh_shape, n, d, scale=d ** -0.5, dt=dt)
            k, v = rnd(*bh_shape, m, d, dt=dt), rnd(*bh_shape, m, d, dt=dt)
            do = rnd(*bh_shape, n, d, dt=dt)
            o, lse = K3.flash_attention_fwd(q, k, v, return_lse=True)
            o_p, lse_p = K3.flash_attention_plain(q, k, v, return_lse=True)
            check_close(f"flash_attention [{label}]", o, o_p, dt)
            check_close(f"flash_attention lse [{label}]", lse, lse_p,
                        torch.float32)
            # both sides take the same inputs: the plain lse and delta
            delta = (do.float() * o_p.float()).sum(-1)
            run = lambda: K3.flash_attention_bwd(  # noqa: E731
                q, k, v, do, lse_p, delta)
            plain = lambda: K3.flash_attention_bwd_plain(  # noqa: E731
                q, k, v, do, lse_p, delta)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = max(check_close(f"flash_attention_bwd {name} [{label}]",
                                  a, b, dt)
                      for name, a, b in zip(("dq", "dk", "dv"), got, want))
            if dt == torch.bfloat16 and calls:   # tails: checked only
                ms, pms = cuda_ms(run, REPS), cuda_ms(plain, REPS)
                qs, ks, vs = (t.detach().clone().requires_grad_(True)
                              for t in (q, k, v))
                ref = F.scaled_dot_product_attention(qs, ks, vs, scale=1.0)
                lib_ms = cuda_ms(lambda: torch.autograd.grad(
                    ref, (qs, ks, vs), do, retain_graph=True), REPS)
                flops = 10 * math.prod(bh_shape) * n * m * d
                io = nbytes(q, k, v, do, lse, delta, *got)
                for summary in summaries:
                    s = summary["flash_attention_bwd"]
                    s["err"] = max(s["err"], err)
                    b = add_timing(s, calls, ms, pms, flops, io, dt, lib_ms)
                log(f"time flash_attention_bwd [{label}] bf16: kernel "
                    f"{ms:.4f} ms plain {pms:.4f} ms bound {b:.4f} ms "
                    f"({flops:.4g} FLOP, {io:.4g} B) library (SDPA "
                    f"backward) {lib_ms:.4f} ms; calls per train step "
                    f"{calls}")
                del ref, qs, ks, vs
            del q, k, v, do, o, lse, o_p, lse_p, got, want
            torch.cuda.empty_cache()

    # each kernel wrapper (kernel forward, composite backward) at a training
    # shape: its forward against the plain version in bf16 (the train step's
    # dtype) and f32, then its f32 gradient against autograd of the plain
    # version. That backward IS autograd of the same composite on the same
    # saved inputs, so the gradient check tests only the wiring (each
    # gradient reaches its argument; it reads 0); the kernels' numerics are
    # held by the forward checks and by phase 8.
    def grad_check(label, fn, plain, inputs):
        for dt in (torch.bfloat16, torch.float32):
            ins = [t.detach().to(t.dtype if name == "coords" else dt)
                   for name, t in inputs]
            with torch.no_grad():
                check_close(f"{label} forward", fn(*ins), plain(*ins), dt)
        ins = [t.detach().clone().requires_grad_(name != "coords")
               for name, t in inputs]
        out = fn(*ins)
        gout = rnd(*out.shape)
        wrt = [t for t in ins if t.requires_grad]
        got = torch.autograd.grad(out, wrt, gout)
        ins_p = [t.detach().clone().requires_grad_(t.requires_grad)
                 for t in ins]
        want = torch.autograd.grad(plain(*ins_p), [t for t in ins_p
                                                   if t.requires_grad], gout)
        torch.cuda.synchronize()
        worst = 0.0
        for a, b in zip(got, want):
            top = float(b.abs().max())
            diff = (a - b).abs()
            ok = bool((diff <= F32_TOL * (top + b.abs())).all())
            worst = max(worst, float(diff.max()) / max(top, 1e-30))
            if not ok:
                raise AssertionError(f"gradient of {label} disagrees with "
                                     f"autograd of its plain version")
        log(f"check grad {label} f32 (wiring): {len(got)} inputs, max abs err "
            f"/ max |plain grad| {worst:.3e} (bound {F32_TOL} of the largest "
            f"element + {F32_TOL} rtol)")

    rows, c = 3 * h8 * w8, 324
    w = lambda i, o: rnd(o, i, scale=i ** -0.5)  # noqa: E731
    b = lambda n: rnd(n, scale=0.1)  # noqa: E731
    x = rnd(rows, c)
    grad_check("ffn_pair_k1 [convc1]", K2.ffn_pair_k1,
               lambda *a: K2.ffn_pair_plain(*a[:5], True, kw=a[5], kb=a[6]),
               list(zip("xabcdef", (x, w(c, 486), b(486), w(486, c), b(c),
                                    rnd(c, scale=0.3), b(c)))))
    grad_check("dwres_pw_ffn_pair [convc1]", K2.dwres_pw_ffn_pair,
               lambda *a: K2.ffn_pair_plain(a[0], *a[5:], False, wp=a[3],
                                            bp=a[4], yres=a[1], db=a[2]),
               list(zip("xyabcdefg", (x, rnd(rows, c), b(c), w(c, c), b(c),
                                      w(c, 486), b(486), w(486, 256),
                                      b(256)))))
    grad_check("ffn_pair [convc1, dw_impl='pallas']", K2.ffn_pair,
               lambda *a: K2.ffn_pair_plain(*a, True),
               list(zip("xabcd", (x, w(c, 486), b(486), w(486, c), b(c)))))
    grad_check("pw_ffn_pair [convc1, dw_impl='pallas']", K2.pw_ffn_pair,
               lambda *a: K2.ffn_pair_plain(a[0], *a[3:], False, wp=a[1],
                                            bp=a[2]),
               list(zip("xabcdef", (x, w(c, c), b(c), w(c, 486), b(486),
                                    w(486, 256), b(256)))))
    xs = x.reshape(3, h8, w8, c)
    for cc, k, xk in ((c, 15, xs), (640, 7, rnd(3, h8, w8, 640))):
        stack = list(zip("xabcd", (xk, rnd(cc, 1, 1, 1, scale=0.3),
                                   rnd(cc, 1, k, k, scale=1 / k), b(cc),
                                   b(cc))))
        for mod, name in ((K5, "dw_chain"), (K6, "sk_chain_banded")):
            fn, plain = getattr(mod, name), getattr(mod, name + "_plain")
            grad_check(f"{name} [{tuple(xk.shape)} ks (1, {k})]",
                       lambda a, w1, wk, b1, bk, k=k, fn=fn: fn(
                           a, (w1, wk), (b1, bk), (1, k)),
                       lambda a, w1, wk, b1, bk, k=k, fn=plain: fn(
                           a, (w1, wk), (b1, bk), (1, k)), stack)
        for name in ("dw_banded_mxu", "dw_banded_mxu_t"):
            grad_check(f"{name} [{tuple(xk.shape)} k {k}]",
                       getattr(K6, name), getattr(K6, name + "_plain"),
                       [stack[0], stack[2], stack[4]])
    xt = rnd(T * 2 * h8 * 2 * w8, 128)
    grad_check("ln_ffn_pair [twins stage 0 fnet]", K2.ln_ffn_pair,
               lambda *a: K2.ffn_pair_plain(a[0], *a[3:], False,
                                            ln=(a[1], a[2]), add_res=True),
               list(zip("xabcdef", (xt, 1.0 + rnd(128, scale=0.1), b(128),
                                    w(128, 512), b(512), w(512, 128),
                                    b(128)))))
    hp, wp = -(-T * 2 * h8 // 7) * 7, -(-2 * w8 // 7) * 7
    grad_check("lga_attention [twins stage 0 fnet]",
               lambda a: K4.lga_attention(a, 7, 4),
               lambda a: K4.lga_attention_plain(a, 7, 4),
               [("qkv", rnd(1, hp, wp, 384))])
    coords = (coords_grid(3, h8, w8, dev)
              + 4.0 * rnd(3, h8, w8, 2)).contiguous()
    f1, f2 = rnd(3, h8, w8, 256), rnd(3, h8, w8, 256)
    grad_check("corr_lookup [3x54x120x256]",
               lambda a, bb, cc: K1.FusedCorr(a, bb).lookup(cc),
               lambda a, bb, cc: K1.corr_lookup_plain(
                   a, pool_pyramid(bb, 4), cc),
               [("f1", f1), ("f2", f2), ("coords", coords)])
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 7
def train_setup(dev, h, w, iters, mixed_precision, seed, dw_impl):
    """A TrainState holding a training model (SK layout ``dw_impl``) with
    the seeded weights, and a seeded synthetic batch (uint8-range images,
    N(0, 4^2) px flows)."""
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.tools.train_bench import synthetic_batch
    from streamflow_tpu_torch.training.state import TrainState

    cfg = StreamFlowConfig(T=T, iters=iters, mixed_precision=mixed_precision,
                           remat=True, dw_impl=dw_impl)
    model = create_model("streamflow", cfg=cfg, device=dev, train=True)
    init_weights(model, seed)
    state = TrainState.create(model, lr=1.75e-4, num_steps=180_000)
    return state, synthetic_batch(B, T, h, w, seed, dev)


def train_step_phase(dev, dw_impl) -> dict:
    import torch

    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.training.step import make_train_step

    suffix, _, expected = LAYOUTS[dw_impl]
    state, batch = train_setup(dev, TRAIN_H, TRAIN_W, ITERS, True, SEED,
                               dw_impl)
    step = make_train_step(gamma=0.85, iters=ITERS)
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    m = step(state, batch)                       # warm-up
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"train step dw_impl={dw_impl!r} launches {json.dumps(counts)} "
        f"expected {json.dumps(expected)}")
    assert counts == expected, "train launch counts differ"
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    assert math.isfinite(loss) and math.isfinite(norm), (loss, norm)
    still = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    assert not still, f"parameters that did not move: {still[:5]}"
    ms = 1e3 * sum(times) / len(times)
    log(f"train step dw_impl={dw_impl!r} {B}x{T}x{TRAIN_H}x{TRAIN_W} iters "
        f"{ITERS} bf16 + f32 "
        f"params + remat: ms/step {ms:.3f} (mean of {TRAIN_STEPS} after a "
        f"warm-up, each {[round(1e3 * t, 3) for t in times]}); steps/s "
        f"{1e3 / ms:.4f}; max_memory_allocated {peak / 2 ** 30:.3f} GiB; "
        f"loss {loss:.6g} grad_norm {norm:.6g} epe {float(m['epe']):.6g}; "
        f"all {len(before)} parameters moved")
    profile_device(lambda: step(state, batch), ms, "train_step" + suffix)
    return counts


# ---------------------------------------------------------------- phase 8
def training_guard(dev, dw_impl) -> None:
    """One step's loss and gradients at GUARD_H x GUARD_W, SK layout
    ``dw_impl``: the kernel path
    on the card against the plain path on the CPU, f32 and bf16, each
    against the f32 plain path (same seeded weights and batch). The f32
    bound of each gradient is GRAD_TOL plus PERTURB_SLACK times that
    gradient's own sensitivity: its relative change on the f32 plain path
    when every weight moves by a relative 1e-6 (f32 rounding of the
    forward). A few gradients (the cnet's and the mask head's, ~1e-6 of
    the total norm) are sums that cancel, and 1e-6 moves them by ~3e-3;
    a kernel fault is O(1). All gradients together are held to
    GRAD_GLOBAL_TOL, below the perturbation's global change."""
    import torch

    from streamflow_tpu_torch.training.step import make_loss_fn

    loss_fn = make_loss_fn(gamma=0.85, iters=GUARD_ITERS)
    res = {}
    runs = [(False, "cpu", "cpu", 0.0), (False, "cpu+1e-6", "cpu", 1e-6),
            (False, "card", dev, 0.0), (True, "cpu", "cpu", 0.0),
            (True, "card", dev, 0.0)]
    for mp, path, where, eps in runs:
        state, batch = train_setup(where, GUARD_H, GUARD_W, GUARD_ITERS, mp,
                                   SEED + 3, dw_impl)
        model = state.model
        if eps:
            g = torch.Generator().manual_seed(SEED + 4)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + eps * torch.randn(p.shape, generator=g))
        loss, _ = loss_fn(model, batch)
        loss.backward()
        res[mp, path] = (float(loss.detach()),
                         {n: p.grad.detach().float().cpu()
                          for n, p in model.named_parameters()})
        del state, batch, model, loss
    ref_loss, ref = res[False, "cpu"]

    def errors(key):
        loss, grads = res[key]
        per = {n: float((grads[n] - ref[n]).norm()
                        / ref[n].norm().clamp(min=1e-30)) for n in ref}
        glob = float(torch.sqrt(sum((grads[n] - ref[n]).pow(2).sum()
                                    for n in ref))
                     / torch.sqrt(sum(ref[n].pow(2).sum() for n in ref)))
        return abs(loss - ref_loss) / abs(ref_loss), per, glob

    f32, pert = errors((False, "card")), errors((False, "cpu+1e-6"))
    slack = {n: f32[1][n] / (GRAD_TOL + PERTURB_SLACK * pert[1][n])
             for n in ref}
    worst = max(slack, key=slack.get)
    bf, bfp = errors((True, "card")), errors((True, "cpu"))

    def median(d):
        return sorted(d.values())[len(d) // 2]

    log(f"training guard dw_impl={dw_impl!r} {GUARD_H}x{GUARD_W} iters "
        f"{GUARD_ITERS} against "
        f"the f32 plain path (loss {ref_loss:.6g}): f32 kernels loss rel "
        f"err {f32[0]:.3e} (bound {GRAD_TOL}), gradients rel L2 global "
        f"{f32[2]:.3e} (bound {GRAD_GLOBAL_TOL}) median "
        f"{median(f32[1]):.3e} max "
        f"{max(f32[1].values()):.3e}; 1e-6 weight perturbation of the plain "
        f"path: global {pert[2]:.3e} median {median(pert[1]):.3e} max "
        f"{max(pert[1].values()):.3e}; closest to its bound {worst}: "
        f"{f32[1][worst]:.3e} against {GRAD_TOL} + {PERTURB_SLACK} x "
        f"{pert[1][worst]:.3e}; bf16 kernels loss {bf[0]:.3e} gradients "
        f"global {bf[2]:.3e} median {median(bf[1]):.3e}, bf16 plain loss "
        f"{bfp[0]:.3e} global {bfp[2]:.3e} median {median(bfp[1]):.3e} "
        f"(bounds: loss {GRAD_TOL}, global {BF16_GUARD_RATIO}x the plain)")
    # the loss is dominated by the ground truth (N(0, 4^2) px against
    # sub-px predictions), so both paths read ~1e-5: held to GRAD_TOL
    assert f32[0] < GRAD_TOL and slack[worst] <= 1.0, (f32[0], worst)
    assert f32[2] <= GRAD_GLOBAL_TOL, (f32[2], pert[2])
    assert bf[0] < GRAD_TOL, (bf[0], bfp[0])
    assert bf[2] <= BF16_GUARD_RATIO * bfp[2], (bf[2], bfp[2])


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "streamflow_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repo "
                         "(streamflow_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False)")
    dev = torch.device("cuda:0")
    os.makedirs(OUT_DIR, exist_ok=True)   # the log holds this run's lines
    open(os.path.join(OUT_DIR, "chip_smoke.log"), "w").close()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    log(f"phase 1 device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")

    from streamflow_tpu_torch import _build

    _build.library()
    log(f"phase 2 build: {_build.build_seconds:.1f} s")
    log(_build.ptxas_summary())
    ptxas = _build._BUILD / "ptxas.log"
    if ptxas.exists():   # nvcc's own lines, registers and spills per kernel
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as fh:
            fh.write(ptxas.read_text())

    t_start = time.perf_counter()
    # per path: its SK layout and its phases (kernel checks, forward or
    # train step); phases 3 and 6 time each kernel for both layouts
    summary = {path + LAYOUTS[dw][0]: new_summary()
               for path in ("inference", "train_step") for dw in LAYOUTS}
    counts = {}

    def phase(n, what, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"phase {n} {what}: passed ({time.perf_counter() - t0:.1f} s)")
        return out

    def per_layout(path):
        return {dw: summary[path + LAYOUTS[dw][0]] for dw in LAYOUTS}

    phase(3, "kernels", kernel_checks, dev, per_layout("inference"), 440,
          1024, False)
    refs, ms_clip = {}, {}
    counts["inference"], ms_clip["auto"] = phase(4, "forward", full_forward,
                                                 dev, "auto")
    phase(5, "accuracy guards", accuracy_guards, dev, "auto", refs)

    def training_kernels():
        kernel_checks(dev, per_layout("train_step"), TRAIN_H, TRAIN_W, True)
        backward_checks(dev, list(per_layout("train_step").values()))
    phase(6, "training-shape kernels", training_kernels)
    counts["train_step"] = phase(7, "train step", train_step_phase, dev,
                                 "auto")
    phase(8, "training guard", training_guard, dev, "auto")
    n = 9
    for dw in LAYOUTS:
        if dw == "auto":
            continue
        suffix, tag = LAYOUTS[dw][0], f" dw_impl={dw!r}"
        counts["inference" + suffix], ms_clip[dw] = phase(
            n, "forward" + tag, full_forward, dev, dw)
        phase(n + 1, "accuracy guards" + tag, accuracy_guards, dev, dw,
              refs)
        n += 2
        if dw in TRAINED:
            counts["train_step" + suffix] = phase(
                n, "train step" + tag, train_step_phase, dev, dw)
            phase(n + 1, "training guard" + tag, training_guard, dev, dw)
            n += 2
    log(f"phases 3-{n - 1}: {time.perf_counter() - t_start:.1f} s after the "
        f"build")
    log("ms/clip by SK layout (dw_impl), 440x1024 T=4 12 iterations bf16: "
        + json.dumps({dw: round(v, 3) for dw, v in ms_clip.items()}))

    assert "jax" not in sys.modules, "the port must not import jax"
    kernels = []
    for path, path_counts in counts.items():
        for k, (src, rep) in KERNELS.items():
            if not path_counts[k]:
                continue   # not on this path (B5 in inference, K5 default)
            s = summary[path][k]
            kernels.append({
                "name": k, "path": path, "route": "cuda", "source": src,
                "replaces": rep, "launches": path_counts[k],
                "max_abs_err": s["err"],
                "ms": round(s["ms"], 4), "plain_ms": round(s["plain_ms"], 4),
                "bound_ms": round(s["bound_ms"], 4),
                "bound_by": ("operations" if s["ops_ms"] >= s["mem_ms"]
                             else "bytes"),
                "library_ms": (None if s["library_ms"] is None
                               else round(s["library_ms"], 4)),
                **({"ms_by_traffic": {t: round(v, 4) for t, v in
                                      s["ms_by_traffic"].items()}}
                   if "ms_by_traffic" in s else {})})
    log(smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
