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
     yardstick; K7 also equal to K6 bit for bit) and K8 sk_chain_banded
     (cuDNN's conv beside it, as K5),
     and K5, K6, K7 and K8 also at the edges of their bf16 tiles (every
     odd k, each copy width, ragged H and W, B = 1 and 3, images smaller
     than the halo, K7's strips of several tiles and bands: CHAIN_EDGES);
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
  9-26. the other SK layouts (StreamFlowConfig.dw_impl), at the same sizes
     and depths: phases 4, 5, 7 and 8 again for 'pallas' (9-12: K2
     ffn_pair, K5 dw_chain, K2 pw_ffn_pair), 'banded_mxu' (13-16: K6 in
     place of K5), 'banded_chain' (17-20: K8) and 'banded_mxu_t' (21-24:
     K7), phases 4 and 5 for 'banded' (25-26: the banded composite, no dw
     kernel);
  27. the graphed forward (evaluation.GraphedForward: one CUDA graph per
     input shape) of phase 4's clip in 'auto', 'banded_chain' and
     'banded_mxu_t' (K7's persistent kernel under replay): the replay's
     flows against the eager forward's ('banded_mxu_t' bit for bit); the
     kernels of one
     profiled replay, by name, against EXPECTED_LAUNCHES (the Python
     launch counters count at capture, not at replay); ms/clip eager and
     graphed, each path's device time, idle share and peak memory; for
     'auto' also a KITTI bucket (375x1242 padded in 'kitti' mode to
     376x1248), the first bucket replayed again after it, a flow_init
     bucket against its eager call, and two replays on other clips that
     leave the first result unchanged; and, in a process of its own, a
     forward that cannot be captured makes GraphedForward raise;
  28. the serving harness: the validators' per-window steps (plain,
     warm-started and tiled windows; evaluation.py) on in-memory clips,
     three 436x1024 Sintel windows (one a tail window) and a 375x1242
     KITTI window in 432x960 tiles, graphed and eager: flows and metrics
     agree; the graphed side's launch counts (its warm-ups and captures)
     checked exactly;
  29. high resolution, the twin of tools/test_memory.py: 1080x1920 and
     1440x2560, T=4, 12 iterations, bf16, eager and graphed, as phase 27
     (finite flows, graph against eager, times, peak memory);
  30. the trainer (tools/train.py's loop, ``train``) at the sintel_kitti
     preset as given (B=8, 432x960, T=4, 12 iterations, bf16 with f32
     parameters, remat) on in-memory clips from the seed, after every
     kernel of its step and B5 against its plain version at B=8: 6 steps, a
     checkpoint and a validation (phase 28's Sintel windows through the
     run's one GraphedForward) at step 4; the loader's batches on the card
     equal to its numpy batches bit for bit; launches per step and of the
     validation checked exactly; finite loss and grad_norm; every
     parameter moves; the last checkpoint restored into a fresh state
     equal to the live one bit for bit, one more step from each giving the
     same loss; after the weights change and are copied in place, the held
     graph's replay equal to the eager forward; wall ms/step of the loop,
     device ms of a profiled step, idle share, peak memory, the
     checkpoint's save ms and size;
  31. the stage forms, one step each at B=1: things (T=3, 400x720), kitti
     (last pair only, 432x960) and bithings (T=3, the reversed clip folded
     into the batch), launches (derived from the shape), finite loss,
     every parameter moved; phase 8's training guard at T=3.
The line before the kernels line gives ms/clip for the six layouts and
the graphed 'auto'. The line before the last is a JSON object with one
entry per kernel and path ("inference": phases 3-4, per clip;
"train_step": phases 6-7, per step; "inference_dw_<layout>" and
"train_step_dw_<layout>": the same for each other layout, phases 3, 6
and that layout's forward and train step; "serving": phase 28's
launches, with phase 3's numbers per 440x1024 clip; "trainer": the
launches of phase 30's 6 steps, with phase 30's B=8 kernel numbers
summed over the same 6 steps, and its validation's launches apart under
"launches_validation"): "launches" is the
path's count, "ms", "plain_ms", "bound_ms" and "library_ms" are summed
over the same calls at the path's shapes (K1's under the jitter
traffic; its "ms_by_traffic" gives all three). The last line is {"ok":
true, "device": {...}}.
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
    "dw_banded_mxu_t": ("streamflow_tpu_torch/csrc/dw_banded_t.cu",
                        "streamflow_tpu/ops/pallas/_banded_dw_kernel.py:223"),
    "sk_chain_banded": ("streamflow_tpu_torch/csrc/dw_banded.cu",
                        "streamflow_tpu/ops/pallas/_banded_dw_kernel.py:343"),
}
# the Twins GSA blocks run K3 above this many tokens an image
# (layers/twins.py)
GSA_FLASH_TOKENS = 16384


def gsa_flash_blocks(t: int, h: int, w: int) -> int:
    """GSA blocks that run K3 on a T=t clip of padded size h x w: fnet on t
    frames and cnet on t - 1, each stacked along H, at stage 0 (1/4 of the
    size) and stage 1 (1/8): all 4 at 440x1024 and 432x960 with T=4, the
    two of stage 0 at 400x720 with T=3."""
    return sum(tt * (h // s) * (w // s) > GSA_FLASH_TOKENS
               for s in (4, 8) for tt in (t, t - 1))


def forward_launches(iters: int = ITERS, t: int = T, h: int = 440,
                     w: int = 1024) -> dict:
    """Launches of each kernel in one forward: K1 once per iteration; K2 2
    per SK block (6 blocks) per iteration + 8 Twins MLPs; K3 once per
    iteration (GMA) + once per GSA block above GSA_FLASH_TOKENS; K4 2 LGA
    blocks in each of fnet and cnet."""
    return dict(dict.fromkeys(KERNELS, 0), corr_lookup=iters,
                ffn_pair=12 * iters + 8,
                flash_attention=iters + gsa_flash_blocks(t, h, w),
                lga_attention=4)


def train_launches(t: int = T, h: int = 432, w: int = 960) -> dict:
    """Launches in one train step with remat: the refinement kernels run in
    the forward and again in each step's recompute (K1 2x12, K2 2x144 + the
    8 of the encoders, K3 2x12 GMA + the GSA calls), K4 once; B5's two
    kernels (dq pass, dk/dv pass) once per K3 forward that the loss
    reaches (12 GMA + the GSA calls). The batch size changes none."""
    gsa = gsa_flash_blocks(t, h, w)
    return dict(forward_launches(ITERS, t, h, w), corr_lookup=2 * ITERS,
                ffn_pair=2 * 12 * ITERS + 8,
                flash_attention=2 * ITERS + gsa,
                flash_attention_bwd=2 * (ITERS + gsa))


EXPECTED_LAUNCHES = forward_launches()
EXPECTED_TRAIN_LAUNCHES = train_launches()


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
# 15-16, 19-20, 23-24); the other runs its forward and accuracy guards
TRAINED = ("auto", "pallas", "banded_mxu", "banded_chain", "banded_mxu_t")

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

# K5-K8 beyond the main path's calls (phase 3, checked only; nb, h, w, c,
# ks; K6 and K7 take the kxk stage ks[-1] alone, K5 the even widths):
# every odd k, no k=1 stage and two, widths that take each copy width of
# the bf16 bodies (csrc/sk_chain.cuh; C % 8 == 0: 16-byte copies, K7's
# TMA; 324 and 36: 8-byte; 34: 4-byte; 35: 2-byte), H and W that fit no
# 32 x 32 tile, B = 1 and 3, images smaller than the halo, a grid smaller
# than the card; for K7's strips (csrc/dw_banded_t.cu: 16 channels, 56
# rows, runs of 16-column tiles), a row of tiles that ends in a part of
# one (200 columns), a strip of thirteen tiles that carries its halo to
# the last, a part one (3x54x200x640), and three bands (130 rows)
CHAIN_EDGES = [(3, 55, 128, 64, (1, k)) for k in (3, 5, 7, 9, 11, 13)] + [
    (3, 55, 128, 324, (15,)), (1, 55, 128, 384, (1, 1, 15)),
    (3, 54, 120, 640, (1, 1, 7)), (2, 54, 120, 36, (1, 15)),
    (1, 55, 128, 35, (1, 1, 9)), (1, 9, 40, 34, (1, 3)),
    (3, 7, 9, 40, (1, 15)), (1, 3, 5, 16, (11,)), (2, 1, 1, 24, (1, 5)),
    (1, 55, 200, 64, (15,)), (3, 54, 200, 640, (7,)),
    (1, 130, 70, 40, (1, 11))]


def chain_inputs(rnd, nb, h, w, c, ks, dt):
    """Seeded inputs of a K5, K6 or K8 call: x, the stages' weights and
    biases (the k=1 biases large enough that a halo of gelu(b) instead of
    0 shows)."""
    x = rnd(nb, h, w, c, dt=dt)
    ws = tuple(rnd(c, 1, k, k, scale=0.3 if k == 1 else 1 / k, dt=dt)
               for k in ks)
    bs = tuple(rnd(c, scale=0.5 if k == 1 else 0.1, dt=dt) for k in ks)
    return x, ws, bs


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
    """Fan-in-scaled random weights from ``seed``, the flow head's output
    layer scaled down (streamflow_tpu_torch/tools/common.py)."""
    from streamflow_tpu_torch.tools.common import init_weights as init

    init(model, seed)


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


def kernel_checks(dev, summaries, hp, wp, train, batch=1):
    """Every forward kernel against its plain version at the shapes of
    ``batch`` hp x wp clips (padded size, T frames), in f32 and bf16;
    per-kernel bf16 numbers summed into ``summaries[layout]`` (per SK
    layout among the keys of LAYOUTS; cases of no layout in
    ``summaries`` are left out) over the calls of one inference clip, or
    of one train step (``train``: the refinement kernels run twice,
    forward and remat's recompute, and K3 also returns its logsumexp).
    The tails of the kernels' tiles (cases of no calls) and the K6/K7
    identity are checked at batch=1 only: they do not depend on the
    batch."""
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

    def edge_case(kind, nb, h, w, c, ks):
        """K5, K6 or K7 (ks = (k,)) or K8 at an edge of its tiles or
        arguments (checked only)."""
        mod = K5 if kind == "dw_chain" else K6
        run, plain = getattr(mod, kind), getattr(mod, kind + "_plain")

        def make(dt):
            x, ws, bs = chain_inputs(rnd, nb, h, w, c, ks, dt)
            args = (x, ws[0], bs[0]) if kind.startswith("dw_banded") else (
                x, ws, bs, ks)
            return (lambda: run(*args), lambda: plain(*args), 0,
                    (x, *ws, *bs), None, None)
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
            bf, h, w, c, r = 3 * batch, h8, w8, 256, 4
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
    # (SK pairs, GMA, K1) run on batch*(T-1) frame pairs, the flow head's
    # pair on batch grids with the pairs in their channels; the Twins
    # encoders (fnet on T frames, cnet on T-1, stacked along H, of each
    # clip) at 1/4 (stage 0) and 1/8 (stage 1)
    h8, w8 = hp // 8, wp // 8
    h4, w4 = 2 * h8, 2 * w8
    path = ("train step" if train else "clip") + (
        f" of B={batch}" if batch > 1 else "")
    refine = 2 * ITERS if train else ITERS
    # the six SK blocks (c_in, out_dim, images, dw k): convc1, convc2,
    # convf2, conv, gru, flow_head; cases tagged with the SK layouts whose
    # path runs them (LAYOUTS' keys: the default "auto" and the pair
    # layouts, each with its own dw kernel, none for "banded")
    sk = [(324, 256, 3 * batch, 15), (256, 192, 3 * batch, 15),
          (128, 64, 3 * batch, 15), (256, 126, 3 * batch, 15),
          (640, 128, 3 * batch, 7), (384, 6, batch, 15)]
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
    for c, rows in ((128, batch * T * h4 * w4),
                    (128, batch * (T - 1) * h4 * w4),
                    (256, batch * T * h8 * w8),
                    (256, batch * (T - 1) * h8 * w8)):
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
    if not train:
        for nb, h, w, c, ks in CHAIN_EDGES:
            for kind in ("sk_chain_banded", "dw_chain", "dw_banded_mxu",
                         "dw_banded_mxu_t"):
                if kind == "dw_chain" and c % 2:
                    continue   # K5 reads channel pairs
                kks = ks[-1:] if kind.startswith("dw_banded") else ks
                cases.append((kind, f"edge {nb}x{h}x{w}x{c} ks {kks}",
                              edge_case(kind, nb, h, w, c, kks), 0, every))
    n = h8 * w8
    cases.append(("flash_attention", f"gma bh{3 * batch} n{n} m{n} d128",
                  flash_case((3 * batch, 1), n, n, 128), refine, every))
    # GSA: keys from a stride-sr conv of the frames stacked along H
    for stage, nh, sr, hh, ww in ((0, 4, 8, h4, w4), (1, 8, 4, h8, w8)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            n, m = t * hh * ww, (t * hh // sr) * (ww // sr)
            cases.append(("flash_attention",
                          f"gsa{stage} {enc} b{batch} h{nh} n{n} m{m} d32",
                          flash_case((batch, nh), n, m, 32), 1, every))
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
                          f"stage{stage} {enc} {batch}x{hq}x{wq}x{3 * c} "
                          f"h{nh}",
                          lga_case(hq, wq, c, nh, b=batch), 1, every))
    # K4's tails: one-window grids and a stage-1 grid, two images each
    for hq, wq, c, nh in ((7, 7, 128, 4), (7, 7, 256, 8), (14, 21, 256, 8)):
        cases.append(("lga_attention", f"tail b2 {hq}x{wq}x{3 * c} h{nh}",
                      lga_case(hq, wq, c, nh, b=2), 0, every))
    cases.append(("corr_lookup", f"{3 * batch}x{h8}x{w8}x256 4 levels r4",
                  corr_case(), refine, every, "jitter30"))
    # K1 under the other traffics (timed apart: the kernels line's ms is
    # the jitter30 case's), then checked only: the branches of its bf16
    # body (128-, 64- and 32-column planes, empty boxes, box rows of
    # several planes) at ragged sizes, channel counts that leave a part
    # or most of a 64-channel panel empty (96, 32), C = 128 and 512,
    # fewer levels, a smaller radius and a level of size zero
    for traffic in ("smooth", "uniform"):
        cases.append(("corr_lookup",
                      f"{traffic} {3 * batch}x{h8}x{w8}x256 4 levels r4",
                      corr_traffic_case(traffic, 3 * batch, h8, w8, 256,
                                        4, 4),
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
        layouts = tuple(lt for lt in layouts if lt in summaries)
        if not layouts or (batch > 1 and not calls):
            continue
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
    # K7 and K6 compute one function, their bf16 sums on the tensor cores
    # in one order (csrc/dw_banded_t.cu, csrc/sk_chain.cuh): bit for bit
    # at the path's shapes (one band of 56 rows), so that 'banded_mxu_t'
    # and 'banded_mxu' give the same forward
    if batch > 1 or "banded_mxu_t" not in summaries:
        return
    for c, _, pairs, k in sk:
        x, ws, bs = chain_inputs(rnd, pairs, h8, w8, c, (k,), torch.bfloat16)
        a7 = K6.dw_banded_mxu_t(x, ws[0], bs[0])
        a6 = K6.dw_banded_mxu(x, ws[0], bs[0])
        assert torch.equal(a7, a6), f"K7 differs from K6 at {tuple(x.shape)}"
    log(f"check dw_banded_mxu_t equals dw_banded_mxu bit for bit (bf16) at "
        f"the six SK blocks' {path} shapes")


# ---------------------------------------------------------------- phase 4/5
def make_clip(dev, h=H, w=W, mode="sintel", seed=SEED):
    """A seeded B x T x h x w clip of uint8-range values, padded in
    ``mode``, on ``dev``."""
    import torch

    from streamflow_tpu_torch.ops.padding import InputPadder

    g = torch.Generator().manual_seed(seed)
    imgs = torch.randint(0, 256, (B, T, h, w, 3), generator=g).float()
    padder = InputPadder((h, w, 3), mode=mode)
    imgs = padder.pad(imgs.reshape(B * T, h, w, 3))
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
    """Device time of one call of ``fn`` by kernel group (profiled after a
    traced warm-up call, tools/common.py::profiled); the idle share
    compares the summed device time with the unprofiled wall time."""
    from streamflow_tpu_torch.tools.common import device_events, profiled

    prof = profiled(fn)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=60)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as fh:
        fh.write(smi() + "\n" + table)
    total = 0.0
    by = {}
    for key, _, t in device_events(prof):
        if t <= 0:
            continue
        total += t
        key = key.lower()
        for pat, group in (("corr_lookup", "corr_lookup"),
                           ("ffn_pair", "ffn_pair"),
                           ("flash_fwd", "flash_fwd"),
                           ("dw_chain", "dw_chain"),
                           # the bf16 engine of K5, K6 and K8
                           ("sk_chain", "sk_chain"),
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
    from streamflow_tpu_torch.tools.common import rel_epe

    ref, ref_layout = refs["f32"]
    mag = ref.norm(dim=-1)
    f32 = rel_epe(flows["float32", "card"], ref)
    bf16, bf16_plain = (rel_epe(flows["bfloat16", where], ref)
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
def backward_checks(dev, summaries, batch=1) -> None:
    """B5, with K3's output and lse, against their plain versions at the
    training shapes of ``batch`` clips (f32, bf16; bf16 timed beside its
    bound and SDPA's backward, summed over one train step's calls into
    each of ``summaries``), and, at batch=1 only, B5's tails and each
    kernel wrapper's forward (f32, bf16) and gradient (f32) against its
    plain version: neither depends on the batch."""
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

    # GMA over 3 pairs a clip of (432/8) x (960/8) tokens; the four GSA
    # blocks (fnet on 4 frames, cnet on 3, stacked along H; keys from a
    # stride-sr conv, stage 0 sr 8, stage 1 sr 4), each above the
    # 16384-token switch; calls per train step
    h8, w8 = TRAIN_H // 8, TRAIN_W // 8
    cases = [("gma", (3 * batch, 1), h8 * w8, h8 * w8, 128, ITERS)]
    for stage, nh, sr, hh, ww in ((0, 4, 8, 2 * h8, 2 * w8),
                                  (1, 8, 4, h8, w8)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            cases.append((f"gsa{stage} {enc}", (batch, nh), t * hh * ww,
                          (t * hh // sr) * (ww // sr), 32, 1))
    # B5's tails (128 resident and 64 walked rows a block): one query row,
    # fewer keys than one tile, ragged query and key counts
    tails = (((1, 2), 1, 1000, 128), ((2, 1), 300, 50, 128),
             ((1, 2), 333, 777, 128), ((1, 4), 1, 70, 32),
             ((1, 4), 300, 50, 32), ((1, 8), 1001, 1313, 32))
    for bh_shape, n, m, d in tails if batch == 1 else ():
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
                    f"of B={batch} {calls}")
                del ref, qs, ks, vs
            del q, k, v, do, o, lse, o_p, lse_p, got, want
            torch.cuda.empty_cache()
    if batch > 1:
        return

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
def train_setup(dev, h, w, iters, mixed_precision, seed, dw_impl, t=T):
    """A TrainState holding a training model (SK layout ``dw_impl``, T=t)
    with the seeded weights, and a seeded synthetic batch (uint8-range
    images, N(0, 4^2) px flows)."""
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.tools.train_bench import synthetic_batch
    from streamflow_tpu_torch.training.state import TrainState

    cfg = StreamFlowConfig(T=t, iters=iters, mixed_precision=mixed_precision,
                           remat=True, dw_impl=dw_impl)
    model = create_model("streamflow", cfg=cfg, device=dev, train=True)
    init_weights(model, seed)
    state = TrainState.create(model, lr=1.75e-4, num_steps=180_000)
    return state, synthetic_batch(B, t, h, w, seed, dev)


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
def training_guard(dev, dw_impl, t=T) -> None:
    """One step's loss and gradients at GUARD_H x GUARD_W, T=t, SK layout
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
                                   SEED + 3, dw_impl, t)
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

    log(f"training guard dw_impl={dw_impl!r} T={t} {GUARD_H}x{GUARD_W} iters "
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


# ---------------------------------------------------------------- phase 27
# the serving phases' other shapes: a KITTI frame (padded in 'kitti' mode
# to 376x1248, or in 'kitti432' to 432x1248 for the tiled validator's
# 432x960 patches) and phase 29's high resolutions (multiples of 8)
KITTI_H, KITTI_W = 375, 1242
HIGH_RES = ((1080, 1920), (1440, 2560))


def node_kernel(name: str):
    """The port kernel (a key of KERNELS) of a CUDA kernel's name as the
    profiler gives it, mangled or not; None for PyTorch's and its
    libraries' kernels. The engine's kernel sk_chain_kernel<P, V> is K8,
    K5 or K6 by its policy P (csrc/sk_chain.cuh); dw_banded_t_kernel is
    K7 (csrc/dw_banded_t.cu). dw_banded_kernel is the f32 body of K6-K8
    (csrc/dw_banded.cu), which the bf16 forwards never run; it is counted
    as K7, whose f32 launch it is among others."""
    import re

    m = re.search(r"sk_chain_kernel(?:<|ILi)(\d)", name)
    if m:
        return ("sk_chain_banded", "dw_chain", "dw_banded_mxu")[
            int(m.group(1))]
    for pat, k in (("corr_lookup", "corr_lookup"), ("ffn_pair", "ffn_pair"),
                   ("flash_fwd", "flash_attention"),
                   ("lga_kernel", "lga_attention"),
                   ("dw_chain_kernel", "dw_chain"),
                   ("dw_banded_t_kernel", "dw_banded_mxu_t"),
                   ("dw_banded_kernel", "dw_banded_mxu_t")):
        if pat in name:
            return k
    return None


# throwaway kernels that open a counted call's profile window: its first
# kernels can go unrecorded even after a traced warm-up (on an H100 one
# 'auto' replay once lost its first ~50, 4 of them port kernels)
PROFILE_PAD = 256


def replay_kernel_counts(fn):
    """Kernels run by one profiled call of ``fn`` (a graph replay), by port
    kernel ({kernel: count}, the nonzero ones), and the count of all
    other kernels (PROFILE_PAD tiny PyTorch kernels run first in the same
    window, so that any it misses at its start are theirs)."""
    import torch

    from streamflow_tpu_torch.tools.common import device_events, profiled

    pad = torch.zeros(1, device="cuda")

    def padded():
        for _ in range(PROFILE_PAD):
            pad.add_(1)
        fn()

    counts, other = {}, 0
    for name, count, _ in device_events(profiled(padded)):
        k = node_kernel(name)
        if k is None:
            other += count
        else:
            counts[k] = counts.get(k, 0) + count
    return counts, other


def eager_then_graph(model, imgs, label):
    """The clip ``imgs`` through ``model`` eagerly (one call, then REPS
    timed), then through a GraphedForward of it (its first call warms up
    and captures, then REPS timed replays); each path profiled once
    (device time, idle share; OUT_DIR/profile_{eager,graph}_<label>.txt)
    and its peak memory (the graph's over its capture and replays).
    Returns (the GraphedForward, its flows, the eager flows, ms/clip
    graph)."""
    import torch

    from streamflow_tpu_torch.evaluation import GraphedForward
    from streamflow_tpu_torch.tools.common import host_ms

    def eager():
        return model(imgs, test_mode=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = eager()
    ms_e = host_ms(eager, REPS, imgs.device)
    peak_e = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd = GraphedForward(model, model.cfg.iters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = fwd(imgs)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    ms_g = host_ms(lambda: fwd(imgs), REPS, imgs.device)
    peak_g = torch.cuda.max_memory_allocated() / 2 ** 30
    prof_e = profile_device(eager, ms_e[0], f"eager_{label}")
    prof_g = profile_device(lambda: fwd(imgs), ms_g[0], f"graph_{label}")
    log(f"serving {label} dw_impl={model.cfg.dw_impl!r} "
        f"{tuple(imgs.shape)}: ms/clip eager {ms_e[0]:.3f} (mean of {REPS}, "
        f"min {ms_e[1]:.3f}), graph {ms_g[0]:.3f} (min {ms_g[1]:.3f}); "
        f"device ms eager {prof_e['total_ms']:.3f}, graph "
        f"{prof_g['total_ms']:.3f}; idle share eager {prof_e['idle']:.4f}, "
        f"graph {prof_g['idle']:.4f}; max_memory_allocated eager "
        f"{peak_e:.3f} GiB, graph {peak_g:.3f} GiB; first graphed call (2 "
        f"warm-ups + capture) {capture_s:.2f} s")
    return fwd, got, want, ms_g[0]


def check_nodes(fwd, imgs, dw_impl) -> None:
    """One replay of ``fwd``'s bucket of ``imgs`` runs each port kernel as
    many times as the eager forward launches it (LAYOUTS)."""
    got, other = replay_kernel_counts(lambda: fwd(imgs))
    want = {k: v for k, v in LAYOUTS[dw_impl][1].items() if v}
    log(f"graph dw_impl={dw_impl!r} kernel nodes in one replay "
        f"{json.dumps(got)} expected {json.dumps(want)} (and {other} "
        f"kernels of PyTorch and its libraries, {PROFILE_PAD} of them the "
        f"window's opening pad)")
    assert got == want, "the graph's kernels differ from the eager launches"


def graph_phase(dev) -> float:
    """The test-mode forward as GraphedForward captures it, 'auto',
    'banded_chain' and 'banded_mxu_t' at 440x1024: replays against the
    eager forward ('banded_mxu_t', whose K7 walks its strips in a fixed
    order with nothing in device memory to reset, bit for bit), kernel
    nodes against EXPECTED_LAUNCHES (one replay runs K7 72 times), times;
    for 'auto' also a KITTI bucket, a flow_init bucket and two replays that
    must not alias. Returns the 'auto' graph's ms/clip."""
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model

    imgs = make_clip(dev)
    ms = None
    for dw_impl in ("auto", "banded_chain", "banded_mxu_t"):
        model = create_model("streamflow", cfg=StreamFlowConfig(
            T=T, iters=ITERS, mixed_precision=True, dw_impl=dw_impl),
            device=dev)
        init_weights(model, SEED)
        fwd, got, want, ms_g = eager_then_graph(model, imgs,
                                                f"{dw_impl}_440x1024")
        tag = f"graph dw_impl={dw_impl!r}"
        check_close(f"{tag} 440x1024 flows vs eager", got, want,
                    torch.bfloat16)
        if dw_impl == "banded_mxu_t":
            assert torch.equal(got, want), "the graph's flows differ"
            again = fwd(imgs)
            assert torch.equal(again, got), "a second replay differs"
            log(f"{tag}: two replays give the eager flows bit for bit")
        check_nodes(fwd, imgs, dw_impl)
        if dw_impl != "auto":
            continue
        ms = ms_g
        kitti = make_clip(dev, KITTI_H, KITTI_W, "kitti", SEED + 3)
        assert kitti.shape[2:4] == (376, 1248), kitti.shape
        check_close(f"{tag} KITTI bucket {tuple(kitti.shape)} vs eager",
                    fwd(kitti), model(kitti, test_mode=True), torch.bfloat16)
        again = fwd(imgs)
        assert torch.equal(again, got), "the first bucket changed"
        g = torch.Generator(device=dev).manual_seed(SEED + 4)
        init = 2.0 * torch.randn(B, T - 1, imgs.shape[2] // 8,
                                 imgs.shape[3] // 8, 2, generator=g,
                                 device=dev)
        (gf, gl), (ef, el) = fwd(imgs, init), model(imgs, flow_init=init,
                                                     test_mode=True)
        check_close(f"{tag} flow_init bucket flows vs eager", gf, ef,
                    torch.bfloat16)
        check_close(f"{tag} flow_init bucket low-res flows vs eager", gl, el,
                    torch.bfloat16)
        other = make_clip(dev, seed=SEED + 5)
        first = fwd(imgs)
        kept = first.clone()
        second = fwd(other)
        assert torch.equal(first, kept) and torch.equal(first, got), (
            "a replay changed an earlier call's output")
        assert not torch.equal(first, second)
        log(f"{tag}: {len(fwd.buckets)} buckets (440x1024, 376x1248, "
            f"440x1024 with flow_init); the first bucket replays the same "
            f"flows after the others; an earlier output is unchanged by a "
            f"later replay")
        assert len(fwd.buckets) == 3, list(fwd.buckets)
    capture_failure_raises()
    return ms


# a forward that reads a value back to the host, which no graph can hold
CAPTURE_FAILS = """
import sys
import torch
from streamflow_tpu_torch.evaluation import GraphedForward

class HostRead(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(1, device="cuda"))

    def forward(self, images, iters=None, flow_init=None, test_mode=True):
        return images * self.w * float(images.sum())

try:
    GraphedForward(HostRead(), 1)(torch.ones(1, 4, 8, 8, 3, device="cuda"))
except RuntimeError as e:
    assert "capture of bucket" in str(e), e
    print(str(e).splitlines()[0][:300])
else:
    sys.exit("GraphedForward did not raise")
"""


def capture_failure_raises() -> None:
    """GraphedForward raises, naming the bucket, when a forward cannot be
    captured (run in a process of its own: a failed capture may leave its
    CUDA context unusable)."""
    res = subprocess.run([sys.executable, "-c", CAPTURE_FAILS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    log(f"graph: a forward that reads a value back to the host fails to "
        f"capture and GraphedForward raises: {res.stdout.strip()}")


# ---------------------------------------------------------------- phase 28
def memory_window(rng, h, w, ids) -> dict:
    """An eval window in memory, as the validators' datasets load one:
    uint8-range images, N(0, 4^2) px flows, 70% of pixels valid."""
    import numpy as np

    return {"images": rng.integers(0, 256, (T, h, w, 3)).astype(np.float32),
            "flows": 4.0 * rng.standard_normal((T - 1, h, w, 2)).astype(
                np.float32),
            "valids": (rng.random((T - 1, h, w)) < 0.7).astype(np.float32),
            "frame_ids": np.asarray(ids, np.int32)}


def sintel_windows(rng) -> list:
    """Three 436x1024 Sintel windows, the last a tail window whose two
    first pairs are marked -1 (counted by an earlier window)."""
    return [memory_window(rng, H, W, ids) for ids in
            ((0, 1, 2, 3), (3, 4, 5, 6), (-1, -1, 6, 7))]


def serving_phase(dev) -> dict:
    """The validators' per-window steps (evaluation.window_flows,
    warm_window_flows, tiled_window_flows, pair_epes, kitti_pair_metrics)
    on in-memory clips: three 436x1024 Sintel windows (the last a tail
    window with two pairs marked -1), the same three warm-started, and
    one 375x1242 KITTI window tiled in 432x960 patches; through a
    GraphedForward ('auto'), then through the eager forward. Flows and
    metrics must agree. Returns the launch counts of the graphed side
    (its warm-ups and captures: replays make no wrapper call)."""
    import numpy as np
    import torch

    from streamflow_tpu_torch import evaluation as ev
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=ITERS, mixed_precision=True), device=dev)
    init_weights(model, SEED)
    rng = np.random.default_rng(SEED + 6)
    sintel = sintel_windows(rng)
    kitti = memory_window(rng, KITTI_H, KITTI_W, (8, 9, 10, 11))

    def run(fwd):
        flows = [ev.window_flows(fwd, s["images"], dev) for s in sintel]
        warm, warm_flows = None, []
        for s in sintel:
            f, warm = ev.warm_window_flows(fwd, s["images"], dev, warm)
            warm_flows.append(f)
        tiled = ev.tiled_window_flows(fwd, kitti["images"], dev)
        return flows, warm_flows, tiled

    fwd = ev.GraphedForward(model, ITERS)
    reset_launches()
    graphed = run(fwd)
    counts = dict(LAUNCHES)
    eager = run(lambda x, flow_init=None: model(
        x, flow_init=flow_init, test_mode=True))
    names = [f"sintel window {i}" for i in range(3)]
    names += [f"warm window {i}" for i in range(3)] + ["tiled KITTI window"]
    for name, got, want in zip(names, [*graphed[0], *graphed[1], graphed[2]],
                               [*eager[0], *eager[1], eager[2]]):
        check_close(f"serving {name} flows, graph vs eager",
                    torch.from_numpy(got), torch.from_numpy(want),
                    torch.bfloat16)

    def metrics(run_out):
        flows, warm_flows, tiled = run_out
        epe = np.concatenate([e for f, s in zip(flows, sintel)
                              for e in ev.pair_epes(f, s, T)])
        warm = np.concatenate([e for f, s in zip(warm_flows, sintel)
                               for e in ev.pair_epes(f, s, T)])
        k_epe, k_out = ev.kitti_pair_metrics(tiled, kitti, T)
        return {"epe": float(epe.mean()), "1px": float((epe < 1).mean()),
                "pairs_px": int(epe.size), "warm_epe": float(warm.mean()),
                "kitti_tile_epe": float(k_epe),
                "kitti_tile_f1": float(100 * k_out.mean())}

    got, want = metrics(graphed), metrics(eager)
    log(f"serving harness metrics, graph {json.dumps(got)}; eager "
        f"{json.dumps(want)}; buckets {[b[0] for b in fwd.buckets]}")
    assert got["pairs_px"] == 7 * H * W, got   # 3 + 3 + 1 pairs counted
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v), (k, got[k], v)
    # three buckets (440x1024, the same with flow_init, the 432x960 tile),
    # each two warm-ups and one capture
    assert len(fwd.buckets) == 3, list(fwd.buckets)
    expected = {k: 9 * v for k, v in EXPECTED_LAUNCHES.items()}
    log(f"serving launches (warm-ups and captures) {json.dumps(counts)} "
        f"expected {json.dumps(expected)}")
    assert counts == expected, "launch counts differ"
    return counts


# ---------------------------------------------------------------- phase 29
def high_res_phase(dev) -> None:
    """The twin of tools/test_memory.py: 1080x1920 and 1440x2560 clips,
    T=4, 12 iterations, bf16, 'auto', eager then graphed (times, device
    time, idle share, peak memory); finite flows, graph equal to eager."""
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model

    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=ITERS, mixed_precision=True), device=dev)
    init_weights(model, SEED)
    for h, w in HIGH_RES:
        imgs = make_clip(dev, h, w)
        fwd, got, want, _ = eager_then_graph(model, imgs, f"{h}x{w}")
        assert got.shape == (B, T - 1, h, w, 2), got.shape
        assert bool(torch.isfinite(got).all()), "non-finite flows"
        check_close(f"graph {h}x{w} flows vs eager", got, want,
                    torch.bfloat16)
        del fwd, got, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 30
# the trainer's run: steps, and the step of its one mid-run checkpoint and
# validation; metrics read every TRAINER_PRINT steps
TRAINER_STEPS, TRAINER_PRINT, TRAINER_VAL = 6, 2, 4
TRAINER_DIR = os.path.join(ROOT, "build", "chip_smoke_trainer")


class MemoryClips:
    """A training dataset in memory with the loader's interface (``len``,
    ``load(index, rng)``): each clip drawn from the generator the loader
    hands it at the preset's crop size, uint8-range images, N(0, 4^2) px
    flows, 90% of pixels valid; with ``bidir`` the backward flows too (the
    bithings keys). No files, no augmentor."""

    def __init__(self, n, t, h, w, bidir=False):
        self.n, self.t, self.h, self.w, self.bidir = n, t, h, w, bidir

    def __len__(self):
        return self.n

    def load(self, index, rng):
        import numpy as np

        f, h, w = self.t - 1, self.h, self.w

        def flows():
            return 4.0 * rng.standard_normal((f, h, w, 2), np.float32)

        def valids():
            return (rng.random((f, h, w), np.float32) < 0.9).astype(
                np.float32)

        s = {"images": rng.integers(0, 256, (self.t, h, w, 3),
                                    np.uint8).astype(np.float32),
             "flows": flows(), "valids": valids()}
        if self.bidir:
            s["flows_bw"], s["valids_bw"] = flows(), valids()
        return s


def trainer_phase(dev) -> tuple:
    """The trainer's own loop (tools/train.py::train) at the sintel_kitti
    preset as given (B=8, 432x960, T=4, 12 iterations, lr 1.75e-4, gamma
    0.85, bf16 with f32 parameters and remat) on in-memory clips, for
    TRAINER_STEPS steps, checkpointing and validating (phase 28's Sintel
    windows, through the run's one GraphedForward) at step TRAINER_VAL.
    First every kernel of the step, and B5, against its plain version at
    the preset's batch (phase 6's checks at B=8), timed per step. Checks:
    the loader's batches on the card equal its numpy batches bit for bit;
    launches per step; finite loss and grad_norm; every parameter moved;
    the checkpoint restored into a fresh state equals the live one bit for
    bit, and one more step from each gives the same loss; after the
    weights change and are copied in place, the held graph's replay equals
    the eval model's eager forward. Logs wall ms/step of the loop, device
    ms of one profiled step, idle share, peak memory, the checkpoint's
    save ms and size. Returns the launches of the run's steps, those of
    its validation, and the kernels' numbers summed over the run's
    steps."""
    import itertools
    import shutil

    import numpy as np
    import torch

    from streamflow_tpu_torch import evaluation as ev
    from streamflow_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.tools import train as trainer
    from streamflow_tpu_torch.training.checkpoint import CheckpointManager
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step

    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    args = trainer.parse_args([
        "--preset", "sintel_kitti", "--validation", "sintel",
        "--num_steps", str(TRAINER_STEPS), "--print_freq", str(TRAINER_PRINT),
        "--val_freq", str(TRAINER_VAL), "--output", TRAINER_DIR])
    h, w = args.image_size
    b, t = args.batch_size, args.T
    assert (b, t, h, w, args.iters, args.lr, args.gamma, args.stage) == (
        8, 4, 432, 960, ITERS, 1.75e-4, 0.85, "sintel"), vars(args)
    assert args.mixed_precision and args.device == "cuda"

    # the step's kernels at the trainer's shapes, timed per step, then
    # summed over the run's steps (the calls its launches count)
    per_step_summary = {"auto": new_summary()}
    kernel_checks(dev, per_step_summary, h, w, True, batch=b)
    backward_checks(dev, list(per_step_summary.values()), batch=b)
    steps_summary = per_step_summary["auto"]
    for s in steps_summary.values():
        for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "mem_ms"):
            s[k] *= TRAINER_STEPS
        if s["library_ms"] is not None:
            s["library_ms"] *= TRAINER_STEPS
        for k in s.get("ms_by_traffic", {}):
            s["ms_by_traffic"][k] *= TRAINER_STEPS

    dataset = MemoryClips(8 * b, t, h, w)

    # the loader's first batches (the run's: same dataset, batch and seed)
    # through the prefetch ring of 3 pinned buffers, the fourth refilling
    # the first's
    loader = DataLoader(dataset, b, num_workers=args.num_workers,
                        seed=args.seed)
    host = list(itertools.islice(loader.epoch(0), 4))
    for i, got in enumerate(prefetch_to_device(iter(host), dev)):
        for k, v in host[i].items():
            assert got[k].device == dev and torch.equal(
                got[k].cpu(), torch.from_numpy(v)), (i, k)
    first = {k: torch.from_numpy(v).to(dev) for k, v in host[0].items()}
    log(f"trainer: the loader's first 4 batches ({b}x{t}x{h}x{w}) through "
        f"prefetch_to_device equal its numpy batches bit for bit")

    windows = sintel_windows(np.random.default_rng(SEED + 6))
    val_counts = dict.fromkeys(KERNELS, 0)

    def validate(fwd):
        before = dict(LAUNCHES)
        epes = np.concatenate([
            e for s in windows
            for e in ev.pair_epes(ev.window_flows(fwd, s["images"], dev), s,
                                  t)])
        for k in KERNELS:
            val_counts[k] += LAUNCHES[k] - before[k]
        return {"clean_epe": float(epes.mean()),
                "clean_1px": float((epes < 1).mean()),
                "clean_3px": float((epes < 3).mean()),
                "clean_5px": float((epes < 5).mean())}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    run = trainer.train(args, dataset, validate)
    run_s = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = train_launches(t, h, w)
    assert per_step == EXPECTED_TRAIN_LAUNCHES
    # the windows' bucket (padded to 440x1024): 2 warm-ups and the capture
    want_val = {k: 3 * v for k, v in forward_launches(
        args.val_iters, t, -(-H // 8) * 8, W).items()}
    steps_counts = {k: counts[k] - val_counts[k] for k in KERNELS}
    log(f"trainer launches: {TRAINER_STEPS} steps "
        f"{json.dumps(steps_counts)} expected {TRAINER_STEPS} x "
        f"{json.dumps(per_step)}; validation {json.dumps(val_counts)} "
        f"expected {json.dumps(want_val)}")
    assert steps_counts == {k: TRAINER_STEPS * v
                            for k, v in per_step.items()}, "step launches"
    assert val_counts == want_val, "validation launches"

    state = run.state
    assert state.step == TRAINER_STEPS and len(run.step_t) == TRAINER_STEPS
    out = os.path.join(TRAINER_DIR, args.name)
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    train_rec = [r for r in records if "loss" in r]
    assert [r["step"] for r in train_rec] == list(
        range(TRAINER_PRINT, TRAINER_STEPS + 1, TRAINER_PRINT)), records
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in train_rec), train_rec
    assert [r["step"] for r in records if "val" in r] == [TRAINER_VAL]
    assert os.path.exists(os.path.join(out, "best.npz"))
    assert math.isfinite(run.val["clean_epe"]), run.val

    # every parameter moved from the seeded start
    fresh = create_model("streamflow", cfg=state.model.cfg, device=dev,
                         train=True)
    init_weights(fresh, args.seed)
    still = [n for (n, p), q in zip(state.model.named_parameters(),
                                    fresh.parameters()) if torch.equal(p, q)]
    assert not still, f"parameters that did not move: {still[:5]}"

    # the last checkpoint (step TRAINER_STEPS, written by the final save)
    # restored into a fresh state equals the live state bit for bit
    mgr = CheckpointManager(os.path.join(out, "ckpts"))
    assert mgr.all_steps() == [TRAINER_VAL, TRAINER_STEPS], mgr.all_steps()
    restored = mgr.restore(TrainState.create(
        fresh, args.lr, args.num_steps, args.wdecay, args.epsilon, args.clip))
    for (n, p), q in zip(state.model.named_parameters(),
                         restored.model.parameters()):
        assert torch.equal(p, q), n
    live_opt = state.optimizer.state_dict()["state"]
    rest_opt = restored.optimizer.state_dict()["state"]
    assert live_opt.keys() == rest_opt.keys()
    for i, st in live_opt.items():
        for k, v in st.items():
            assert torch.equal(v, rest_opt[i][k]), (i, k)
    saved = (restored.step, restored.lr, restored.scheduler.last_epoch)
    assert saved == (state.step, state.lr, state.scheduler.last_epoch)
    step = make_train_step(args.gamma, args.iters)
    m_live, m_rest = step(state, first), step(restored, first)
    l_live, l_rest = float(m_live["loss"]), float(m_rest["loss"])
    rel = abs(l_rest - l_live) / abs(l_live)
    log(f"trainer checkpoint: step {TRAINER_STEPS} restored into a fresh "
        f"state equals the live one bit for bit ({len(live_opt)} parameters "
        f"with their AdamW moments and step counts; step, lr, last_epoch "
        f"{saved}); one more "
        f"step: loss live {l_live!r} restored {l_rest!r}, rel diff "
        f"{rel:.3e} (bound {GRAD_TOL}), grad_norm "
        f"{float(m_live['grad_norm']):.6g} / "
        f"{float(m_rest['grad_norm']):.6g}")
    assert rel <= GRAD_TOL, (l_live, l_rest)

    # the held graph reads the eval model's weights by address: after the
    # weights change, copied in place, its replay is the eager forward
    fwd = run.fwd
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    with torch.no_grad():
        for p in restored.model.parameters():
            p.add_(0.05 * p.abs().mean() * torch.randn(
                p.shape, generator=g, device=dev))
    img = windows[0]["images"]
    stale = ev.window_flows(fwd, img, dev)
    fwd.model.load_state_dict(restored.model.state_dict())
    got = ev.window_flows(fwd, img, dev)
    want = ev.window_flows(lambda x: fwd.model(x, iters=args.val_iters,
                                               test_mode=True), img, dev)
    err = check_close("trainer graph after the in-place copy vs eager",
                      torch.from_numpy(got), torch.from_numpy(want),
                      torch.bfloat16)
    stale_err = float(np.abs(stale - want).max())
    log(f"trainer graph: replay before the copy differs from the eager "
        f"forward by {stale_err:.4g} px, after it by {err:.4g}")
    assert stale_err > 10 * max(err, 1e-3), (stale_err, err)
    del restored, fresh, m_rest

    # times: the loop between the synchronizing prints of steps
    # TRAINER_PRINT and TRAINER_STEPS, less the checkpoint and validation
    n = TRAINER_STEPS - TRAINER_PRINT
    loop_ms = 1e3 * (run.step_t[-1] - run.step_t[TRAINER_PRINT - 1]
                     - run.save_s[0] - run.val_s[0]) / n
    prof = profile_device(lambda: step(state, first), loop_ms, "trainer")
    timing = CheckpointManager(os.path.join(TRAINER_DIR, "timing"))
    t0 = time.perf_counter()
    timing.save(state)
    snap_ms = 1e3 * (time.perf_counter() - t0)
    timing.wait_until_finished()
    write_ms = 1e3 * (time.perf_counter() - t0) - snap_ms
    size = os.path.getsize(timing.path(state.step))
    log(f"trainer {b}x{t}x{h}x{w} iters {args.iters} bf16 + f32 params + "
        f"remat, {TRAINER_STEPS} steps in {run_s:.1f} s: wall ms/step of the "
        f"loop {loop_ms:.3f} (steps {TRAINER_PRINT + 1}-{TRAINER_STEPS}, "
        f"checkpoint and validation taken out), device ms/step "
        f"{prof['total_ms']:.3f}, idle share {prof['idle']:.4f}; "
        f"max_memory_allocated {peak:.3f} GiB; checkpoint "
        f"{size / 2 ** 20:.1f} MiB: in the loop {1e3 * run.save_s[0]:.1f} ms "
        f"(host copy; write on a thread), final save (waited) "
        f"{1e3 * run.save_s[-1]:.1f} ms, alone host copy {snap_ms:.1f} ms + "
        f"write {write_ms:.1f} ms; validation (3 windows, capture of a "
        f"{args.val_iters}-iteration graph) {run.val_s[0]:.2f} s; val "
        f"{json.dumps(run.val)}")
    del run, state, fwd
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return steps_counts, val_counts, steps_summary


# ---------------------------------------------------------------- phase 31
def stage_forms_phase(dev) -> None:
    """One step each, B=1, of the stage forms the trainer selects at its
    presets' crops: things (T=3, 400x720), kitti (the sintel_kitti crop,
    T=4, 432x960, last pair only) and bithings (T=3, 400x720, the
    time-reversed clip folded into the batch); launches (derived from the
    shape: at 400x720, T=3 only stage 0's GSA blocks run K3), finite loss,
    every parameter moved. Then phase 8's training guard at T=3."""
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.tools import train as trainer
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step

    for preset, stage in (("things", "things"), ("sintel_kitti", "kitti"),
                          ("bithings", "bithings")):
        args = trainer.parse_args(["--preset", preset, "--stage", stage,
                                   "--batch_size", "1"])
        h, w = args.image_size
        t = args.T
        bidir = stage == "bithings"
        cfg = StreamFlowConfig(T=t, iters=args.iters,
                               mixed_precision=args.mixed_precision,
                               remat=True)
        model = create_model("streamflow", cfg=cfg, device=dev, train=True)
        init_weights(model, SEED)
        state = TrainState.create(model, args.lr, args.num_steps, args.wdecay,
                                  args.epsilon, args.clip)
        loader = DataLoader(MemoryClips(1, t, h, w, bidir), 1,
                            num_workers=1, seed=args.seed)
        batch = next(iter(prefetch_to_device(loader.epoch(0), dev)))
        step = make_train_step(args.gamma, args.iters,
                               kitti_last_pair_only=stage == "kitti",
                               bidirectional=bidir)
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(LAUNCHES)
        expected = train_launches(t, h, w)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        still = [n for (n, p), q in zip(model.named_parameters(), before)
                 if torch.equal(p, q)]
        log(f"stage {stage} (preset {preset}) B=1{'+1 reversed' * bidir} "
            f"T={t} {h}x{w}: launches {json.dumps(counts)} expected "
            f"{json.dumps(expected)}; loss {loss:.6g} grad_norm {norm:.6g} "
            f"epe {float(m['epe']):.6g}"
            + (f" epe_bw {float(m['epe_bw']):.6g}" if bidir else "")
            + f"; {len(before) - len(still)} of {len(before)} parameters "
            f"moved; first step {ms:.1f} ms")
        assert counts == expected, "launch counts differ"
        assert math.isfinite(loss) and math.isfinite(norm), (loss, norm)
        assert not still, f"parameters that did not move: {still[:5]}"
        del model, state, batch, m, before
        torch.cuda.empty_cache()
    training_guard(dev, "auto", t=3)


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
    ms_graph = phase(27, "graphed forward", graph_phase, dev)
    counts["serving"] = phase(28, "serving harness", serving_phase, dev)
    summary["serving"] = summary["inference"]
    phase(29, "high resolution", high_res_phase, dev)
    counts["trainer"], trainer_val, summary["trainer"] = phase(
        30, "trainer", trainer_phase, dev)
    phase(31, "stage forms", stage_forms_phase, dev)
    log(f"phases 3-31: {time.perf_counter() - t_start:.1f} s after the "
        f"build")
    log("ms/clip by SK layout (dw_impl), 440x1024 T=4 12 iterations bf16: "
        + json.dumps({dw: round(v, 3) for dw, v in ms_clip.items()})
        + f"; 'auto' graphed {ms_graph:.3f}")

    assert "jax" not in sys.modules, "the port must not import jax"
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("streamflow_tpu", "PIL", "cv2")]
    assert not loaded, f"chip_smoke's path loaded {loaded[:5]}"
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
                   if "ms_by_traffic" in s else {}),
                **({"launches_validation": trainer_val[k]}
                   if path == "trainer" else {})})
    log(smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
