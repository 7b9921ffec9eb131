#!/usr/bin/env python3
"""Smoke test of streamflow_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py      (from the root of a checkout, one GPU)

Phases, each printed on its own line; any failure raises (exit code != 0):
  1. device check (CUDA required; card name and power limit; TF32 off);
  2. kernel build (nvcc, from csrc/, into build/streamflow_tpu_torch/);
  3. every kernel against its plain PyTorch version, on the card, at the
     main path's shapes, in f32 and bf16, with times from CUDA events;
  4. the full forward: StreamFlow, seeded random weights, 436x1024 padded
     to 440x1024, B=1, T=4, 12 iterations, bf16, test mode; launch counts
     of every kernel checked exactly; ms/clip, frames/s, peak memory; a
     torch.profiler breakdown of one forward (table in chiprun_out/);
  5. accuracy guards: the same clip at iters=1 through the kernel path on
     the card and the plain path on the CPU, in f32 and in bf16, relative
     EPE against the f32 plain path bounded.
The line before the last is a JSON object with one entry per kernel, the
last line {"ok": true, "device": {...}}.
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
    "lga_attention": ("streamflow_tpu_torch/csrc/lga_attn.cu",
                      "streamflow_tpu/ops/pallas/_lga_kernel.py:116"),
}
# launches of each kernel in one 12-iteration forward: K1 once per
# iteration; K2 2 per SK block (6 blocks) per iteration + 8 Twins MLPs;
# K3 12 GMA + 4 GSA; K4 2 LGA blocks in each of fnet and cnet
EXPECTED_LAUNCHES = {"corr_lookup": ITERS, "ffn_pair": 12 * ITERS + 8,
                     "flash_attention": ITERS + 4, "lga_attention": 4}


def log(msg: str) -> None:
    print(msg, flush=True)


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
def kernel_checks(dev):
    """Returns {kernel: {"err": max abs err (bf16), "ms": ..., "plain_ms":
    ...}} with times summed over one clip's calls at each shape."""
    import torch

    from streamflow_tpu_torch.ops.corr import pool_pyramid
    from streamflow_tpu_torch.ops.coords import coords_grid
    from streamflow_tpu_torch.ops.kernels import corr_lookup as K1
    from streamflow_tpu_torch.ops.kernels import ffn_pair as K2
    from streamflow_tpu_torch.ops.kernels import flash_attention as K3
    from streamflow_tpu_torch.ops.kernels import lga_attention as K4

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dt)

    def ffn_case(variant, rows, c, ch, co):
        def make(dt):
            w = lambda i, o: rnd(o, i, scale=i ** -0.5, dt=dt)  # noqa: E731
            b = lambda n: rnd(n, scale=0.1, dt=dt)  # noqa: E731
            x = rnd(rows, c, dt=dt)
            if variant == "ffn_pair_k1":
                args = (x, w(c, ch), b(ch), w(ch, co), b(co),
                        rnd(co, scale=0.3, dt=dt), b(co))
                return (lambda: K2.ffn_pair_k1(*args),
                        lambda: K2.ffn_pair_plain(*args[:5], True,
                                                  kw=args[5], kb=args[6]))
            if variant == "dwres_pw_ffn_pair":
                args = (x, rnd(rows, c, dt=dt), b(c), w(c, c), b(c),
                        w(c, ch), b(ch), w(ch, co), b(co))
                return (lambda: K2.dwres_pw_ffn_pair(*args),
                        lambda: K2.ffn_pair_plain(
                            x, *args[5:], False, wp=args[3], bp=args[4],
                            yres=args[1], db=args[2]))
            args = (x, 1.0 + rnd(c, scale=0.1, dt=dt), b(c), w(c, ch),
                    b(ch), w(ch, co), b(co))
            return (lambda: K2.ln_ffn_pair(*args),
                    lambda: K2.ffn_pair_plain(x, *args[3:], False,
                                              ln=args[1:3], add_res=True))
        return make

    def flash_case(bh_shape, n, m, d):
        def make(dt):
            q = rnd(*bh_shape, n, d, scale=d ** -0.5, dt=dt)
            k, v = rnd(*bh_shape, m, d, dt=dt), rnd(*bh_shape, m, d, dt=dt)
            return (lambda: K3.flash_attention(q, k, v),
                    lambda: K3.flash_attention_plain(q, k, v))
        return make

    def lga_case(hp, wp, c, nh):
        def make(dt):
            qkv = rnd(1, hp, wp, 3 * c, dt=dt)
            return (lambda: K4.lga_attention(qkv, 7, nh),
                    lambda: K4.lga_attention_plain(qkv, 7, nh))
        return make

    def corr_case():
        def make(dt):
            bf, h, w, c = 3, 55, 128, 256
            f1 = rnd(bf, h, w, c, dt=dt)
            levels = [lv.contiguous() for lv in
                      pool_pyramid(rnd(bf, h, w, c, dt=dt), 4)]
            coords = coords_grid(bf, h, w, dev) + 30.0 * (
                2 * torch.rand(bf, h, w, 2, generator=g, device=dev) - 1)
            coords[0, :4] = torch.tensor([1e4, -1e4], device=dev)  # far out
            coords[1, :2] = torch.tensor([-20.0, 70.0], device=dev)
            coords = coords.contiguous()
            return (lambda: K1.corr_lookup(f1, levels, coords, 4),
                    lambda: K1.corr_lookup_plain(f1, levels, coords, 4))
        return make

    sk = [(324, 256, 21120), (256, 192, 21120), (128, 64, 21120),
          (256, 126, 21120), (640, 128, 21120), (384, 6, 7040)]
    cases = []  # (kernel, label, make, calls per clip)
    for c, co, rows in sk:
        ch = int(1.5 * c)
        cases.append(("ffn_pair", f"ffn_pair_k1 {rows}x{c}-{ch}-{c}",
                      ffn_case("ffn_pair_k1", rows, c, ch, c), ITERS))
        cases.append(("ffn_pair", f"dwres_pw_ffn_pair {rows}x{c}-{ch}-{co}",
                      ffn_case("dwres_pw_ffn_pair", rows, c, ch, co), ITERS))
    for c, rows in ((128, 112640), (128, 84480), (256, 28160), (256, 21120)):
        cases.append(("ffn_pair", f"ln_ffn_pair {rows}x{c}-{4 * c}-{c}",
                      ffn_case("ln_ffn_pair", rows, c, 4 * c, c), 2))
    cases += [
        ("flash_attention", "gma bh3 n7040 m7040 d128",
         flash_case((3, 1), 7040, 7040, 128), ITERS),
        ("flash_attention", "gsa0 fnet h4 n112640 m1760 d32",
         flash_case((1, 4), 112640, 1760, 32), 1),
        ("flash_attention", "gsa0 cnet h4 n84480 m1312 d32",
         flash_case((1, 4), 84480, 1312, 32), 1),
        ("flash_attention", "gsa1 fnet h8 n28160 m1760 d32",
         flash_case((1, 8), 28160, 1760, 32), 1),
        ("flash_attention", "gsa1 cnet h8 n21120 m1312 d32",
         flash_case((1, 8), 21120, 1312, 32), 1),
        ("flash_attention", "padded kv h2 n300 m1000 d128",
         flash_case((1, 2), 300, 1000, 128), 0),
        ("lga_attention", "stage0 fnet 441x259x384 h4",
         lga_case(441, 259, 128, 4), 1),
        ("lga_attention", "stage0 cnet 336x259x384 h4",
         lga_case(336, 259, 128, 4), 1),
        ("lga_attention", "stage1 fnet 224x133x768 h8",
         lga_case(224, 133, 256, 8), 1),
        ("lga_attention", "stage1 cnet 168x133x768 h8",
         lga_case(168, 133, 256, 8), 1),
        ("corr_lookup", "3x55x128x256 4 levels r4", corr_case(), ITERS),
    ]

    summary = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in KERNELS}
    for kernel, label, make, calls in cases:
        for dt in (torch.float32, torch.bfloat16):
            run, plain = make(dt)
            got, want = run(), plain()
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype, (
                label, got.shape, want.shape, got.dtype, want.dtype)
            want_abs = want.float().abs()
            top = float(want_abs.max())
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            rel = err / max(top, 1e-30)
            if dt == torch.float32:
                bound = F32_TOL + F32_TOL * want_abs
                rule = f"atol = rtol = {F32_TOL}"
            else:
                bound = (BF16_ULPS * bf16_ulp(want_abs)
                         + BF16_FLOOR * top)
                rule = (f"{BF16_ULPS} ulp + 2^-9 max|plain|; err = "
                        f"{err / float(bf16_ulp(torch.tensor(top))):.3g} "
                        f"ulp of max|plain|")
            ok = bool((diff <= bound).all())
            line = (f"check {kernel} [{label}] {str(dt)[6:]}: max_abs_err "
                    f"{err:.3e} max_rel_err {rel:.3e} ({rule}; |plain| max "
                    f"{top:.3e})")
            if dt == torch.bfloat16:
                ms, pms = cuda_ms(run, REPS), cuda_ms(plain, REPS)
                line += f" kernel {ms:.4f} ms plain {pms:.4f} ms"
                s = summary[kernel]
                s["err"] = max(s["err"], err)
                s["ms"] += calls * ms
                s["plain_ms"] += calls * pms
            log(line)
            if not ok or not math.isfinite(err):
                raise AssertionError(f"{kernel} [{label}] {dt} disagrees "
                                     f"with its plain version: {line}")
            del got, want, diff, want_abs, bound
        torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------- phase 4/5
def make_clip(dev):
    import torch

    from streamflow_tpu_torch.ops.padding import InputPadder

    g = torch.Generator().manual_seed(SEED)
    imgs = torch.randint(0, 256, (B, T, H, W, 3), generator=g).float()
    padder = InputPadder((H, W, 3), mode="sintel")
    imgs = padder.pad(imgs.reshape(B * T, H, W, 3))
    return imgs.reshape(B, T, *padder.padded_shape, 3).to(dev)


def full_forward(dev):
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    cfg = StreamFlowConfig(T=T, iters=ITERS, mixed_precision=True)
    model = create_model("streamflow", cfg=cfg)
    init_weights(model, SEED)
    model = model.to(dev)
    imgs = make_clip(dev)
    hp, wp = imgs.shape[2], imgs.shape[3]

    flows = model(imgs)                       # warm-up (builds nothing new)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    flows = model(imgs)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    log(f"forward launches {json.dumps(counts)} expected "
        f"{json.dumps(EXPECTED_LAUNCHES)}")
    assert counts == EXPECTED_LAUNCHES, "launch counts differ"
    assert flows.shape == (B, T - 1, hp, wp, 2), flows.shape
    assert bool(torch.isfinite(flows).all()), "non-finite flows"
    peak = torch.cuda.max_memory_allocated()
    mag = flows.norm(dim=-1)

    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * sum(times) / len(times)
    log(f"forward {tuple(flows.shape)} finite; ms/clip {ms:.3f} (mean of "
        f"{REPS}, min {1e3 * min(times):.3f}); frames/s {T / (ms / 1e3):.3f};"
        f" max_memory_allocated {peak / 2 ** 30:.3f} GiB; |flow| px mean "
        f"{float(mag.mean()):.4g} p99 "
        f"{float(torch.quantile(mag.flatten()[::7], 0.99)):.4g} max "
        f"{float(mag.max()):.4g}")
    profile_forward(model, imgs, ms)
    return counts


def profile_forward(model, imgs, clip_ms: float) -> None:
    """Device time of one forward by kernel group; the idle share compares
    the summed device time with the unprofiled ms/clip."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model(imgs)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=60)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_forward.txt"), "w") as fh:
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
        name = ev.key
        for k in ("corr_lookup", "ffn_pair", "flash_fwd", "lga_kernel",
                  "conv", "gemm", "elementwise", "reduce", "softmax",
                  "layer_norm", "cat", "copy"):
            if k in name.lower():
                name = k
                break
        else:
            name = "other"
        by[name] = by.get(name, 0.0) + t
    log("profile device time by group (ms): " + json.dumps(
        {k: round(v / 1e3, 3) for k, v in sorted(by.items(),
                                                 key=lambda kv: -kv[1])})
        + f" total {total / 1e3:.3f}; K1 share "
        f"{by.get('corr_lookup', 0.0) / max(total, 1e-9):.4f}; device idle "
        f"share {max(0.0, 1 - total / 1e3 / clip_ms):.4f} of {clip_ms:.3f} "
        f"ms/clip")


def accuracy_guards(dev) -> None:
    """iters=1, one clip, the same weights: the kernel path on the card and
    the plain path on the CPU, each in f32 and bf16, against the f32 plain
    path."""
    import copy

    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model

    imgs = make_clip("cpu")
    flows = {}
    for dtype in ("float32", "bfloat16"):
        cfg = StreamFlowConfig(T=T, iters=1,
                               mixed_precision=dtype == "bfloat16")
        cpu_model = create_model("streamflow", cfg=cfg)
        init_weights(cpu_model, SEED + 1)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        flows[dtype, "card"] = gpu_model(imgs.to(dev)).float().cpu()
        flows[dtype, "cpu"] = cpu_model(imgs).float()
    ref = flows["float32", "cpu"]
    mag = ref.norm(dim=-1)

    def rel_epe(x):
        epe = (x - ref).norm(dim=-1)
        per_px = (epe / mag.clamp(min=1.0)).flatten()[::7].double()
        return (float(epe.max()) / max(1.0, float(mag.max())),
                float(torch.quantile(per_px, 0.99)))

    f32 = rel_epe(flows["float32", "card"])
    bf16, bf16_plain = (rel_epe(flows["bfloat16", where])
                        for where in ("card", "cpu"))
    log(f"accuracy guard iters=1 against the f32 plain path (|flow_ref| px "
        f"mean {float(mag.mean()):.4g} max {float(mag.max()):.4g}), rel EPE "
        f"global / per-pixel p99: f32 kernels {f32[0]:.3e} / {f32[1]:.3e} "
        f"(bound {F32_GUARD_TOL} each); bf16 kernels {bf16[0]:.3e} / "
        f"{bf16[1]:.3e}, bf16 plain {bf16_plain[0]:.3e} / "
        f"{bf16_plain[1]:.3e} (bound {BF16_GUARD_RATIO}x the plain)")
    assert all(math.isfinite(v) and v < F32_GUARD_TOL for v in f32), f32
    assert all(math.isfinite(k) and k <= BF16_GUARD_RATIO * p
               for k, p in zip(bf16, bf16_plain)), (bf16, bf16_plain)


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

    summary = kernel_checks(dev)
    log("phase 3 kernels: all checks passed")
    counts = full_forward(dev)
    log("phase 4 forward: passed")
    accuracy_guards(dev)
    log("phase 5 accuracy guards: passed")

    assert "jax" not in sys.modules, "the port must not import jax"
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[k],
                "max_abs_err": summary[k]["err"],
                "ms": round(summary[k]["ms"], 4),
                "plain_ms": round(summary[k]["plain_ms"], 4)}
               for k, (src, rep) in KERNELS.items()]
    log(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
