"""K3 (flash attention forward) and K4 (windowed attention) on one GPU at
the main path's shapes: each bf16 call checked against its plain version,
timed with CUDA events beside its bound and SDPA, and optionally against
the kernels of another checkout of the repository, built from that tree's
``streamflow_tpu_torch/csrc`` and timed in turns (others, this, this,
others in reverse) in the same process.

    python -m streamflow_tpu_torch.tools.attn_bench [--other DIR ...] [--reps N]

One JSON object per case on stdout, then per-clip and per-step sums (the
calls of one 440x1024 forward and of one 432x960 train step); exits
non-zero when a kernel disagrees with its plain version. Needs a GPU.
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
from streamflow_tpu_torch.ops.kernels import flash_attention as K3
from streamflow_tpu_torch.ops.kernels import lga_attention as K4

T = 4
PEAK_BF16, HBM = 989e12, 3.35e12   # H100 SXM: dense bf16 FLOP/s, bytes/s
MUFU_PER_CLK_SM = 16               # ex2 per clock per SM


def flash_cases(hp, wp, train):
    """(label, bh shape, n, m, d, calls per clip or step) of K3."""
    h8, w8 = hp // 8, wp // 8
    cases = [("gma", (3, 1), h8 * w8, h8 * w8, 128, 24 if train else 12)]
    for stage, nh, sr, hh, ww in ((0, 4, 8, 2 * h8, 2 * w8),
                                  (1, 8, 4, h8, w8)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            cases.append((f"gsa{stage} {enc}", (1, nh), t * hh * ww,
                          (t * hh // sr) * (ww // sr), 32, 1))
    return cases


def lga_cases(hp, wp):
    """(label, hq, wq, c, nh, calls) of K4: the frames stacked along H,
    padded to 7x7 windows."""
    h4, w4 = hp // 4, wp // 4
    cases = []
    for stage, c, nh, hh, ww in ((0, 128, 4, h4, w4),
                                 (1, 256, 8, h4 // 2, w4 // 2)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            cases.append((f"stage{stage} {enc}", -(-t * hh // 7) * 7,
                          -(-ww // 7) * 7, c, nh, 1))
    return cases


def ulp_check(got, want):
    """bf16: |got - want| <= 2 ulp(want) + 2^-9 max|want|; f32: 1e-4
    abs + rel (chip_smoke.py's rule). Returns (ok, max abs err)."""
    w = want.float()
    top = float(w.abs().max())
    diff = (got.float() - w).abs()
    if got.dtype == torch.float32:
        bound = 1e-4 + 1e-4 * w.abs()
    else:
        e = torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126)))
        bound = 2 * torch.exp2(e - 7) + 2.0 ** -9 * top
    err = float(diff.max())
    return bool((diff <= bound).all()) and math.isfinite(err), err


def timed(fn, reps):
    for _ in range(2):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="root of another checkout whose kernels to time "
                         "beside this tree's (repeatable; named by its "
                         "directory)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_bench: no CUDA device")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clock = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0]) * 1e6
    libs = {"this": _build.library()}
    for other in args.other:
        root = other.resolve()
        libs[root.name] = _build.build(root / "streamflow_tpu_torch" / "csrc",
                                       root / "build" / "attn_bench")
    print(json.dumps({"card": card, "sm": sm_count, "max_sm_clock_hz": clock,
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "others": [str(o) for o in args.other]}), flush=True)
    print(_build.ptxas_summary(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = lambda t: torch.cuda.current_stream(t.device).cuda_stream  # noqa: E731

    def rnd(*shape, scale=1.0, dt=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dt)

    def flash_call(lib, q, k, v, out, lse):
        bh, n, d = math.prod(q.shape[:2]), q.shape[2], q.shape[3]
        _build.check(lib.sf_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _build.ptr(lse), bh, n, k.shape[2], d,
            _build.dtype_code(q.dtype), stream(q)), "flash_attention")

    def lga_call(lib, qkv, out, ws, nh):
        b, hp, wp, c3 = qkv.shape
        _build.check(lib.sf_lga_attn(
            qkv.data_ptr(), out.data_ptr(), b, hp, wp, c3 // 3, nh, ws,
            K4._scale(c3 // 3 // nh, qkv.dtype),
            _build.dtype_code(qkv.dtype), stream(qkv)), "lga_attention")

    ok = True
    sums = {}

    def record(kernel, path, label, calls, flops, nbytes, run, outs, plain,
               library, extra=None):
        """``run(lib)`` launches the kernel of ``lib`` into ``outs``."""
        nonlocal ok
        got = {}
        for name, lib in libs.items():
            run(lib)
            got[name] = [t.clone() for t in outs]
        want = plain()
        torch.cuda.synchronize()
        row = {"kernel": kernel, "path": path, "case": label, "calls": calls}
        for name, out in got.items():
            errs = [ulp_check(a, b) for a, b in zip(out, want)]
            row[f"ok_{name}"] = all(e[0] for e in errs)
            row[f"max_abs_err_{name}"] = max(e[1] for e in errs)
        ok &= row["ok_this"]
        t_mem, t_ops = 1e3 * nbytes / HBM, 1e3 * flops / PEAK_BF16
        row["bound_ms"] = max(t_mem, t_ops)
        row["bound_by"] = "operations" if t_ops >= t_mem else "bytes"
        row.update(extra or {})
        others = [name for name in libs if name != "this"]
        order = others + ["this", "this"] + others[::-1]
        times = {}
        for name in order:
            lib = libs[name]
            times.setdefault(name, []).append(
                timed(lambda: run(lib), args.reps))
        for name, ts in times.items():
            row[f"ms_{name}"] = ts
            best = min(ts)
            row[f"tflops_{name}"] = flops / best / 1e9
            row[f"gbps_{name}"] = nbytes / best / 1e6
        row["sdpa_ms"] = timed(library, args.reps)
        print(json.dumps(row), flush=True)
        s = sums.setdefault((kernel, path), {})
        for name, ts in times.items():
            s[name] = s.get(name, 0.0) + calls * min(ts)
        s["bound"] = s.get("bound", 0.0) + calls * row["bound_ms"]
        s["sdpa"] = s.get("sdpa", 0.0) + calls * row["sdpa_ms"]
        if "exp_floor_ms" in row:
            s["exp_floor"] = s.get("exp_floor", 0.0) + calls * row[
                "exp_floor_ms"]

    def flash(path, label, bh_shape, n, m, d, calls, with_lse):
        q = rnd(*bh_shape, n, d, scale=d ** -0.5)
        k, v = rnd(*bh_shape, m, d), rnd(*bh_shape, m, d)
        out = torch.empty_like(q)
        lse = (torch.empty(*bh_shape, n, device=dev) if with_lse else None)
        bh = math.prod(bh_shape)
        plain = lambda: K3.flash_attention_plain(  # noqa: E731
            q, k, v, return_lse=with_lse)
        plain_t = (lambda: plain() if with_lse else (plain(),))  # noqa: E731
        scores = bh * n * m
        record("flash_attention", path, f"{label} bh{bh} n{n} m{m} d{d}",
               calls, 4 * scores * d, 2 * (q.numel() + k.numel() + v.numel()
                                           + out.numel()),
               lambda lib: flash_call(lib, q, k, v, out, lse),
               [out] + ([lse] if with_lse else []), plain_t,
               lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0),
               {"exp_floor_ms": 1e3 * scores / (MUFU_PER_CLK_SM * sm_count
                                                * clock)})

    def lga(path, label, b, hq, wq, c, nh, calls, ws=7, dt=torch.bfloat16):
        qkv = rnd(b, hq, wq, 3 * c, dt=dt)
        out = torch.empty(b, hq, wq, c, dtype=dt, device=dev)
        hd, win = c // nh, (hq // ws) * (wq // ws)
        parts = qkv.reshape(b, hq // ws, ws, wq // ws, ws, 3, nh, hd).permute(
            5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * win, nh, ws * ws,
                                            hd).contiguous()

        record("lga_attention", path, f"{label} b{b} {hq}x{wq}x{3 * c} h{nh}",
               calls, 4 * b * win * nh * (ws * ws) ** 2 * hd,
               2 * (qkv.numel() + out.numel()),
               lambda lib: lga_call(lib, qkv, out, ws, nh), [out],
               lambda: (K4.lga_attention_plain(qkv, ws, nh),),
               lambda: F.scaled_dot_product_attention(
                   parts[0], parts[1], parts[2], scale=hd ** -0.5))

    for path, (hp, wp, train) in (("clip", (440, 1024, False)),
                                  ("step", (432, 960, True))):
        for label, bh_shape, n, m, d, calls in flash_cases(hp, wp, train):
            flash(path, label, bh_shape, n, m, d, calls, train)
            torch.cuda.empty_cache()
        for label, hq, wq, c, nh, calls in lga_cases(hp, wp):
            lga(path, label, 1, hq, wq, c, nh, calls)
    # K4 off the main path (chip_smoke.py holds the tiles' tails): head
    # dims that take the padded, element-wise load, and ws=5; not summed
    for label, b, hq, wq, c, nh, ws in (("hd 8", 1, 14, 21, 64, 8, 7),
                                        ("hd 24 ws 5", 1, 10, 15, 96, 4, 5),
                                        ("hd 12", 2, 7, 14, 36, 3, 7)):
        for dt in (torch.bfloat16, torch.float32):
            lga("tail", label, b, hq, wq, c, nh, 0, ws, dt)
    for (kernel, path), s in sums.items():
        if path != "tail":
            print(json.dumps({"sum": kernel, "per": path, **{
                f"{k}_ms": v for k, v in s.items()}}), flush=True)
    print(json.dumps({"ok": ok, "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
