"""K1 (the correlation lookup), K2 (the fused FFN pair) and B5 (the
flash-attention backward) on one GPU at the main path's shapes: each bf16
call checked against its plain version, timed with CUDA events beside its
bound and a yardstick, and optionally against the kernels of another
checkout of the repository, built from that tree's
``streamflow_tpu_torch/csrc`` and timed in turns (others, this, this,
others in reverse) in the same process, as ``attn_bench`` does for K3 and
K4.

    python -m streamflow_tpu_torch.tools.kernel_bench [--other DIR ...] [--reps N]

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
backward. One JSON object per case on stdout, then per-clip and per-step
sums; exits non-zero when a kernel disagrees with its plain version.
Needs a GPU.
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
from streamflow_tpu_torch.ops.kernels import ffn_pair as K2
from streamflow_tpu_torch.ops.kernels import flash_attention as K3
from streamflow_tpu_torch.tools.attn_bench import (HBM, PEAK_BF16, T, timed,
                                                   ulp_check)

# the six SK blocks (c_in, out of the second pair, frame pairs): convc1,
# convc2, convf2, conv, gru, flow head
SK = [(324, 256, 3), (256, 192, 3), (128, 64, 3), (256, 126, 3),
      (640, 128, 3), (384, 6, 1)]
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    # per library: (ctypes library, whether its K2 reads weight rows padded
    # to 16 bytes, as this tree's wrapper hands them)
    libs = {"this": (_build.library(), True)}
    for other in args.other:
        root = other.resolve()
        wrapper = root / "streamflow_tpu_torch/ops/kernels/ffn_pair.py"
        libs[root.name] = (
            _build.build(root / "streamflow_tpu_torch" / "csrc",
                         root / "build" / "kernel_bench"),
            "_tma_rows" in wrapper.read_text())
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

    def record(key, row, calls, flops, nbytes, run, outs, want, yardstick,
               clear=None):
        """``run(name)`` launches the kernel of library ``name`` into
        ``outs``; ``clear()`` zeroes them before a checked call."""
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
        if yardstick is not None:
            row["yardstick_ms"] = timed(yardstick, args.reps)
        print(json.dumps(row), flush=True)
        for k in key:
            s = sums.setdefault(k, {})
            for name, ts in times.items():
                s[name] = s.get(name, 0.0) + calls * min(ts)
            for name in ("bound", "yardstick"):
                if f"{name}_ms" in row:
                    s[name] = s.get(name, 0.0) + calls * row[f"{name}_ms"]

    def ffn(path, form, rows, c, ch, co, calls):
        a = ffn_inputs(form, rows, c, ch, co, rnd)
        residual, add_res = ffn_flags(form)
        padded = {k: K2._tma_rows(a[k]) for k in ("w1", "w2", "wp")
                  if k in a}
        out = torch.empty(rows, co, dtype=torch.bfloat16, device=dev)

        def run(name):
            lib, pad = libs[name]
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
               lambda: ffn_composite(form, a))

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
               lambda: torch.autograd.grad(ref, (qs, ks, vs), do,
                                           retain_graph=True), clear)
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
               [K1.corr_lookup_plain(f1, lv, coords, radius)], None)

    for path, (hp, wp, train) in (("clip", (440, 1024, False)),
                                  ("step", (432, 960, True))):
        for case in corr_cases(hp, wp, train):
            corr(path, *case)
        for case in ffn_cases(hp, wp, train):
            ffn(path, *case)
        torch.cuda.empty_cache()
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
