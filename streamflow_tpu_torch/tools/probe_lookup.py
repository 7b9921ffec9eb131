"""K1's cost split on the card: the correlation lookup's work-split modes
(``ops/kernels/corr_lookup_probe.py``), each timed beside K1's bound.

Port of the JAX package's ``tools/probe_lookup.py``: the same CLI, shape
and seeded operands (a 440x1024 frame's 55x128 fmaps, C=256, bf16, a
4-level pyramid, coordinates the identity plus N(0, 3^2) px), each mode a
compile-time variant of K1's bf16 body:

  full      - the production kernel (held bit for bit against ``corr_lookup``)
  mm_only   - the planes only (products; each query's tile-box sum kept)
  ex_only   - the tap copies and bilinear weights only, on a constant plane
  nofori    - full work over the whole level (no data-dependent box)
  l0_only   - full work, level 0 only
  l123_only - full work, levels 1-3 only

JAX's ``mm_only`` and ``ex_only`` write what its 128-lane layout leaves
behind; the port's two compute the functions their plain versions define
(``corr_lookup_probe_plain``), and every mode is held against its plain
version. Each mode's ms a call is device time: ``--reps`` calls captured
in a CUDA graph after two warm-ups, the replay timed by CUDA events (the
JAX tool chained calls through a device scalar to hide the host's
dispatch; a call of a few tens of us launched from Python would time the
host). The plain versions are timed by events, call by call.

    python -m streamflow_tpu_torch.tools.probe_lookup [--reps N] \\
        [--height H] [--width W] [--device cuda|cpu]

On the CPU (``--device cpu``) the plain versions run and no time is
measured.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from streamflow_tpu_torch.ops.coords import coords_grid
from streamflow_tpu_torch.ops.corr import pool_pyramid
from streamflow_tpu_torch.ops.kernels.corr_lookup import corr_lookup
from streamflow_tpu_torch.ops.kernels.corr_lookup_probe import (
    corr_lookup_probe, corr_lookup_probe_plain)
from streamflow_tpu_torch.tools import kernel_bench as KB
from streamflow_tpu_torch.tools.common import (bound_ms, close_err, cuda_ms,
                                               device_record, fmt_ms,
                                               graph_ms)

C, LEVELS, RADIUS = 256, 4, 4
ORDER = ("full", "mm_only", "ex_only", "nofori", "l0_only", "l123_only")


def make_inputs(height: int, width: int, device, seed: int = 0):
    """The JAX tool's operands: fmaps (1, H/8, W/8, 256) bf16 from
    default_rng(seed), the pyramid pooled in bf16, coordinates the
    identity plus N(0, 3^2) px."""
    h, w = height // 8, width // 8
    rng = np.random.default_rng(seed)
    f1 = torch.from_numpy(rng.standard_normal((1, h, w, C))).to(
        device=device, dtype=torch.bfloat16)
    f2 = torch.from_numpy(rng.standard_normal((1, h, w, C))).to(
        device=device, dtype=torch.bfloat16)
    levels = [lv.contiguous() for lv in pool_pyramid(f2, LEVELS)]
    coords = coords_grid(1, h, w, device) + torch.from_numpy(
        rng.standard_normal((1, h, w, 2)) * 3.0).to(device, torch.float32)
    return f1, levels, coords.contiguous()


def mode_cost(mode, f1, levels, coords):
    """(FLOPs, bytes) of the function a mode computes: the C-long dot
    product of each tap its kept levels need (none for mm_only's box sums
    and ex_only's constant volume, which are bound by bytes), the inputs
    it depends on read once and its output written once."""
    b, h, w, c = f1.shape
    shapes = [(lv.shape[1], lv.shape[2]) for lv in levels]
    kept = {"l0_only": [0], "l123_only": list(range(1, len(levels)))}.get(
        mode, list(range(len(levels))))
    flops = 0
    if mode not in ("mm_only", "ex_only"):    # a level of no size: no taps
        flops = KB.corr_flops(coords, [s if i in kept else (0, 0) for i, s
                                       in enumerate(shapes)], c, RADIUS)
    out = 2 * b * h * w * len(levels) * (2 * RADIUS + 1) ** 2
    coords_b = 8 * b * h * w
    if mode == "ex_only":
        return flops, coords_b + out
    pyramid = sum(2 * lv.numel() for i, lv in enumerate(levels)
                  if i in kept)
    return flops, 2 * f1.numel() + pyramid + coords_b + out


def run(f1, levels, coords, reps: int, modes=ORDER):
    """Each mode's output, plain output, max|err| against it (and whether
    within the rule), and ms a call; ``full`` also against production K1."""
    dev = f1.device
    rows = []
    for mode in modes:
        out = corr_lookup_probe(f1, levels, coords, mode, RADIUS)
        plain = corr_lookup_probe_plain(f1, levels, coords, mode, RADIUS)
        err, ok = close_err(out, plain)
        row = {"mode": mode, "out": out, "plain": plain,
               "max_abs_err": err, "within": ok}
        if mode == "full" and dev.type == "cuda":
            row["bits_of_production"] = bool(torch.equal(
                out, corr_lookup(f1, levels, coords, RADIUS)))
        row["ms"] = graph_ms(lambda: corr_lookup_probe(
            f1, levels, coords, mode, RADIUS), reps, dev)
        row["plain_ms"] = cuda_ms(lambda: corr_lookup_probe_plain(
            f1, levels, coords, mode, RADIUS), 1, dev, warmup=1)
        row["flops"], row["nbytes"] = mode_cost(mode, f1, levels, coords)
        row["bound_ms"], row["bound_by"] = bound_ms(row["flops"],
                                                    row["nbytes"])
        rows.append(row)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--height", type=int, default=440)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_lookup: no CUDA device (pass --device cpu "
                         "for the plain versions)")
    f1, levels, coords = make_inputs(args.height, args.width, dev)
    h, w = f1.shape[1:3]
    flops, nbytes = mode_cost("full", f1, levels, coords)
    bound, by = bound_ms(flops, nbytes)
    print(f"probe_lookup {args.height}x{args.width} (fmap {h}x{w}, C={C}, "
          f"bf16), reps={args.reps}, K1 bound {bound:.4f} ms ({by}); "
          + json.dumps(device_record(dev)), flush=True)
    rows = run(f1, levels, coords, args.reps)
    for r in rows:
        extra = (f", bit for bit with corr_lookup: "
                 f"{r['bits_of_production']}"
                 if "bits_of_production" in r else "")
        print(f"  {r['mode']:10s} {fmt_ms(r['ms'])}/call (bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_by']}; plain "
              f"{fmt_ms(r['plain_ms'])}) max|err| vs plain "
              f"{r['max_abs_err']:.3e}{'' if r['within'] else ' OUTSIDE'}"
              f"{extra}", flush=True)
    bad = [r["mode"] for r in rows if not r["within"]
           or r.get("bits_of_production") is False]
    if bad:
        raise SystemExit(f"probe_lookup: {bad} disagree with their plain "
                         f"version or production K1")
    return rows


if __name__ == "__main__":
    main()
