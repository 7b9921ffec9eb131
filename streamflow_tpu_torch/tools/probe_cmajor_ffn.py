"""Does a channel-major SK layout keep K2's rate? The FFN pair on (N, C)
rows (K2 ``ffn_pair``, residual) against its channel-major twin on (C, N)
(``ops/kernels/ffn_pair_cmajor.py``), at the SK blocks' token count.

Port of the JAX package's ``tools/probe_cmajor_ffn.py``: its cases (N =
3 * 55 * 128 = 21120 tokens, the three frame pairs of a 440x1024 clip at
1/8; C = 256 and 384; Ch = ceil(1.5 C / 128) * 128; bf16) and seeded
operands (x from default_rng(0), weights N(0, 0.05^2), zero biases). For
each C it prints both kernels' ms (device time: ``--reps`` calls in a
CUDA graph after two warm-ups, its replay timed by CUDA events),
TFLOP/s, and the max|err| of the C-major output's transpose against the
row-major kernel's; the C-major kernel is also held against
its plain version, and timed beside the bf16 library composite on the
transpose (a yardstick).

    python -m streamflow_tpu_torch.tools.probe_cmajor_ffn [--reps N] \\
        [--tokens N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from streamflow_tpu_torch.ops.kernels import ffn_pair_cmajor as KC
from streamflow_tpu_torch.ops.kernels.ffn_pair import ffn_pair
from streamflow_tpu_torch.tools.common import (bound_ms, close_err, cuda_ms,
                                               device_record, fmt_ms,
                                               graph_ms)

WIDTHS = (256, 384)


def make_inputs(c: int, n: int, rng, device):
    """x (N, C) and the pair's weights in nn.Linear layout, bf16, as the
    JAX tool draws them (its weights are (in, out): transposed here)."""
    ch = math.ceil(1.5 * c / 128) * 128

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=torch.bfloat16)
    x = t(rng.standard_normal((n, c)))
    w1 = t((rng.standard_normal((c, ch)) * 0.05).T)
    w2 = t((rng.standard_normal((ch, c)) * 0.05).T)
    b1 = torch.zeros(ch, device=device, dtype=torch.bfloat16)
    b2 = torch.zeros(c, device=device, dtype=torch.bfloat16)
    return x, w1, b1, w2, b2


def composite_t(x_cm, w1, b1, w2, b2):
    """The library composite on the transpose: bf16 PyTorch ops on the
    (N, C) view of x_cm, h through device memory."""
    x = x_cm.t()
    return F.gelu(x + F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2))


def run(c: int, n: int, reps: int, device, rng):
    x, w1, b1, w2, b2 = make_inputs(c, n, rng, device)
    ch = w1.shape[0]
    x_cm = x.t().contiguous()
    y_rm = ffn_pair(x, w1, b1, w2, b2, residual=True)
    y_cm = KC.ffn_pair_cmajor(x_cm, w1, b1, w2, b2, residual=True)
    plain = KC.ffn_pair_cmajor_plain(x_cm, w1, b1, w2, b2, residual=True)
    err_plain, within = close_err(y_cm, plain)
    flops = 2 * n * (c * ch + ch * c)
    nbytes = 2 * (2 * x.numel() + w1.numel() + w2.numel() + ch + c)
    row = {"c": c, "ch": ch, "n": n,
           "err_vs_row_major": float((y_cm.t().float()
                                      - y_rm.float()).abs().max()),
           "max_abs_err": err_plain, "within": within, "out": y_cm,
           "plain": plain, "flops": flops, "nbytes": nbytes}
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
    row["ms_row_major"] = graph_ms(lambda: ffn_pair(
        x, w1, b1, w2, b2, residual=True), reps, device)
    row["ms"] = graph_ms(lambda: KC.ffn_pair_cmajor(
        x_cm, w1, b1, w2, b2, residual=True), reps, device)
    row["plain_ms"] = cuda_ms(lambda: KC.ffn_pair_cmajor_plain(
        x_cm, w1, b1, w2, b2, residual=True), 1, device, warmup=1)
    row["library_ms"] = graph_ms(lambda: composite_t(x_cm, w1, b1, w2, b2),
                                 reps, device)
    return row


def tflops(flops, ms):
    return "-" if ms is None else f"{flops / ms / 1e9:.1f} TFLOP/s"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--tokens", type=int, default=3 * 55 * 128)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_cmajor_ffn: no CUDA device (pass --device "
                         "cpu for the plain versions)")
    print(f"probe_cmajor_ffn N={args.tokens}, bf16, reps={args.reps}; "
          + json.dumps(device_record(dev)),
          flush=True)
    rng = np.random.default_rng(0)
    rows = []
    for c in WIDTHS:
        r = run(c, args.tokens, args.reps, dev, rng)
        rows.append(r)
        print(f"C={c} ch={r['ch']}: row-major {fmt_ms(r['ms_row_major'])} "
              f"({tflops(r['flops'], r['ms_row_major'])}) | cmajor "
              f"{fmt_ms(r['ms'])} ({tflops(r['flops'], r['ms'])}) "
              f"err={r['err_vs_row_major']:.4f} | bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), composite on the "
              f"transpose {fmt_ms(r['library_ms'])}, max|err| vs plain "
              f"{r['max_abs_err']:.3e}{'' if r['within'] else ' OUTSIDE'}",
              flush=True)
    if not all(r["within"] for r in rows):
        raise SystemExit("probe_cmajor_ffn: the C-major kernel disagrees "
                         "with its plain version")
    return rows


if __name__ == "__main__":
    main()
