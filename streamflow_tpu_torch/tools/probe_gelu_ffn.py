"""What K2's gelu costs on the card: K2 ``dwres_pw_ffn_pair`` (the dw
residual's gelu, the pw stage, the pair; no residual) under each gelu
variant, beside its bound and its error against the f32 erf composite.

Port of the JAX package's ``tools/probe_gelu_ffn.py``, whose A/B never
reached its kernels (it set a module name the kernels do not read): here
the variant goes to the kernel as its compile-time ``gelu`` argument. The
same CLI and seeded operands (default_rng(0); x, y (rows, C), db (C,)
N(0, 1); weights N(0, 1 / fan_in), zero biases; bf16):

    python -m streamflow_tpu_torch.tools.probe_gelu_ffn [erf|poly|tanh] \\
        [C] [rows] [--all] [--reps N] [--device cuda|cpu]

``--all`` runs the three variants in turns in one process (erf, poly,
tanh, tanh, poly, erf), each call's ms device time: ``--reps`` calls in a
CUDA graph after two warm-ups, its replay timed by CUDA events.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from streamflow_tpu_torch.ops.kernels import ffn_pair as K2
from streamflow_tpu_torch.tools.common import (bound_ms, device_record,
                                               fmt_ms, graph_ms)

VARIANTS = ("erf", "poly", "tanh")


def make_inputs(c: int, rows: int, device):
    """The JAX tool's operands, its (in, out) weights transposed to
    nn.Linear layout."""
    rng = np.random.default_rng(0)
    h = int(1.5 * c)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=torch.bfloat16)
    x = t(rng.standard_normal((rows, c)))
    y = t(rng.standard_normal((rows, c)))
    db = t(rng.standard_normal((c,)))
    wp = t((rng.standard_normal((c, c)) / math.sqrt(c)).T)
    bp = torch.zeros(c, device=device, dtype=torch.bfloat16)
    w1 = t((rng.standard_normal((c, h)) / math.sqrt(c)).T)
    b1 = torch.zeros(h, device=device, dtype=torch.bfloat16)
    w2 = t((rng.standard_normal((h, c)) / math.sqrt(h)).T)
    b2 = torch.zeros(c, device=device, dtype=torch.bfloat16)
    return x, y, db, wp, bp, w1, b1, w2, b2


def cost(c: int, rows: int):
    """(FLOPs, bytes) of one call: the three products; x, y and the output
    once, the weights and biases once."""
    h = int(1.5 * c)
    flops = 2 * rows * (c * c + c * h + h * c)
    nbytes = 2 * (3 * rows * c + c * c + 2 * c * h + 3 * c + h + c)
    return flops, nbytes


def run(impl: str, ops, reps: int, device, ref=None):
    """ms a call of K2 under ``impl`` and its max|err| against the f32 erf
    composite (``ref``, computed here when not given)."""
    if ref is None:
        ref = K2.ffn_pair_plain(*(t.float() for t in (ops[0], *ops[5:])),
                                residual=False, wp=ops[3].float(),
                                bp=ops[4].float(), yres=ops[1].float(),
                                db=ops[2].float())
    out = K2.dwres_pw_ffn_pair(*ops, gelu=impl)
    err = float((out.float() - ref).abs().max())
    ms = graph_ms(lambda: K2.dwres_pw_ffn_pair(*ops, gelu=impl), reps,
                  device)
    return {"gelu": impl, "ms": ms, "max_abs_err_vs_f32_erf": err}, ref


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("impl", nargs="?", default="erf", choices=VARIANTS)
    p.add_argument("c", nargs="?", type=int, default=384)
    p.add_argument("rows", nargs="?", type=int, default=21120)
    p.add_argument("--all", action="store_true",
                   help="the three variants in turns in one process")
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_gelu_ffn: no CUDA device (pass --device cpu "
                         "for the plain versions)")
    ops = make_inputs(args.c, args.rows, dev)
    bound, by = bound_ms(*cost(args.c, args.rows))
    print(f"probe_gelu_ffn C={args.c} rows={args.rows} bf16, "
          f"dwres_pw_ffn_pair, reps={args.reps}, bound {bound:.4f} ms "
          f"({by}); " + json.dumps(device_record(dev)), flush=True)
    order = (VARIANTS + VARIANTS[::-1]) if args.all else (args.impl,)
    rows, ref = [], None
    for impl in order:
        row, ref = run(impl, ops, args.reps, dev, ref)
        row["bound_ms"] = bound
        rows.append(row)
        print(f"impl={impl} C={args.c} rows={args.rows}: "
              f"{fmt_ms(row['ms'])}/call (bound {bound:.4f} ms), max|err| "
              f"vs f32-erf composite {row['max_abs_err_vs_f32_erf']:.2e}",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
