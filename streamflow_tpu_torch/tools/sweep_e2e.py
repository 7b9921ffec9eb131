"""End-to-end sweep of configuration variants on the benchmark clip (port
of tools/sweep_e2e.py): ms/clip of each spec, measured in turns in one
process.

    python -m streamflow_tpu_torch.tools.sweep_e2e default dw=pallas \\
        dw=banded_chain,iters=12 [--reps 10] [--device cuda]
        [--height 436] [--width 1024] [--results PATH]

Each positional spec is ``default`` (or empty) or a comma-separated list
of ``key=value`` overrides with JAX's short keys (``_KEYMAP``): ``dw``
(``dw_impl``, the SK layout), ``iters``, ``T`` and ``B`` (clips a call)
are honoured, and so is any other field of the port's StreamFlowConfig
by its own name (``encoder=basic``, ``use_gma=0``). The keys of the JAX
package's TPU kernel choices (``corr``, ``attn``, ``lga``, ``store``,
``unroll``, ``tffn``, ``bq``, ``lu``, ``lmaj``, ``lrows``, ``gelu``) name
fields that the port's config accepts and ignores (ROADMAP.md, ground rule
"Do not port the TPU workarounds"; config.py): they raise ValueError, as
do ``remat`` and ``bidir`` (train-step keys: a test-mode forward does not
read them), since a sweep over a knob that changes nothing would mislead.

The clip is JAX's: ``default_rng(0)``'s (8, 4, 436, 1024, 3) draw, the
first B clips and T frames, padded in 'sintel' mode; random weights from
seed 0 (``tools/common.py::init_weights``, the same parameters in every
SK layout), bf16, TF32 off as in ``chip_smoke.py``
(``tools/common.py::strict_f32``). Each spec runs through
``GraphedForward`` (captured
first, its capture timed), then the specs are timed in ROUNDS rounds,
in turns, ``--reps`` calls each a round, with ``tools/bench.py``'s
timing: the host clock around calls that end in a synchronize, the mean.
Then one profiled replay per spec gives its device ms and idle share (1 -
device ms / ms/clip). Every spec is parsed before anything runs.

One JSON line per spec and round, then one per spec with its numbers,
each also appended to ``--results`` as it is made (a run that dies keeps
its partial lines). With ``--device cpu`` the forward runs eagerly and
device time is not measured.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict

import numpy as np
import torch

from streamflow_tpu_torch.tools.common import (RESULTS_DIR, append_results,
                                               device_record, strict_f32)

_KEYMAP = {
    "corr": "corr_impl",
    "dw": "dw_impl",
    "attn": "attn_impl",
    "lga": "lga_impl",
    "store": "corr_store",
    "unroll": "scan_unroll",
    "iters": "iters",
    "T": "T",
    "tffn": "twins_ffn_fused",
    "bq": "lookup_block_q",
    "lu": "lookup_unroll",
    "lmaj": "lookup_f2_major",
    "lrows": "lookup_rows",
    "gelu": "ffn_gelu",
    "B": "B",  # batch size (clips per call) — not a config field
    "remat": "remat",
    "bidir": "bidir",  # train_bench only: bidirectional supervision
}
# the fields of the JAX package's TPU kernel choices, which the port's
# config accepts and ignores
IGNORED = {"corr_impl", "attn_impl", "lga_impl", "corr_store",
           "scan_unroll", "twins_ffn_fused", "lookup_block_q",
           "lookup_unroll", "lookup_f2_major", "lookup_rows", "ffn_gelu"}
TRAIN_ONLY = {"remat", "bidir"}
B_MAX, T_MAX, SEED = 8, 4, 0
ROUNDS = 2          # timed rounds, each over every spec in turn


def parse_spec(spec: str) -> Dict:
    """A spec -> {config field or "B": value}, each value of its field's
    type; raises ValueError on a key the port ignores or does not know."""
    from streamflow_tpu_torch.config import StreamFlowConfig

    defaults = {f.name: f.default
                for f in dataclasses.fields(StreamFlowConfig)}
    over = {}
    if spec in ("default", ""):
        return over
    for kv in spec.split(","):
        k, v = kv.split("=")
        key = _KEYMAP.get(k, k)
        if key in IGNORED:
            raise ValueError(
                f"sweep key {k!r} ({key}) is a TPU kernel choice that the "
                f"port's config accepts and ignores (ROADMAP.md, ground rule "
                f"'Do not port the TPU workarounds'): sweeping it would "
                f"change nothing")
        if key in TRAIN_ONLY:
            raise ValueError(f"sweep key {k!r} steers the train step "
                             f"(tools/train_bench.py); a test-mode forward "
                             f"does not read it")
        if key == "B":
            over[key] = int(v)
            continue
        if key not in defaults:
            raise ValueError(f"sweep key {k!r}: no field {key!r} in the "
                             f"port's StreamFlowConfig")
        kind = type(defaults[key])
        if kind is bool:
            over[key] = v not in ("0", "false", "False")
        elif kind in (int, float, str):
            over[key] = kind(v)
        else:
            raise ValueError(f"sweep key {k!r}: field {key!r} takes a "
                             f"{kind.__name__}, not a scalar")
    return over


def clip_of(b: int, t: int, h: int, w: int) -> torch.Tensor:
    """JAX's sweep clip: the first b clips and t frames of
    ``default_rng(0)``'s (B_MAX, T_MAX, h, w, 3) draw, padded in 'sintel'
    mode; on the CPU."""
    from streamflow_tpu_torch.ops.padding import InputPadder

    imgs = np.random.default_rng(SEED).integers(0, 255,
                                                (B_MAX, T_MAX, h, w, 3))
    clip = torch.from_numpy(imgs[:b, :t].astype(np.float32))
    return InputPadder((h, w, 3), mode="sintel").pad(clip)


def build(spec: str, over: Dict, h: int, w: int, device):
    """The spec's config, its GraphedForward (captured) and its clip on
    ``device``, and the capture's seconds."""
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.evaluation import GraphedForward
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.tools.common import init_weights

    over = dict(over)
    b = over.pop("B", 1)
    cfg = dataclasses.replace(StreamFlowConfig(T=T_MAX, iters=12,
                                               mixed_precision=True), **over)
    if b > B_MAX or cfg.T > T_MAX:
        raise ValueError(f"spec {spec!r}: B <= {B_MAX} and T <= {T_MAX}")
    model = create_model("streamflow", cfg=cfg, device=device)
    init_weights(model, SEED)
    fwd = GraphedForward(model, cfg.iters)
    imgs = clip_of(b, cfg.T, h, w).to(device)
    t0 = time.perf_counter()
    flows = fwd(imgs)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    if not bool(torch.isfinite(flows).all()):
        raise AssertionError(f"spec {spec!r}: non-finite flows")
    return cfg, b, fwd, imgs, capture_s


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("specs", nargs="*", default=["default"])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--height", type=int, default=436)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--results",
                   default=str(RESULTS_DIR / "sweep_results.txt"))
    args = p.parse_args(argv)
    strict_f32()

    from streamflow_tpu_torch.tools.common import (device_events, host_ms,
                                                   profiled)

    specs = args.specs or ["default"]
    overs = [parse_spec(s) for s in specs]
    cuda = torch.device(args.device).type == "cuda"
    where = device_record(args.device)

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        append_results(args.results, [line])

    built = [build(s, o, args.height, args.width, args.device)
             for s, o in zip(specs, overs)]
    times = {s: [] for s in specs}
    for r in range(ROUNDS):
        for spec, (_, _, fwd, imgs, _) in zip(specs, built):
            ms, ms_min = host_ms(lambda: fwd(imgs), args.reps, args.device)
            times[spec].append(ms)
            emit({"spec": spec, "round": r, "ms_per_clip": ms,
                  "ms_per_clip_min": ms_min, "reps": args.reps})
    rows = []
    for spec, (cfg, b, fwd, imgs, capture_s) in zip(specs, built):
        ms = sum(times[spec]) / len(times[spec])
        device_ms = (sum(t for _, _, t in device_events(
            profiled(lambda: fwd(imgs)))) / 1e3 if cuda else None)
        row = {"spec": spec, "ms_per_clip": ms,
               "ms_per_clip_rounds": times[spec],
               "frames_per_sec": b * cfg.T / (ms / 1e3),
               "capture_s": capture_s, "device_ms": device_ms,
               "idle_share": (None if device_ms is None
                              else max(0.0, 1 - device_ms / ms)),
               "resolved": {"dw": cfg.dw_impl, "iters": cfg.iters,
                            "T": cfg.T, "B": b},
               "shape": [args.height, args.width],
               "padded": list(imgs.shape[2:4]), **where}
        emit(row)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
