"""The program's spans (``utils.profiling``) on a served clip or a train
step: the split of a request or a step by span against the device's busy
time, the recorder's cost, and what it leaves unchanged.

    python -m streamflow_tpu_torch.tools.trace_spans infer|train
        [--device cuda] [--seed S] [--height H] [--width W] [--iters N]
        [--batch B] [--seconds S] [--rounds R] [--steps N]
        [--trace-seconds S] [--trace-steps N] [--results PATH]

``infer``: the canonical StreamFlow (bf16, T=4) on clips of H x W padded
in 'sintel' mode (default 436x1024 -> 440x1024, 15 iterations, B=1), one
client in a closed loop from pinned host memory, as the benchmark's
``sf_sintel_infer`` cell serves them. Two ``GraphedForward`` of one model,
one captured with the recorder on and one with it off: their graphs'
kernel nodes (``tools/common.py::graph_kernel_nodes``) and their flows on
every clip of the ring, compared whole; ``rounds`` pairs of windows of
``seconds`` each, recorder off and on in turns (ABBA), for the cost; then
``trace_seconds`` of requests under the profiler (the card's activity
only, after one warm-up request), read as: device ms a request of each
span (``encode``, ``corr.*``, ``update.*``) and of the union of the
card's activities (busy), the rest of busy outside the four stages, the
gaps between busy stretches split into those a ``serve.*`` span overlaps
(the program's) and the rest (the client's), and the host seconds of the
process's first capture (``serve.warmup``, ``serve.capture``).

``train``: the sintel_kitti step (432x960, T=4, 12 iterations, remat,
AdamW, ``tools/train_bench.py``'s set-up and batch, default B=8). One step
from one saved state three times (recorder off, off again, on): losses
and parameters compared; ``rounds`` ABBA pairs of ``steps`` steps for the
cost; ``trace_steps`` profiled steps: device ms a step of ``step.forward``,
``step.backward``, ``step.optimizer``, of busy, and of the model's spans
by the phase that holds them (the recompute under ``step.backward``).

Prints one JSON line, also appended to ``--results``. On the CPU
(``--device cpu``, tiny shapes) there is no device time and no graph: the
split is the spans' host ms, labelled so.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from streamflow_tpu_torch.tools.common import (RESULTS_DIR, append_results,
                                               device_record)
from streamflow_tpu_torch.utils import profiling

STAGES = {"encode": ("encode",), "corr": ("corr.pyramid", "corr.lookup"),
          "sk": ("update.motion", "update.gru_head"),
          "gma_temporal": ("update.gma_temporal",)}
SERVE = ("serve.copy_in", "serve.replay", "serve.copy_out")
STEP = ("step.forward", "step.backward", "step.optimizer")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def span_ms(rec: profiling.Span, cuda: bool) -> float:
    """A span's device ms on the card, its host ms on the CPU."""
    if cuda:
        return rec.device_ms or 0.0
    return (rec.end_ns - rec.start_ns) / 1e6


def by_name(records, names, units: int, cuda: bool) -> Dict[str, float]:
    """{name: ms a unit} summed over ``records``."""
    out = {n: 0.0 for n in names}
    for r in records:
        if r.name in out:
            out[r.name] += span_ms(r, cuda) / units
    return out


def merged(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two sorted, merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def profiled_slice(unit, dev, until):
    """Units under the profiler (the card's activity; the host's on the
    CPU) after one warm-up unit, the recorder reset at the slice's start:
    (device activities [(name, start us, end us)], the profile's
    trace_start_ns, units run, the slice's records)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = dev.type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   acc_events=True)
    prof.start()
    unit(0)
    _sync(dev)
    prof.step()
    profiling.reset()
    n, t0 = 0, time.perf_counter()
    while not until(n, time.perf_counter() - t0):
        unit(n)
        n += 1
    _sync(dev)
    prof.step()
    prof.stop()
    records = profiling.spans()
    acts = [(ev.name, float(ev.time_range.start), float(ev.time_range.end))
            for ev in prof.events()
            if getattr(ev.device_type, "name", "") == "CUDA"
            and not ev.name.startswith("ProfilerStep")]
    return acts, prof.profiler.kineto_results.trace_start_ns(), n, records


def abba(run_off, run_on, rounds: int) -> Dict[str, List[float]]:
    """Rates of ``rounds`` pairs, off and on in turns (ABBA), the recorder
    switched and reset around each, after one window off unrecorded (the
    card's clocks and the host settle: a first window reads ~7% low)."""
    run_off()
    rates = {"off": [], "on": []}
    for r in range(rounds):
        for which in (("off", "on") if r % 2 == 0 else ("on", "off")):
            profiling.reset()
            if which == "on":
                profiling.enable()
            try:
                rates[which].append((run_on if which == "on"
                                     else run_off)())
            finally:
                profiling.disable()
    profiling.reset()
    return rates


def cost(rates) -> Dict:
    off, on = statistics.median(rates["off"]), statistics.median(rates["on"])
    return {"rates_off": rates["off"], "rates_on": rates["on"],
            "median_off": off, "median_on": on,
            "on_vs_off": on / off - 1.0}


# ------------------------------------------------------------------ infer
def infer(args, dev) -> Dict:
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.evaluation import GraphedForward
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.padding import InputPadder
    from streamflow_tpu_torch.tools.common import (graph_kernel_nodes,
                                                   init_weights)

    cuda = dev.type == "cuda"
    cfg = StreamFlowConfig(T=4, iters=args.iters, mixed_precision=True)
    model = create_model("streamflow", cfg=cfg, device=dev)
    init_weights(model, args.seed)
    rng = np.random.default_rng(args.seed)
    pad = InputPadder((args.height, args.width, 3), mode="sintel")
    ring = []
    for _ in range(4):
        clip = torch.from_numpy(rng.integers(
            0, 255, (args.batch, 4, args.height, args.width, 3)
        ).astype(np.float32))
        clip = pad.pad(clip)
        ring.append(clip.pin_memory() if cuda else clip)

    profiling.reset()
    profiling.enable()
    on = GraphedForward(model, args.iters, keep_graphs=cuda)
    on(ring[0].to(dev))                 # the process's first capture
    _sync(dev)
    out = {f"{k}_s": sum((r.end_ns - r.start_ns) / 1e9
                         for r in profiling.spans() if r.name == f"serve.{k}")
           for k in ("warmup", "capture")}
    profiling.disable()
    off = GraphedForward(model, args.iters, keep_graphs=cuda)
    off(ring[0].to(dev))
    profiling.enable()
    out["flows_equal"] = all(torch.equal(off(c.to(dev)), on(c.to(dev)))
                             for c in ring)
    profiling.disable()
    if cuda:
        n_off, n_on = (graph_kernel_nodes(next(iter(g.buckets.values()))
                                          .graph) for g in (off, on))
        out.update(kernel_nodes=len(n_off), kernel_nodes_equal=n_off == n_on)

    host = torch.empty(off(ring[0].to(dev)).shape, pin_memory=cuda)

    def request(fwd):
        def one(i):
            host.copy_(fwd(ring[i % len(ring)]))
        return one

    def window(fwd):
        def run():
            one, n, t0 = request(fwd), 0, time.perf_counter()
            while time.perf_counter() - t0 < args.seconds:
                one(n)
                n += 1
            return 3 * args.batch * n / (time.perf_counter() - t0)
        return run

    out["flows_per_s"] = cost(abba(window(off), window(on), args.rounds))
    profiling.enable()
    acts, t0_ns, n, records = profiled_slice(
        request(on), dev, lambda n, s: s >= args.trace_seconds)
    profiling.disable()
    units = sum(r.name == "serve" for r in records)
    spans = by_name(records, [s for v in STAGES.values() for s in v],
                    units, cuda)
    stages = {k: sum(spans[s] for s in v) for k, v in STAGES.items()}
    out.update(requests=n, units=units, spans_ms=spans, stages_ms=stages,
               stages_sum_ms=sum(stages.values()),
               time=("device" if cuda else "host (cpu)"))
    if cuda:
        busy = merged([(s, e) for _, s, e in acts if e > s])
        busy_ms = sum(e - s for s, e in busy) / 1e3 / units
        gaps = [[busy[i][1], busy[i + 1][0]] for i in range(len(busy) - 1)]
        serve = merged([((r.start_ns - t0_ns) / 1e3,
                         (r.end_ns - t0_ns) / 1e3)
                        for r in records if r.name in SERVE])
        idle = sum(e - s for s, e in gaps) / 1e3 / units
        program = overlap(gaps, serve) / 1e3 / units
        out.update(busy_ms=busy_ms,
                   rest_ms=busy_ms - out["stages_sum_ms"],
                   stages_share_of_busy=out["stages_sum_ms"] / busy_ms,
                   idle_ms=idle, serve_idle_ms=program,
                   client_idle_ms=idle - program)
    return out


# ------------------------------------------------------------------ train
def train(args, dev) -> Dict:
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.tools.train_bench import synthetic_batch
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step

    cuda = dev.type == "cuda"
    torch.manual_seed(args.seed)
    cfg = StreamFlowConfig(T=4, iters=args.iters, mixed_precision=True,
                           remat=True)
    model = create_model("streamflow", cfg=cfg, device=dev, train=True)
    state = TrainState.create(model, lr=1.75e-4, num_steps=180_000)
    step = make_train_step(gamma=0.85, iters=args.iters)
    batch = synthetic_batch(args.batch, 4, args.height, args.width,
                            args.seed, dev)
    step(state, batch)                      # warm-up: builds, allocator
    _sync(dev)

    saved = copy.deepcopy(state.state_dict())
    runs = []
    for on in (False, False, True):
        state.load_state_dict(copy.deepcopy(saved))
        if on:
            profiling.enable()
        loss = float(step(state, batch)["loss"])
        profiling.disable()
        runs.append((loss, [p.detach().clone() for p in model.parameters()]))
    profiling.reset()

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(x, y)
                                    for x, y in zip(a[1], b[1]))

    def gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a[1], b[1]))

    out = {"losses": [r[0] for r in runs],
           "off_off_equal": same(runs[0], runs[1]),
           "off_on_equal": same(runs[0], runs[2]),
           "off_off_max_param_gap": gap(runs[0], runs[1]),
           "off_on_max_param_gap": gap(runs[0], runs[2])}
    del runs, saved

    def one(i):
        step(state, batch)
        _sync(dev)

    def window():
        t0 = time.perf_counter()
        for i in range(args.steps):
            one(i)
        return args.batch * args.steps / (time.perf_counter() - t0)

    out["train_clips_per_s"] = cost(abba(window, window, args.rounds))
    profiling.enable()
    acts, _, n, records = profiled_slice(
        one, dev, lambda n, s: n >= args.trace_steps)
    profiling.disable()
    units = sum(r.name == "step" for r in records)
    phases = by_name(records, STEP, units, cuda)
    ids = {r.id: r for r in records}
    model_spans: Dict[str, float] = {}
    for r in records:
        if r.name in STEP or r.name == "step":
            continue
        up = ids.get(r.parent)
        while up is not None and up.name not in STEP:
            up = ids.get(up.parent)
        key = f"{up.name if up else '-'}/{r.name}"
        model_spans[key] = model_spans.get(key, 0.0) + span_ms(r, cuda) / units
    out.update(steps=n, units=units, phases_ms=phases,
               phases_sum_ms=sum(phases.values()), model_spans_ms=model_spans,
               time=("device" if cuda else "host (cpu)"))
    if cuda:
        busy = merged([(s, e) for _, s, e in acts if e > s])
        out["busy_ms"] = sum(e - s for s, e in busy) / 1e3 / units
        out["phases_share_of_busy"] = out["phases_sum_ms"] / out["busy_ms"]
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=("infer", "train"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=2147483711)
    p.add_argument("--height", type=int)
    p.add_argument("--width", type=int)
    p.add_argument("--iters", type=int)
    p.add_argument("--batch", type=int)
    p.add_argument("--seconds", type=float, default=5.0,
                   help="infer: each window of the cost's rounds")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--steps", type=int, default=3,
                   help="train: steps in each window of the cost's rounds")
    p.add_argument("--trace-seconds", type=float, default=4.0)
    p.add_argument("--trace-steps", type=int, default=2)
    p.add_argument("--results",
                   default=str(RESULTS_DIR / "trace_spans.txt"))
    args = p.parse_args(argv)
    shape = {"infer": (436, 1024, 15, 1), "train": (432, 960, 12, 8)}
    for k, v in zip(("height", "width", "iters", "batch"), shape[args.what]):
        if getattr(args, k) is None:
            setattr(args, k, v)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    was_on = profiling.enabled()
    try:
        out = (infer if args.what == "infer" else train)(args, dev)
    finally:
        profiling.disable()
        profiling.reset()
        if was_on:
            profiling.enable()
    record = {"tool": "trace_spans", "what": args.what, "seed": args.seed,
              "shape": [args.batch, 4, args.height, args.width],
              "iters": args.iters, **out, **device_record(args.device)}
    line = json.dumps(record)
    print(line, flush=True)
    append_results(args.results, [line])
    return record


if __name__ == "__main__":
    main()
