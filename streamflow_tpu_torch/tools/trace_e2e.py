"""One profiled forward of a spec on the benchmark clip, with the device
time by op group (port of tools/trace_e2e.py).

    python -m streamflow_tpu_torch.tools.trace_e2e [spec] [--raw N]
        [--device cuda] [--height 436] [--width 1024] [--results PATH]

``spec`` is a ``sweep_e2e`` spec (default: the default config), on
``sweep_e2e``'s clip and weights (TF32 off), through ``GraphedForward`` (the
replay, after its capture, is what is profiled, as users run it:
``tools/common.py::profiled``, after one traced warm-up replay). The
groups are ``tools/common.py::kernel_group``'s, the ones of
``chip_smoke.py``'s profile tables: the port's kernels (``corr_lookup``,
``ffn_pair``, ``flash_fwd``, ``sk_chain``, ``dw_banded``, ``dw_chain``,
``lga_kernel``) and PyTorch's and its libraries' by kind (``conv``,
``gemm``, ``elementwise``, ...). ``--raw N`` also prints the N kernels of
most device time, by name. Prints a table and one JSON line, also
appended to ``--results``.

On the CPU (``--device cpu``) there is no device time: the table is the
host ops' self time (``self_cpu_time_total``), grouped the same way, and
is labelled so.
"""

from __future__ import annotations

import argparse
import json

import torch

from streamflow_tpu_torch.tools.common import (RESULTS_DIR, append_results,
                                               device_record, strict_f32)


def host_events(prof):
    """(name, count, host self us) of each op of a CPU profile."""
    for ev in prof.key_averages():
        yield ev.key, ev.count, ev.self_cpu_time_total


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("spec", nargs="?", default="default")
    p.add_argument("--raw", type=int, default=0)
    p.add_argument("--height", type=int, default=436)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--results",
                   default=str(RESULTS_DIR / "trace_results.txt"))
    args = p.parse_args(argv)
    strict_f32()

    from streamflow_tpu_torch.tools.common import (device_events, host_ms,
                                                   kernel_group, profiled)
    from streamflow_tpu_torch.tools.sweep_e2e import build, parse_spec

    cuda = torch.device(args.device).type == "cuda"
    cfg, b, fwd, imgs, _ = build(args.spec, parse_spec(args.spec),
                                 args.height, args.width, args.device)
    ms, _ = host_ms(lambda: fwd(imgs), 3, args.device)
    if cuda:
        events = list(device_events(profiled(lambda: fwd(imgs))))
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fwd(imgs)
        events = list(host_events(prof))
    what = "device" if cuda else "host self (cpu)"
    per_name, groups = {}, {}
    for name, count, us in events:
        if us <= 0:
            continue
        n, t = per_name.get(name, (0, 0.0))
        per_name[name] = (n + count, t + us)
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us
    total = sum(groups.values())
    lines = [f"trace_e2e {args.spec!r}: dw={cfg.dw_impl} iters={cfg.iters} "
             f"T={cfg.T} B={b} {tuple(imgs.shape[2:4])}; {what} time of one "
             f"forward {total / 1e3:.3f} ms (ms/clip {ms:.3f})"]
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {g:14s} {us / 1e3:9.3f} ms  "
                     f"({100 * us / max(total, 1e-9):5.1f}%)")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:args.raw]
    if top:
        lines.append(f"top {len(top)} by {what} time:")
        lines += [f"  {us / 1e3:9.3f} ms  x{n:<5d} [{kernel_group(name)}] "
                  f"{name[:100]}" for name, (n, us) in top]
    record = {"tool": "trace_e2e", "spec": args.spec, "time": what,
              "total_ms": total / 1e3, "ms_per_clip": ms,
              "groups_ms": {g: us / 1e3 for g, us in groups.items()},
              "top": [{"name": name, "count": n, "ms": us / 1e3}
                      for name, (n, us) in top],
              "shape": [args.height, args.width],
              "padded": list(imgs.shape[2:4]), **device_record(args.device)}
    lines.append(json.dumps(record))
    print("\n".join(lines), flush=True)
    append_results(args.results, lines)
    return record


if __name__ == "__main__":
    main()
