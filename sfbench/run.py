"""Run one cell of the port's benchmark once and print its result line.

    python -m sfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (BENCHMARK.json there). The cell's files are
found by the names in BENCHMARK.json (``sfbench/cell.py``). With
``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` a slice of the window runs under the profiler and the
metrics are its per-layer ones, with ``device.busy_s`` / ``window_s`` and
a ``breakdown``. Every run checks what the timed path produced against
the plain reference after the window, prints each number compared beside
its limit as the last lines of standard error, and prints the result as
one JSON line, last on standard output, with the checks last in it.

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, or if a module of JAX or of the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "streamflow_tpu")


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into build/streamflow_tpu_torch/ by
    itself)."""
    base = root / "build" / "sfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"sfbench: {msg}", file=sys.stderr, flush=True)


def result_line(cell, res: dict, trace: bool, device: dict) -> dict:
    """The contract's last line from a driver's result."""
    from sfbench.cell import read_metrics

    if trace:
        metrics = read_metrics(cell, res["view"])
    else:
        values = dict(res["metrics"], setup_s=res["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = res["checks"]
    line = {"correct": all(v <= lim for _, v, lim in checks),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if trace:
        tr = res["view"].trace
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = Path.cwd()
    cache_dirs(root)
    # the checkout's root, not this file's directory, heads the path
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(root)] + [d for d in sys.path if d != here]
    from sfbench import cell as cells

    cell = cells.load(args.workload, root / "BENCHMARK.json")
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
            f"{cards}")
        return 2
    try:
        import streamflow_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program is not in this checkout: {e}")
        return 2
    drv = cells.driver(cell)
    res = drv.run(cell, args.seed, args.seconds, bool(args.trace),
                  t_start=T_START)
    log(f"set-up {res['setup_s']:.3f} s, window {res['window_s']:.3f} s, "
        f"{res['attempted']} done, check {res['check_s']:.3f} s, peak "
        f"with the check {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
        f"GiB")
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3
    from sfbench.counts.profile import smi

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if args.trace:
        device["busy_s"] = res["view"].trace.busy_s()
        device["window_s"] = res["view"].trace.window_s
    device["card"] = smi()
    line = result_line(cell, res, bool(args.trace), device)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
