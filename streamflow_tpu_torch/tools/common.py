"""What the serving tools (evaluate, submit, demo, test_memory, bench) and
``chip_smoke.py`` share: the canonical StreamFlow, or a two-frame
baseline (RAFT, RAFT-GMA, SKFlow), on a device with its weights from an
npz or from a seed, the relative-EPE guard, host timing, profiling, and
the card's name and power limit; and what the kernel probes (probe_lookup,
probe_cmajor_ffn, probe_gelu_ffn, probe_1080p_fault) share: CUDA-event
timing, the card's peak rates and the kernel-against-plain rule."""

from __future__ import annotations

import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

# Random weights make a feedback loop through the flow input of the motion
# encoder: at the fan-in scale the flows grow ~2.7x per iteration, to
# ~1e8 px after 12, where K1's windows all fall out of range. The flow
# head's output layer is scaled down so that the 12-iteration flows stay
# in the range of real footage (tens of px, a few hundred at most).
FLOW_HEAD_SCALE = 2e-3

# where the measuring tools (probe_bf16, probe_guard, sweep_e2e,
# trace_e2e) append their results: the repository's chiprun_out/
RESULTS_DIR = Path(__file__).resolve().parents[2] / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): a kernel's bound is the
# larger of its FLOPs / the peak rate of its io type and its bytes / the
# memory rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BF16, HBM_BYTES_PER_S = PEAK_FLOPS["bfloat16"], 3.35e12

# a kernel against its plain version: f32 atol = rtol = F32_TOL; bf16
# BF16_ULPS ulp of the plain value + BF16_FLOOR * max|plain| (the two
# round to bf16 at the same points)
F32_TOL = 1e-4
BF16_ULPS, BF16_FLOOR = 2, 2.0 ** -9

# the CLIs' two-frame --model values (JAX tools/evaluate.py, train_2f.py)
# -> the registry's names, whose configs are the ones JAX's CLIs build
TWO_FRAME = {"raft": "raft", "gma": "raft_gma", "sk": "skflow"}


def init_weights(model, seed: int) -> None:
    """Fan-in-scaled random weights (like the JAX package's oracle tests):
    every >= 2-D parameter r / sqrt(fan_in), LayerNorm weights 1 + 0.1 r,
    other vectors 0.05 r; then the flow head's output layer times
    FLOW_HEAD_SCALE. GMA's gamma and the temporal layer's zero-init
    weights become live, so K3's GMA output is not multiplied by zero."""
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
        # the SK head's last 1x1 conv (StreamFlow, SKFlow) or RAFT's
        # FlowHead conv2
        head = model.update_block.flow_head
        out = head.ffn2[2] if hasattr(head, "ffn2") else head.conv2
        out.weight.mul_(FLOW_HEAD_SCALE)
        out.bias.mul_(FLOW_HEAD_SCALE)


def add_model_args(p, iters: int) -> None:
    """The arguments every serving tool takes to build its model."""
    p.add_argument("--ckpt", default=None,
                   help=".npz params file in the JAX package's flax layout")
    p.add_argument("--iters", type=int, default=iters)
    p.add_argument("--T", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--fp32", action="store_true",
                   help="f32 compute (default bf16, the released config)")


def build_model(args, seed: int = 0, name: str = "streamflow"):
    """The canonical StreamFlow of ``args`` (``add_model_args``), or the
    two-frame baseline of a TWO_FRAME ``name``, on ``args.device``,
    its weights from ``args.ckpt`` or, without one, random from ``seed``
    (``init_weights``) with a warning."""
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax
    from streamflow_tpu_torch.training.checkpoint import load_variables_npz

    kw = dict(iters=args.iters, mixed_precision=not args.fp32)
    if name == "streamflow":
        kw["T"] = args.T
    model = create_model(TWO_FRAME.get(name, "streamflow"),
                         device=args.device, **kw)
    if args.ckpt:
        load_jax(model, load_variables_npz(args.ckpt))
    else:
        print(f"WARNING: no --ckpt given; running random weights (seed "
              f"{seed})", file=sys.stderr)
        init_weights(model, seed)
    return model


def rel_epe(flows: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
    """Relative EPE of ``flows`` against ``ref`` (both (..., 2), on the
    CPU): global, max EPE / max(1, max |ref|) as bench.py:146, and the
    per-pixel p99 of EPE / max(1, |ref|) over every 7th pixel."""
    mag = ref.norm(dim=-1)
    epe = (flows - ref).norm(dim=-1)
    per_px = (epe / mag.clamp(min=1.0)).flatten()[::7].double()
    return (float(epe.max()) / max(1.0, float(mag.max())),
            float(torch.quantile(per_px, 0.99)))


def host_ms(fn, reps: int, device) -> Tuple[float, float]:
    """Host-clock ms of ``fn`` (synchronized before and after on a CUDA
    ``device``): (mean, min) of ``reps`` calls."""
    cuda = torch.device(device).type == "cuda"
    times = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sum(times) / len(times), min(times)


def profiled(fn, host: bool = True):
    """A torch.profiler profile of one call of ``fn`` on the card, taken
    after one traced warm-up call: a window's first kernels can go
    unrecorded (on an H100 an unwarmed profile of the 440x1024 forward
    missed up to two of its four LGA kernels, its first attention).
    ``host=False`` records the card's activity alone: the same device
    times, without the host ops' trace (~20 s for a train step)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if host
            else [ProfilerActivity.CUDA])
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def device_events(prof):
    """(name, count, device us) of each kernel or copy that a profile
    recorded on the card, summed by name; the step's own annotation
    (ProfilerStep#N, which spans the step on the device) is left out."""
    for ev in prof.key_averages():
        if ev.device_type.name != "CUDA" or ev.key.startswith(
                "ProfilerStep"):
            continue
        t = getattr(ev, "device_time_total", None)
        yield ev.key, ev.count, ev.cuda_time_total if t is None else t


# (substring of a kernel's lower-cased name, its group): the port's
# kernels (K1-K8, B5: the bf16 engine of K5, K6 and K8 is sk_chain, B5's
# kernels bwd_dq_, bwd_dkv_ and bwd_split_) and PyTorch's and its
# libraries' kernels by kind; the first match wins, "other" otherwise
KERNEL_GROUPS = (("corr_lookup", "corr_lookup"), ("ffn_pair", "ffn_pair"),
                 ("flash_fwd", "flash_fwd"), ("dw_chain", "dw_chain"),
                 ("sk_chain", "sk_chain"), ("dw_banded", "dw_banded"),
                 ("bwd_dq_", "flash_bwd"), ("bwd_dkv_", "flash_bwd"),
                 ("bwd_split_", "flash_bwd"), ("lga_kernel", "lga_kernel"),
                 ("conv", "conv"), ("gemm", "gemm"),
                 ("elementwise", "elementwise"), ("reduce", "reduce"),
                 ("softmax", "softmax"), ("layer_norm", "layer_norm"),
                 ("cat", "cat"), ("copy", "copy"))


def kernel_group(name: str) -> str:
    """The op group of a kernel as the profiler names it (KERNEL_GROUPS),
    as chip_smoke.py's profile tables and tools.trace_e2e report it."""
    key = name.lower()
    for pat, group in KERNEL_GROUPS:
        if pat in key:
            return group
    return "other"


def device_time_by_group(prof) -> Tuple[float, dict]:
    """(total device us, {group: device us}) of a profile's kernels and
    copies on the card (``device_events``), grouped by ``kernel_group``."""
    total, by = 0.0, {}
    for key, _, t in device_events(prof):
        if t <= 0:
            continue
        total += t
        group = kernel_group(key)
        by[group] = by.get(group, 0.0) + t
    return total, by


def smi() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them; None
    without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0]


def strict_f32() -> None:
    """f32 stays f32 on the card: no TF32 in cuBLAS's matmuls nor in
    cuDNN's convs (PyTorch lets cuDNN's f32 convs run in TF32 by default,
    which moves the f32 kernel path ~1e-3 from the plain path), as
    chip_smoke.py, train_bench and kernel_bench run."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_record(device) -> dict:
    """What a tool's result says of the device its kernels ran on: the CPU,
    or the card's name and nvidia-smi's name and power limit."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu"}
    return {"device": torch.cuda.get_device_name(dev), "card": smi()}


def append_results(path, lines) -> None:
    """Append ``lines`` to the results file ``path`` (its directory made)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as fh:
        fh.write("\n".join(lines) + "\n")


def roofline_ms(flops: float, nbytes: float,
                dt="bfloat16") -> Tuple[float, float]:
    """(ms of ``flops`` at the peak rate of io type ``dt``, a torch dtype
    or its name; ms of ``nbytes`` at the memory rate)."""
    name = str(dt).replace("torch.", "")
    return 1e3 * flops / PEAK_FLOPS[name], 1e3 * nbytes / HBM_BYTES_PER_S


def bound_ms(flops: float, nbytes: float, dt="bfloat16") -> Tuple[float, str]:
    """(least ms the card could take for the work, "operations" or
    "bytes")."""
    t_ops, t_mem = roofline_ms(flops, nbytes, dt)
    return max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


def cuda_ms(fn, reps: int, device, warmup: int = 2) -> Optional[float]:
    """ms a call of ``fn`` on the card by CUDA events around ``reps`` calls
    after ``warmup``; None (not measured, ``fn`` not run) on the CPU."""
    if torch.device(device).type != "cuda":
        return None
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


def graph_ms(fn, reps: int, device, warmup: int = 2) -> Optional[float]:
    """ms a call of ``fn`` on the card without the host's launch cost:
    ``reps`` calls captured in one CUDA graph (after ``warmup`` eager
    calls), its replay timed by CUDA events; None (not measured) on the
    CPU. A kernel of a few tens of us launched call by call from Python
    is timed at the host's pace, not the card's."""
    if torch.device(device).type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def graph_kernel_nodes(graph) -> List[str]:
    """The names (the driver's, mangled) of the kernel nodes of ``graph``,
    a torch.cuda.CUDAGraph captured with ``keep_graph=True``, child graphs
    included: what each replay launches, read from the graph itself
    through the driver API (no profiler, whose trace can drop events)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{fn} failed: CUresult {rc}")

    def walk(g, names):
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", g, None, ctypes.byref(n))
        nodes = (ptr * n.value)()
        call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
        for node in nodes:
            node, kind = ptr(node), ctypes.c_int(-1)
            call("cuGraphNodeGetType", node, ctypes.byref(kind))
            if kind.value == 5:        # CU_GRAPH_NODE_TYPE_GRAPH
                child = ptr()
                call("cuGraphChildGraphNodeGetGraph", node,
                     ctypes.byref(child))
                walk(child, names)
            elif kind.value == 0:      # CU_GRAPH_NODE_TYPE_KERNEL
                # CUDA_KERNEL_NODE_PARAMS_v2 (72 bytes): func at word 0,
                # kern (a CUkernel, where the launch named one) at word 7
                params = (ptr * 9)()
                call("cuGraphKernelNodeGetParams_v2", node, params)
                name = ctypes.c_char_p()
                if params[0]:
                    call("cuFuncGetName", ctypes.byref(name), ptr(params[0]))
                else:
                    call("cuKernelGetName", ctypes.byref(name),
                         ptr(params[7]))
                names.append(name.value.decode())
        return names

    return walk(ptr(graph.raw_cuda_graph()), [])


def bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().float().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def close_err(got, want, dt=None) -> Tuple[float, bool]:
    """(max |got - want|, whether every element is within the rule of
    io type ``dt``, by default ``want``'s): f32 atol = rtol = F32_TOL;
    else BF16_ULPS ulp of the plain value + BF16_FLOOR * max|plain|."""
    want_abs = want.float().abs()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if (want.dtype if dt is None else dt) == torch.float32:
        bound = F32_TOL + F32_TOL * want_abs
    else:
        top = float(want_abs.max()) if want_abs.numel() else 0.0
        bound = BF16_ULPS * bf16_ulp(want_abs) + BF16_FLOOR * top
    return err, bool((diff <= bound).all()) and math.isfinite(err)


def fmt_ms(ms: Optional[float]) -> str:
    return "not measured (cpu)" if ms is None else f"{ms:.4f} ms"
