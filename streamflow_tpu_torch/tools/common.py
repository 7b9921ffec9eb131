"""What the serving tools (evaluate, submit, demo, test_memory, bench) and
``chip_smoke.py`` share: the canonical StreamFlow, or a two-frame
baseline (RAFT, RAFT-GMA, SKFlow), on a device with its weights from an
npz or from a seed, the relative-EPE guard, host timing, profiling, and
the card's name and power limit."""

from __future__ import annotations

import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

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
