"""The card's peaks, the kernel groups and the reading of a profiler trace
(frozen copies of the port's measuring helpers: its tools may change, the
yardstick may not).

H100 SXM peaks, NVIDIA's data sheet, dense: 989 TFLOP/s bf16, 3.35 TB/s
HBM. Every product of a model is counted against the bf16 peak.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Optional, Tuple

PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
NAME_CHARS = 160          # a kernel's name in the breakdown, cut to this

# (substring of a kernel's lower-cased name, its group): the port's
# kernels and PyTorch's and its libraries' kernels by kind; the first
# match wins, "other" otherwise
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
    key = name.lower()
    for pat, group in KERNEL_GROUPS:
        if pat in key:
            return group
    return "other"


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the products
    at the bf16 peak and the bytes at the memory rate."""
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)


def smi() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def union_s(spans: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) spans in us."""
    return sum(e - s for s, e in merged(spans)) / 1e6


def merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """A profiled slice of a run's window: its device activities (name,
    start us, end us), its host ops (name, start us, end us), the slice's
    host seconds and the work it held (requests or steps)."""

    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window_s: float,
                 units: int):
        self.device, self.host = device, host
        self.window_s, self.units = window_s, units
        # (seconds, units) of the window after the traced slice, once the
        # profiler has stopped: the pace without the profiler's cost
        self.rest = None

    def wall_per_unit(self) -> float:
        """Host seconds a request or step: of the untraced rest of the
        window where it has one, else of the traced slice."""
        s, n = self.rest if self.rest else (self.window_s, self.units)
        return s / n

    @classmethod
    def from_profile(cls, prof, window_s: float, units: int) -> "Trace":
        device, host = [], []
        for ev in prof.events():
            tr = ev.time_range
            if ev.name.startswith("ProfilerStep"):
                continue
            kind = getattr(ev.device_type, "name", str(ev.device_type))
            if kind == "CUDA":
                device.append((ev.name, float(tr.start), float(tr.end)))
            elif kind == "CPU":
                host.append((ev.name, float(tr.start), float(tr.end)))
        return cls(device, host, window_s, units)

    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.device if e > s])

    def device_s(self, pred) -> float:
        """Summed device seconds of the activities whose name ``pred``
        takes."""
        return sum(e - s for n, s, e in self.device if pred(n)) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest gaps between busy spans, each named by the host op
        that began last before the gap's end and ran into it."""
        busy = merged([(s, e) for _, s, e in self.device if e > s])
        gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1],
                        busy[i + 1][0]) for i in range(len(busy) - 1)),
                      reverse=True)[:n]
        out = []
        for length, g0, g1 in gaps:
            name, best = "unknown", -1.0
            for hn, hs, he in self.host:
                if hs <= g1 and he >= g0 and hs > best:
                    name, best = hn, hs
            out.append([name, length / 1e6])
        return out
