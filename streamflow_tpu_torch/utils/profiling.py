"""Profiling hooks (port of streamflow_tpu/utils/profiling.py): accumulating
per-phase wall-clock timers and a ``torch.profiler`` trace context.

``phase_timer(name, sync=...)`` ends on ``torch.cuda.synchronize`` of the
device of ``sync`` (a CUDA tensor, a CUDA ``torch.device`` or a device
string) where JAX's ends on ``jax.block_until_ready``; without it, or for a
CPU tensor or device, the timer reads the host clock as it is (CPU work
is already done when the block returns). ``trace_ctx(log_dir)`` records
the host and, on a machine with a card, the card, and writes one Chrome
trace (``trace.json``, for chrome://tracing or Perfetto) into
``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

_PHASE_TOTALS: Dict[str, float] = defaultdict(float)
_PHASE_COUNTS: Dict[str, int] = defaultdict(int)


def _cuda_device(sync):
    """The CUDA device that ``sync`` names or holds, else None."""
    if isinstance(sync, torch.Tensor):
        return sync.device if sync.is_cuda else None
    dev = torch.device(sync)
    return dev if dev.type == "cuda" else None


@contextlib.contextmanager
def phase_timer(name: str, sync=None):
    """Accumulating wall-clock timer of the block under ``name``; with
    ``sync`` on the card, the block's queued device work is waited for
    before the clock is read."""
    dev = None if sync is None else _cuda_device(sync)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if dev is not None:
            torch.cuda.synchronize(dev)
        _PHASE_TOTALS[name] += time.perf_counter() - t0
        _PHASE_COUNTS[name] += 1


def phase_report() -> Dict[str, Dict[str, float]]:
    """{name: {total_s, count, mean_s}} of every timer used so far."""
    return {
        k: {"total_s": _PHASE_TOTALS[k], "count": _PHASE_COUNTS[k],
            "mean_s": _PHASE_TOTALS[k] / max(_PHASE_COUNTS[k], 1)}
        for k in _PHASE_TOTALS
    }


def phase_reset() -> None:
    """Forget every timer (a tool that reports one run's phases)."""
    _PHASE_TOTALS.clear()
    _PHASE_COUNTS.clear()


@contextlib.contextmanager
def trace_ctx(log_dir: str):
    """A ``torch.profiler`` trace of the block (the host, and the card
    when there is one), written as ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
