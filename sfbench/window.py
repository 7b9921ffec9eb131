"""The measured window and the run around it, the same for every driver:
set-up, then the profiler's warm-up unit and the peak reset, units back
to back until ``seconds`` have passed (the traced slice at the start,
the untraced rest after it), then the program's state freed and the
check. A driver gives its own unit of work (a request, a step), its own
bookkeeping after each, and its set-up and check."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, List, Optional

import torch

from sfbench.counts.profile import Trace
from sfbench.view import View


def freeze_setup():
    """Collect, then move what set-up made out of the collector's reach:
    the window's collections scan only what the window makes."""
    gc.collect()
    gc.freeze()


def profiler(cuda: bool):
    """A profiler whose first step is a warm-up and whose second is the
    traced slice. It records the card's activity and the CUDA runtime
    calls only: tracing the host's ops too would slow a training step's
    host side by half. On the CPU (the tests) it records the host."""
    from torch.profiler import ProfilerActivity, profile, schedule

    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   acc_events=True)


@dataclasses.dataclass
class Window:
    start: float                 # perf_counter at the window's start
    seconds: float               # its length, to the end of its last unit
    units: int                   # requests or steps completed in it
    unit_s: List[float]          # each unit's host seconds
    memory_peak_bytes: int       # the allocator's peak over the window
    trace: Optional[Trace]       # the traced slice, with ``--trace 1``


def run_window(unit: Callable[[int], None], seconds: float, device, *,
               trace: bool = False, warmup: Callable[[], None] = None,
               slice_done: Callable[[int, float], bool] = None,
               after: Callable[[int], None] = None) -> Window:
    """Units ``unit(i)`` back to back, each ending with its result on the
    host or the device synchronized, until ``seconds`` have passed.
    With ``trace``, ``warmup()`` runs under the profiler's warm-up step
    and the slice is traced until ``slice_done(units, elapsed)``; the
    rest of the window runs untraced and its pace goes with the trace.
    ``after(i)`` runs after unit i, outside its time."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    prof = traced = None
    if trace:
        prof = profiler(cuda)
        prof.start()
        warmup()
        if cuda:
            torch.cuda.synchronize(device)
        prof.step()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    freeze_setup()
    unit_s: List[float] = []
    i = resumed = 0
    start = now = resume = time.perf_counter()
    while now - start < seconds:
        t0 = time.perf_counter()
        unit(i)
        now = time.perf_counter()
        unit_s.append(now - t0)
        if after is not None:
            after(i)
        i += 1
        if prof is not None and slice_done(i, now - start):
            prof.step()
            prof.stop()
            traced, prof = (prof, now - start, i), None
            now = resume = time.perf_counter()
            resumed = i
    end = now
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if prof is not None:                  # a window shorter than the slice
        prof.step()
        prof.stop()
        traced = (prof, end - start, i)
    win = Window(start, end - start, i, unit_s, peak, None)
    if traced is not None:                # read once the window has closed
        win.trace = Trace.from_profile(*traced)
        if resumed and i > resumed:       # the untraced rest
            win.trace.rest = (end - resume, i - resumed)
    return win


def run_loop(loop, seconds: float, trace: bool, t_start: float = None):
    """One run of a driver's ``loop``: ``setup()``, ``serve(seconds,
    trace)`` (its window, a dict with ``start`` and ``trace``),
    ``release()`` of the program's state, ``check()``; with a trace, the
    per-layer metrics' view of it with ``model_flops()``."""
    loop.setup()
    res = loop.serve(seconds, trace)
    res["setup_s"] = res.pop("start") - (t_start or 0.0)
    loop.release()
    t0 = time.perf_counter()
    res["checks"] = loop.check()
    res["check_s"] = time.perf_counter() - t0
    res["failed"] = 0
    traced = res.pop("trace")
    if traced is not None:
        res["view"] = View(loop.cell, traced, loop.model_flops())
    return res
