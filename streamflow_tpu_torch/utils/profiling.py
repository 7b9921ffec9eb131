"""Profiling hooks (port of streamflow_tpu/utils/profiling.py): the port's
span recorder, accumulating per-phase wall-clock timers on top of it, and
a ``torch.profiler`` trace context that shows both.

**Spans.** ``with span(name, device=False):`` marks a block. The recorder
is off by default: ``span`` then returns one shared no-op context after a
single flag test, reading no clock and allocating nothing. ``enable()``
switches it on, ``disable()`` off, ``reset()`` forgets what it holds, and
``spans()`` returns the records (``Span``): name, id, the id of the
enclosing span (``parent``), the id of the outermost enclosing span (the
``unit``: a request in ``GraphedForward``, a step in the train step),
host start and end, and with ``device=True`` the device milliseconds
between two CUDA events recorded on the current stream at the block's
start and end. Spans nest across threads as they open: the recompute that
remat runs on the autograd thread nests under the step's backward.

Host stamps are ``time.time_ns()``, the clock the profiler stamps its own
events with: a span's ``start_ns - trace_start_ns`` (the profile's
``profiler.kineto_results.trace_start_ns()``) is in the frame of the
profile's events' ``time_range``.

A device span opened while the current stream is captured into a CUDA
graph, inside ``capturing()``, records its events as event-record nodes
of the graph (``external=True``), and its record becomes a template that
``capturing()`` hands back. Each replay stamps the events anew, so the
graph's owner calls ``replay(captured)`` before each replay: it reads the
previous replay's times into records of their own (under the span that
is open at the call, the replay's unit), and the last replay's are read by
``spans()``, which also makes the replays' records. Eager events are read
once, at ``spans()``. ``chain()`` lets neighbouring device spans share
one event (half the event nodes of a loop's spans). Without CUDA a device
span records host times only.

``phase_timer(name, sync=...)`` ends on ``torch.cuda.synchronize`` of the
device of ``sync`` (a CUDA tensor, a CUDA ``torch.device`` or a device
string) where JAX's ends on ``jax.block_until_ready``; without it, or for a
CPU tensor or device, the timer reads the host clock as it is (CPU work
is already done when the block returns). It is a span as well.
``trace_ctx(log_dir)`` records the host and, on a machine with a card, the
card, with the recorder on, and writes one Chrome trace (``trace.json``,
for chrome://tracing or Perfetto) into ``log_dir``, the program's spans
beside the profiler's events on the same timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

_PHASE_TOTALS: Dict[str, float] = defaultdict(float)
_PHASE_COUNTS: Dict[str, int] = defaultdict(int)

_ON = False
_OFF = contextlib.nullcontext()
_RECORDS: List["Span"] = []
_STACK: List["Span"] = []        # the open spans, innermost last
_EAGER: list = []                # (record, start event, end event) unread
_REPLAYED: list = []             # Captured objects with a replay unread
_CAPTURE: Optional[list] = None  # capturing()'s templates
_CHAINS: list = []               # chain()'s [level, last end event, captured]
_NEXT_ID = [0]


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]
    unit: int
    start_ns: Optional[int]          # host, time.time_ns(); None for the
    end_ns: Optional[int]            # spans a graph replay timed
    device_ms: Optional[float] = None


def _new_id() -> int:
    _NEXT_ID[0] += 1
    return _NEXT_ID[0]


class _Open:
    """An open span: its record, and where it times the device, its two
    CUDA events (the start one shared with the chain's previous span,
    ``chain``)."""

    __slots__ = ("rec", "events")

    def __init__(self, name: str, device: bool):
        parent = _STACK[-1] if _STACK else None
        sid = _new_id()
        pid = parent.id if parent else None
        self.rec = Span(name, sid, pid, parent.unit if parent else sid,
                        None, None)
        self.events = None
        if device and torch.cuda.is_available():
            captured = torch.cuda.is_current_stream_capturing()
            if not captured or _CAPTURE is not None:
                link = _CHAINS[-1] if _CHAINS and _CHAINS[-1][0] == pid \
                    else None
                if link is not None and link[1] is not None \
                        and link[2] == captured:
                    start, fresh = link[1], False
                else:
                    start, fresh = _event(captured), True
                self.events = (start, _event(captured), captured, fresh,
                               link)

    def __enter__(self):
        _STACK.append(self.rec)
        if self.events is not None and self.events[3]:
            self.events[0].record()
        self.rec.start_ns = time.time_ns()
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.time_ns()
        if self.events is not None:
            start, end, captured, _, link = self.events
            end.record()
            if link is not None:
                link[1:] = [end, captured]
            (_CAPTURE if captured else _EAGER).append((self.rec, start, end))
        _STACK.pop()
        _RECORDS.append(self.rec)
        return False


def _event(captured: bool):
    """A timing event; one recorded during a capture becomes an
    event-record node of the graph."""
    return torch.cuda.Event(enable_timing=True, external=captured)


def span(name: str, device: bool = False):
    """A context that records the block as the span ``name`` while the
    recorder is on; ``device``: also its device time on the current CUDA
    stream."""
    if not _ON:
        return _OFF
    return _Open(name, device)


class _Chain:
    def __enter__(self):
        top = _STACK[-1] if _STACK else None
        _CHAINS.append([top.id if top else None, None, False])

    def __exit__(self, *exc):
        _CHAINS.pop()
        return False


def chain():
    """A context in which the device spans opened directly in it (at its
    own level) follow one another: each starts on the previous one's end
    event, one event record for the two, so device work issued between
    two of them counts in the later one. For a run of spans with nothing
    between them worth its own time; a no-op with the recorder off."""
    if not _ON:
        return _OFF
    return _Chain()


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Forget every record and unread event (the open spans stay open)."""
    _RECORDS.clear()
    _EAGER.clear()
    for cap in _REPLAYED:
        cap.pending = None
        cap.times.clear()
    _REPLAYED.clear()


_CU: list = []     # libcuda's cuEventElapsedTime, loaded at first use


def _elapsed_ms(start, end) -> float:
    """Device ms between two events, both done, by libcuda's
    cuEventElapsedTime on their handles: a replay reads ~60 of them on
    the serving path, and torch's ``Event.elapsed_time`` takes half as
    long again for each (its device guard)."""
    import ctypes

    if not _CU:
        _CU.append(ctypes.CDLL("libcuda.so.1").cuEventElapsedTime)
    ms = ctypes.c_float()
    rc = _CU[0](ctypes.byref(ms), ctypes.c_void_p(start.cuda_event),
                ctypes.c_void_p(end.cuda_event))
    if rc != 0:
        raise RuntimeError(f"cuEventElapsedTime failed: CUresult {rc}")
    return ms.value


class Captured:
    """The device spans captured into one CUDA graph: their template
    records and events, the replay whose times are unread, and the times
    read but not yet made records (made at ``spans()``, off the serving
    path)."""

    def __init__(self, templates):
        self.templates = templates   # [(record, start event, end event)]
        self.pending = None          # (parent, unit) of the unread replay
        self.times = []              # [(parent, unit, [ms a template])]

    def take(self) -> None:
        """Reads the unread replay's times."""
        if self.pending is None:
            return
        parent, unit = self.pending
        self.pending = None
        self.templates[-1][2].synchronize()   # recorded last: all are done
        self.times.append((parent, unit, [_elapsed_ms(s, e)
                                          for _, s, e in self.templates]))

    def records(self) -> None:
        """Records of the replays read, their parents mapped to each
        replay's (the capture's own outer spans to the span that was open
        at ``replay``)."""
        for parent, unit, times in self.times:
            ids = {rec.id: _new_id() for rec, _, _ in self.templates}
            for (rec, _, _), ms in zip(self.templates, times):
                sid = ids[rec.id]
                _RECORDS.append(Span(rec.name, sid,
                                     ids.get(rec.parent, parent),
                                     sid if unit is None else unit, None,
                                     None, ms))
        self.times.clear()


@contextlib.contextmanager
def capturing():
    """Collects the device spans of a CUDA-graph capture in the block: the
    ``Captured`` it yields holds them once the block ends (none with the
    recorder off)."""
    global _CAPTURE
    outer, _CAPTURE = _CAPTURE, []
    cap = Captured(_CAPTURE)
    try:
        yield cap
    finally:
        _CAPTURE = outer


def replay(cap: Optional[Captured]) -> None:
    """Called before each replay of ``cap``'s graph: reads the previous
    replay's device times, and files the coming one under the span open
    now. Does nothing with the recorder off or without device spans."""
    if not _ON or cap is None or not cap.templates:
        return
    cap.take()
    top = _STACK[-1] if _STACK else None
    cap.pending = (top.id, top.unit) if top else (None, None)
    if cap not in _REPLAYED:
        _REPLAYED.append(cap)


def spans() -> List[Span]:
    """Every record so far, each device time read (waiting for its
    events)."""
    for rec, start, end in _EAGER:
        end.synchronize()
        rec.device_ms = _elapsed_ms(start, end)
    _EAGER.clear()
    for cap in _REPLAYED:
        cap.take()
        cap.records()
    _REPLAYED.clear()
    return list(_RECORDS)


# ------------------------------------------------------------ phase timers
def _cuda_device(sync):
    """The CUDA device that ``sync`` names or holds, else None."""
    if isinstance(sync, torch.Tensor):
        return sync.device if sync.is_cuda else None
    dev = torch.device(sync)
    return dev if dev.type == "cuda" else None


@contextlib.contextmanager
def phase_timer(name: str, sync=None):
    """Accumulating wall-clock timer of the block under ``name``, and the
    span ``name``; with ``sync`` on the card, the block's queued device
    work is waited for before the clock is read."""
    dev = None if sync is None else _cuda_device(sync)
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
            if dev is not None:
                torch.cuda.synchronize(dev)
    finally:
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


# ------------------------------------------------------------ trace export
def _chrome_events(records: List[Span], base_ns: int) -> List[dict]:
    """The records that have host times as Chrome trace complete events
    ("X", microseconds from ``base_ns``), on a track of their own."""
    return [{"ph": "X", "cat": "program_span", "name": r.name,
             "pid": "program spans", "tid": 0,
             "ts": (r.start_ns - base_ns) / 1e3,
             "dur": (r.end_ns - r.start_ns) / 1e3,
             "args": {"id": r.id, "parent": r.parent, "unit": r.unit,
                      "device_ms": r.device_ms}}
            for r in records if r.start_ns is not None]


@contextlib.contextmanager
def trace_ctx(log_dir: str):
    """A ``torch.profiler`` trace of the block (the host, and the card
    when there is one), written as ``log_dir/trace.json`` with the spans
    the block recorded (the recorder is on inside it)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on, first = _ON, len(spans())
    enable()
    try:
        with profile(activities=acts) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if not was_on:
            disable()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    trace["traceEvents"] += _chrome_events(spans()[first:],
                                          trace.get("baseTimeNanoseconds", 0))
    with open(path, "w") as fh:
        json.dump(trace, fh)
