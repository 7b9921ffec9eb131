"""Closed-loop inference: one client sends a request, waits for its flows
in host memory, and sends the next, for the whole window.

A request is one clip of ``frames`` frames (or one frame pair, for a
two-frame model) of ``height`` x ``width`` pixels, replicate-padded to
``padded``, float32 in pinned host memory, from a ring of ``ring`` clips
made from the seed. Its time runs from the call with the clip in host
memory to its flows copied to host memory; the flows of ``checked``
requests drawn from the seed, and of the last one, are kept and compared
with the plain reference once the window has closed.

End-to-end: ``flows_per_s`` (flow fields delivered in the window over its
seconds: a clip gives frames - 1 of them, a pair one), ``latency_ms_p95``
(of every request of the window), ``peak_mem_gib`` (the allocator's peak
over the window).
"""

from __future__ import annotations

import random
from typing import Dict, List

import torch

from sfbench import inputs, program
from sfbench.check import flow_checks
from sfbench.counts.flops import infer_flops
from sfbench.window import run_loop, run_window


class ClosedLoop:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        t = cell.traffic
        # a clip of T frames gives T - 1 flows, a frame pair one
        self.flows_per_request = (t["frames"] - 1) * t["batch"]

    # ------------------------------------------------------------ set-up
    def setup(self):
        cell, t, dev = self.cell, self.cell.traffic, self.device
        self.model, self.specs, self.dtypes = program.build(cell, self.seed,
                                                            dev)
        self.ring = self.make_ring(dev)
        self.graph, self.call = program.graphed(cell, self.model)
        for i in range(t["warmup"]):
            self.call(self.ring[i % len(self.ring)])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def make_ring(self, dev) -> List[torch.Tensor]:
        t = self.cell.traffic
        n, b = t["ring"], t["batch"]
        video, _ = inputs.clips(n * b, t["frames"], t["height"], t["width"],
                                t["max_disp"], self.seed, 1, dev)
        video = inputs.pad_rows(video, *t["padded"])
        video = video.reshape(n, b, *video.shape[1:])
        pin = dev.type == "cuda"
        return [v.cpu().pin_memory() if pin else v.clone() for v in video]

    def keep_set(self, n: int) -> set:
        rng = random.Random(self.seed)
        return set(rng.sample(range(self.cell.traffic["draw_from"]), n))

    # ------------------------------------------------------------ window
    def serve(self, seconds: float, trace: bool = False) -> Dict:
        """The window: requests until ``seconds`` have passed; with
        ``trace`` its first ``trace_seconds`` under the profiler."""
        t = self.cell.traffic
        keep = self.keep_set(t["checked"])
        ring = self.ring
        out_shape = self.call(ring[0]).shape
        host = torch.empty(out_shape, pin_memory=self.device.type == "cuda")
        kept = {}

        def request(i):
            host.copy_(self.call(ring[i % len(ring)]))

        def after(i):
            if i in keep:
                kept[i] = host.clone()

        win = run_window(request, seconds, self.device, trace=trace,
                         warmup=lambda: request(0), after=after,
                         slice_done=lambda n, s: s >= t["trace_seconds"])
        kept[win.units - 1] = host.clone()
        self.kept = kept
        lat = sorted(win.unit_s)
        p95 = lat[min(len(lat) - 1, int(0.95 * len(lat)))]
        peak = win.memory_peak_bytes
        return {"attempted": win.units, "window_s": win.seconds,
                "memory_peak_bytes": peak, "start": win.start,
                "trace": win.trace,
                "metrics": {
                    "flows_per_s": self.flows_per_request * win.units
                    / win.seconds,
                    "latency_ms_p95": 1e3 * p95,
                    "peak_mem_gib": peak / 2 ** 30}}

    # ------------------------------------------------------------ check
    def model_flops(self) -> float:
        c = self.cell
        return infer_flops(c.reference, c.config, c.traffic, self.specs)

    def release(self):
        """Free the program's state before the reference runs."""
        del self.graph, self.call, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List:
        """[(name, value, limit)] of the kept requests against the plain
        reference at the timed sizes."""
        ring = len(self.ring)
        got = {i: (i % ring, flows) for i, flows in self.kept.items()}
        return flow_checks(self.cell, self.seed, self.specs, self.dtypes,
                           self.ring, got, self.device)


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = None) -> Dict:
    """One run of the cell: set-up, window, check."""
    return run_loop(ClosedLoop(cell, seed, device), seconds, trace, t_start)
