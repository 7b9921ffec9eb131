"""Training steps back to back on one device: the port's train step on a
ring of ``ring`` batches made on the device from the seed, each step
ended by a synchronize.

Set-up builds one TrainState and drives it through the first
``checked`` steps (on the ring's first batches: rows that all differ),
through the same step function and feed as the window, which takes that
same state on from batch ``checked``. The program's losses of those
steps, its step-1 gradient as AdamW's first moment holds it, and its
parameters after them are kept for the check, which runs the plain
reference's steps from the same weights on the same batches after the
window.

A batch: ``batch`` clips of ``frames`` frames of ``height`` x ``width``
pixels (``sfbench/inputs.py``), their flows as the targets, and valid
masks with a seeded ``invalid`` share of 8 x 8 blocks left out. The
check's reference runs ``ref_rows`` rows of a batch at a time.

End-to-end: ``train_clips_per_s`` (batch x steps of the window over its
seconds), ``peak_mem_gib`` (the allocator's peak over the window).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from sfbench import inputs, program
from sfbench.check import train_checks
from sfbench.counts.flops import train_flops
from sfbench.window import run_loop, run_window


def make_batches(cell, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    t = cell.traffic
    n, b, fr = t["ring"], t["batch"], t["frames"]
    h, w = t["height"], t["width"]
    video, u = inputs.clips(n * b, fr, h, w, t["max_disp"], seed, 2, device)
    g = inputs.generator(seed, 3, device)
    keep = (torch.rand(n * b, fr - 1, h // 8, w // 8, generator=g,
                       device=device) >= t["invalid"]).float()
    valids = F.interpolate(keep, size=(h, w), mode="nearest")
    flows = u[:, None].expand(-1, fr - 1, -1, -1, -1)
    out = []
    for i in range(n):
        s = slice(i * b, (i + 1) * b)
        out.append({"images": video[s].contiguous(),
                    "flows": flows[s].contiguous(),
                    "valids": valids[s].contiguous()})
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class TrainLoop:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)

    def setup(self):
        cell, t = self.cell, self.cell.traffic
        self.model, self.specs, _ = program.build(cell, self.seed,
                                                  self.device, train=True)
        self.state, self.step = program.train_state(cell, self.model)
        self.batches = make_batches(cell, self.seed, self.device)
        params = dict(self.model.named_parameters())
        losses = []
        for i in range(t["checked"]):
            m = self.step(self.state, self.batches[i])
            losses.append(float(m["loss"]))
            if i == 0:
                opt = self.state.optimizer
                # AdamW's first moment after one step: (1 - beta1) g
                b1 = opt.param_groups[0]["betas"][0]
                grad1 = {k: opt.state[p].get("exp_avg", torch.zeros_like(p))
                         / (1 - b1) for k, p in params.items()}
        self.prog = {"loss": losses, "grad1": grad1,
                     "params": {k: p.detach().clone()
                                for k, p in params.items()}}
        self.next = t["checked"]
        _sync(self.device)

    def serve(self, seconds: float, trace: bool = False) -> Dict:
        t, dev = self.cell.traffic, self.device
        n = len(self.batches)

        def step(_=None):
            self.step(self.state, self.batches[self.next % n])
            self.next += 1
            _sync(dev)

        win = run_window(step, seconds, dev, trace=trace, warmup=step,
                         slice_done=lambda k, _: k >= t["trace_steps"])
        peak = win.memory_peak_bytes
        return {"attempted": win.units, "window_s": win.seconds,
                "start": win.start, "memory_peak_bytes": peak,
                "trace": win.trace,
                "metrics": {"train_clips_per_s": t["batch"] * win.units
                            / win.seconds,
                            "peak_mem_gib": peak / 2 ** 30}}

    def model_flops(self) -> float:
        c = self.cell
        return train_flops(c.reference, c.config, c.traffic, self.specs)

    def release(self):
        del self.state, self.step, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List:
        W = inputs.cell_weights(self.cell, self.specs, self.seed,
                                self.device)
        return train_checks(self.cell, W, self.batches, self.prog)


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = None) -> Dict:
    """One run of the cell: set-up, window, check."""
    return run_loop(TrainLoop(cell, seed, device), seconds, trace, t_start)
