"""What a per-layer metric's reader is given: the cell, the traced slice
of the window (``counts.profile.Trace``: its device activities and host
ops, its seconds and the requests or steps it held) and the model FLOPs
of one request or step (``counts.flops``)."""

from __future__ import annotations

import dataclasses

from sfbench.counts.profile import Trace


@dataclasses.dataclass
class View:
    cell: object
    trace: Trace
    model_flops: float

    @property
    def units(self) -> int:
        return self.trace.units

    @property
    def window_s(self) -> float:
        return self.trace.window_s
