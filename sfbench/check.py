"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``sfbench/reference``) run on the same
inputs and the same weights (made again from the seed, rounded to the
dtype the program holds each in), after the window and after the
program's state is freed. Each check is (name, value, limit) and passes
when value <= limit; the limits are the cell's ``limits/<cell>.json``.

Inference: ``flow_gap``, the largest over the kept requests of the mean
end-point distance between the served flows and the reference's over the
mean length of the reference's flows; ``nonfinite``, the count of
non-finite served values (limit 0).

Training: over the steps that set-up drove (``checked``), the readings
of ``train_readings``; a cell compares those its limits name. A leaf's
gap is |norm(program) - norm(reference)| over the larger of the
reference leaf's norm and the median leaf's: ``grad_median_gap``, the
median over leaves of that gap for step 1's clipped gradient, as the
program's AdamW state holds it after that step; ``change_median_gap``,
the same for each leaf's change over the steps; ``loss1_gap``, the
relative gap of step 1's loss; ``grad_gap``, ``change_gap`` and
``loss_gap``, the largest over leaves or steps, kept for the record.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are not counted.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

from sfbench import inputs
from sfbench.reference import train as reftrain
from sfbench.reference.ops import Prec

GRAD_FLOOR = 1e-3


def strict_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def reference_flows(cell, W, clip, pr: Prec = Prec()) -> torch.Tensor:
    """The reference's flows for one request (the program's layout)."""
    strict_f32()
    iters = cell.traffic["iters"]
    with torch.no_grad():
        return cell.reference.forward(W, clip, cell.config, iters, pr)


def flow_gap(flows: torch.Tensor, ref: torch.Tensor) -> float:
    epe = (flows.float() - ref).norm(dim=-1).mean()
    return float(epe / ref.norm(dim=-1).mean().clamp(min=1e-12))


def flow_checks(cell, seed, specs, dtypes, ring, got: Dict[int, Tuple],
                device, pr: Prec = Prec()) -> List:
    """got: {request: (ring slot, its flows on the host)}."""
    W = inputs.served(inputs.cell_weights(cell, specs, seed, device), dtypes)
    refs, gaps, bad = {}, [], 0
    for _, (slot, flows) in sorted(got.items()):
        if slot not in refs:
            refs[slot] = reference_flows(cell, W, ring[slot].to(device), pr)
        f = flows.to(device)
        bad += int((~torch.isfinite(f)).sum())
        gaps.append(flow_gap(f, refs[slot]))
    r = {"flow_gap": max(gaps), "nonfinite": bad}
    return [(k, r[k], lim) for k, lim in cell.limits.items()]


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keys
              ) -> Dict[str, float]:
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keys}



def train_readings(cell, W: Dict[str, torch.Tensor], batches, prog: Dict,
                   pr: Prec = Prec()) -> Dict[str, float]:
    """prog: {"loss": [3 losses], "grad1": {leaf: step 1's clipped
    gradient}, "params": {leaf: after step 3}}."""
    strict_f32()
    n = len(prog["loss"])
    ref = reftrain.steps(cell.reference, W, batches[:n], cell.config,
                         cell.traffic, pr)
    g_ref = _norms(ref["grad1"])
    med = statistics.median(g_ref.values())
    keys = sorted(k for k, v in g_ref.items() if v >= GRAD_FLOOR * med)
    d_ref = _norms({k: ref["params"][k] - W[k] for k in keys})
    d_got = _norms({k: prog["params"][k].float() - W[k] for k in keys})
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                     ref["loss"])]
    grad = leaf_gaps(_norms({k: prog["grad1"][k] for k in keys}), g_ref,
                     keys)
    change = leaf_gaps(d_got, d_ref, keys)
    return {"loss_gap": max(loss_gaps), "loss1_gap": loss_gaps[0],
            "grad_gap": max(grad.values()),
            "grad_median_gap": statistics.median(grad.values()),
            "change_gap": max(change.values()),
            "change_median_gap": statistics.median(change.values()),
            # what the numbers are made of, for the record
            "loss_gaps": loss_gaps, "losses": ref["loss"],
            "grad_worst": max(grad, key=grad.get),
            "change_worst": max(change, key=change.get),
            "leaves_counted": len(keys), "leaves": len(g_ref)}


def train_checks(cell, W, batches, prog) -> List:
    r = train_readings(cell, W, batches, prog)
    return [(k, r[k], lim) for k, lim in cell.limits.items()]
