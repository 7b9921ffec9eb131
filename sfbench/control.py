"""The readings that a cell's limits are set from, in one process:

- the program's: for each ``--seeds`` seed, the cell's own set-up and a
  short window at its own load (``--seconds``), then the same check as a
  run's, printing each number compared;
- the control's: for each ``--control-seeds`` seed, the plain reference
  computed in float8 (``reference.ops.Prec("fp8")``: the step below the
  bfloat16 the configurations state) put in the program's place, on the
  same inputs and weights, against the float32 reference;
- a fault's, for each ``--fault-seeds`` seed of a training cell and each
  fault of ``FAULTS``: the program with every gradient made GRAD_SCALE
  times larger after its backward (an answer altered where it is
  produced), and the program stepping on the first half of each batch
  alone, the mean taken over it. A state left unchanged reads 1 by the
  median leaf's measure and needs no run.

    python3 sfbench/control.py --workload sf_sintel_infer \
        --seeds 11,12,13 --control-seeds 21,22,23 [--seconds 3]

Prints one JSON line a seed: {"side", "seed", readings...}. Runs on the
card; the tests call ``readings`` on the CPU with a smaller traffic.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

GRAD_SCALE = 1.3


def infer_readings(cell, drv, seed, seconds, device, control=False):
    from sfbench.check import flow_checks
    from sfbench.reference.ops import Prec

    loop = drv.ClosedLoop(cell, seed, device)
    if not control:
        loop.setup()
        loop.serve(seconds)
        loop.release()
        return {n: v for n, v, _ in loop.check()}
    # the program's names, shapes and dtypes, without its set-up
    from sfbench import program

    model, loop.specs, loop.dtypes = program.build(cell, seed, device)
    del model
    loop.ring = loop.make_ring(torch.device(device))
    keep = sorted(loop.keep_set(cell.traffic["checked"]))
    from sfbench import inputs
    from sfbench.check import reference_flows

    W = inputs.served(inputs.cell_weights(cell, loop.specs, seed, device),
                      loop.dtypes)
    got = {}
    for i in keep:
        slot = i % len(loop.ring)
        got[i] = (slot, reference_flows(cell, W, loop.ring[slot].to(device),
                                        Prec("fp8")).cpu())
    return {n: v for n, v, _ in flow_checks(cell, seed, loop.specs,
                                            loop.dtypes, loop.ring, got,
                                            device)}


def scaled_gradients(scale):
    """program.train_state with every gradient times ``scale`` before the
    optimizer reads it."""
    from sfbench import program

    train_state = program.train_state

    def broken(cell, model):
        state, step = train_state(cell, model)
        opt, inner = state.optimizer, state.optimizer.step

        def scaled_step(*a, **k):
            for g in opt.param_groups:
                for p in g["params"]:
                    p.grad.mul_(scale)
            return inner(*a, **k)

        opt.step = scaled_step
        return state, step

    return broken


def half_batch():
    """program.train_state whose step sees the first half of each batch
    only."""
    from sfbench import program

    train_state = program.train_state

    def broken(cell, model):
        state, step = train_state(cell, model)

        def half(st, batch):
            return step(st, {k: v[:max(1, v.shape[0] // 2)]
                             for k, v in batch.items()})

        return state, half

    return broken


FAULTS = {"gradients_x1.3": lambda: scaled_gradients(GRAD_SCALE),
          "half_batch": half_batch}


def train_readings(cell, drv, seed, device, control=False, fault=None):
    from sfbench import inputs, program
    from sfbench.check import train_readings as readings
    from sfbench.reference import train as reftrain
    from sfbench.reference.ops import Prec

    loop = drv.TrainLoop(cell, seed, device)
    if fault is not None:
        sound = program.train_state
        program.train_state = FAULTS[fault]()
        try:
            loop.setup()
        finally:
            program.train_state = sound
        loop.release()
        prog = loop.prog
    elif not control:
        loop.setup()
        loop.release()
        prog = loop.prog
    else:
        model, loop.specs, _ = program.build(cell, seed, device, train=True)
        del model
        loop.batches = drv.make_batches(cell, seed, device)
        W = inputs.cell_weights(cell, loop.specs, seed, device)
        r = reftrain.steps(cell.reference, W,
                           loop.batches[:cell.traffic["checked"]],
                           cell.config, cell.traffic, Prec("fp8"))
        prog = {"loss": r["loss"], "grad1": r["grad1"],
                "params": r["params"]}
    W = inputs.cell_weights(cell, loop.specs, seed, device)
    return readings(cell, W, loop.batches, prog)


def readings(cell, seed, seconds, device, control=False, files=None,
             fault=None):
    from sfbench import cell as cells

    drv = cells.driver(cell, files or cells.HERE)
    if cell.traffic["driver"] == "train_steps":
        return train_readings(cell, drv, seed, device, control, fault)
    return infer_readings(cell, drv, seed, seconds, device, control)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    root = Path.cwd()
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(root)] + [d for d in sys.path if d != here]
    from sfbench import cell as cells
    from sfbench.run import cache_dirs

    cache_dirs(root)
    cell = cells.load(args.workload, root / "BENCHMARK.json")
    runs = [("program", None, args.seeds),
            ("control", None, args.control_seeds)]
    runs += [(f"fault {f}", f, args.fault_seeds) for f in FAULTS]
    for side, fault, seeds in runs:
        for s in filter(None, seeds.split(",")):
            r = readings(cell, int(s), args.seconds, "cuda",
                         control=side == "control", fault=fault)
            print(json.dumps(dict(side=side, seed=int(s), **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
