"""One data-parallel train step of the canonical StreamFlow over N
processes, at tiny shapes: the counterpart of
``__graft_entry__.py::dryrun_multichip`` (:47-175).

    python -m streamflow_tpu_torch.tools.dryrun_multichip --n 2 \\
        [--device cuda|cpu]

It starts N processes, each one rank of a group (gloo on the CPU; NCCL
with one GPU each, ``cuda:<rank>``; rendezvous through a file store in a
temporary directory), and runs, as JAX's, two modes on a seeded global
batch of N clips (T=4, 64x64, one iteration; one clip a rank):
(1) the f32 step; (2) bf16 + remat + bidirectional, the bithings
combination (the reversed clip folded into the batch). Each mode: seeded
weights replicated from rank 0, one ``shard_train_step`` step, a finite
loss, every rank's parameters equal to rank 0's afterwards. Rank 0
prints JAX's two lines:

    dryrun_multichip(N): ok, loss=..., epe=...
    dryrun_multichip(N): bf16+remat+bidirectional ok, loss=..., epe_bw=...

Both modes always run. The exit code is 0 only if every process ends
with 0.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile

T, H, W = 4, 64, 64
TIMEOUT_S = 900      # a process's time, its model build and two steps


def _replicas_agree(model) -> bool:
    """Every rank's parameters equal rank 0's (rank 0's broadcast)."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    ok = torch.tensor([float(torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(ok)
    return int(ok.item()) == dist.get_world_size()


def run_mode(mode: int, rank: int, world: int, device) -> dict:
    """One mode on this rank: returns the step's metrics as floats."""
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.parallel import (replicate, shard_batch,
                                               shard_train_step)
    from streamflow_tpu_torch.tools.common import init_weights
    from streamflow_tpu_torch.tools.train_bench import synthetic_batch
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step

    bidir = mode == 2
    cfg = StreamFlowConfig(T=T, iters=1, mixed_precision=bidir, remat=bidir)
    model = create_model("streamflow", cfg=cfg, device=device, train=True)
    init_weights(model, mode)
    replicate(model)
    state = TrainState.create(model, lr=1e-4, num_steps=100)
    batch = shard_batch(synthetic_batch(world, T, H, W, mode, "cpu", bidir),
                        rank, world)
    step = shard_train_step(make_train_step(0.85, 1, bidirectional=bidir))
    metrics = step(state, {k: v.to(device) for k, v in batch.items()})
    out = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"mode {mode}: non-finite metrics {out}")
    if not _replicas_agree(model):
        raise AssertionError(f"mode {mode}: the ranks' parameters differ")
    return out


def worker(rank: int, world: int, store: str, device: str) -> None:
    from streamflow_tpu_torch.parallel import initialize, local_device
    from streamflow_tpu_torch.parallel.multihost import shutdown

    initialize(f"file://{store}", world, rank, device=device)
    dev = local_device(device)
    try:
        m1 = run_mode(1, rank, world, dev)
        if rank == 0:
            print(f"dryrun_multichip({world}): ok, loss={m1['loss']:.4f}, "
                  f"epe={m1['epe']:.3f}", flush=True)
        m2 = run_mode(2, rank, world, dev)
        if rank == 0:
            print(f"dryrun_multichip({world}): bf16+remat+bidirectional ok, "
                  f"loss={m2['loss']:.4f}, epe_bw={m2['epe_bw']:.3f}",
                  flush=True)
    finally:
        shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2, help="number of processes")
    p.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    p.add_argument("--worker", type=int, default=None,
                   help=argparse.SUPPRESS)   # a process's rank
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.n, args.store, args.device)
        return 0
    if args.device.startswith("cuda"):
        import torch

        if torch.cuda.device_count() < args.n:
            raise SystemExit(f"dryrun_multichip: {args.n} processes need "
                             f"{args.n} GPUs, {torch.cuda.device_count()} "
                             f"visible")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "streamflow_tpu_torch.tools."
             "dryrun_multichip", "--n", str(args.n), "--device", args.device,
             "--worker", str(r), "--store", os.path.join(tmp, "store")])
            for r in range(args.n)]
        codes = []
        try:
            for q in procs:
                codes.append(q.wait(timeout=TIMEOUT_S))
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
    if any(codes):
        raise SystemExit(f"dryrun_multichip: exit codes {codes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
