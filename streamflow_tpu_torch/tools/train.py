"""Training harness of the port (twin of tools/train.py; reference
train_mf.py): the multi-stage pipeline things -> sintel/kitti mix -> spring
(+ bithings), AdamW + linear OneCycle, clip by global norm, sequence loss
with gamma weighting, keep-N checkpoints with exact resume, in-training
validation with best-checkpoint tracking (``best.npz``, the JAX package's
flax layout). On the card unless ``--device cpu``.

Per-stage presets pin the canonical hyperparameters of the reference's
scripts/train_things.sh, train_sintel_kitti.sh, train_spring.sh:

  python -m streamflow_tpu_torch.tools.train --preset things
  python -m streamflow_tpu_torch.tools.train --preset sintel_kitti \\
      --restore_ckpt output/things.npz
  python -m streamflow_tpu_torch.tools.train --preset spring \\
      --restore_ckpt output/sintel.npz

Any explicit flag overrides its preset value. The flags are the JAX
CLI's, with ``--device`` added.

On N GPUs, one process per GPU (``parallel/``), under torchrun or with
JAX's multi-host flags (each process given its ``--process_id``):

  torchrun --nproc_per_node=N -m streamflow_tpu_torch.tools.train \
      --preset sintel_kitti
  python -m streamflow_tpu_torch.tools.train --preset sintel_kitti \
      --coordinator HOST:PORT --num_processes N --process_id I

``--batch_size`` is the global batch, as JAX's (tools/train.py:173-184):
it must divide by the number of processes, each of which loads and
trains on its own rows (``DataLoader(process_index, process_count)``)
with ``parallel.shard_train_step``; the model is replicated from rank 0
after its weights are set, and every rank resumes from the same
checkpoint. Rank 0 alone prints, writes ``log.txt`` and
``metrics.jsonl``, saves the checkpoints (the others wait at a barrier
until the file is complete) and validates (the eval model, its
GraphedForward and ``best.npz`` live on rank 0; the others wait).

What the loop does as the JAX CLI does:
- weights from ``--seed`` (``tools/common.py::init_weights``), or from
  ``--restore_ckpt`` (an npz in the flax layout);
- resume from the latest checkpoint in ``<output>/<name>/ckpts``; the loader
  then starts again at epoch 0, as the JAX CLI's does (tools/train.py:219);
- metrics stay on the device and are read only every ``--print_freq``
  steps;
- every ``--val_freq`` steps: a checkpoint, then the validator, then
  ``best.npz`` if the validation key improved.

Where the port differs: the training model rematerializes each refinement
step in the backward (``StreamFlowConfig.remat``; the gradients are the
same, tests/test_torch_train.py), the configuration measured on the card
(PERF.md); and validation runs on a second, inference model (bf16
parameters under ``--mixed_precision``, eval mode) built once and served
by one ``GraphedForward`` for the whole run, with the training weights
copied into it in place before each validation.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

# Canonical per-stage configs (reference scripts/train_things.sh,
# train_sintel_kitti.sh, train_spring.sh); the JAX CLI's, value for value.
PRESETS = {
    "things": dict(stage="things", num_steps=300_000, image_size=[400, 720],
                   lr=6e-4, batch_size=16, T=3, gamma=0.8,
                   validation="sintel"),
    "sintel_kitti": dict(stage="sintel", num_steps=180_000,
                         image_size=[432, 960], lr=1.75e-4, batch_size=8,
                         T=4, gamma=0.85, seed=3407, validation="kitti"),
    "spring": dict(stage="spring", num_steps=180_000, image_size=[432, 768],
                   lr=4e-4, batch_size=8, T=4, gamma=0.85, seed=3407,
                   validation="kitti"),
    "bithings": dict(stage="bithings", num_steps=300_000,
                     image_size=[400, 720], lr=6e-4, batch_size=16, T=3,
                     gamma=0.8, validation="sintel"),
}

VAL_KEY = {"sintel": "clean_epe", "kitti": "kitti_epe",
           "spring": "spring_epe"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default=None, choices=sorted(PRESETS),
                   help="canonical stage config (reference scripts/*.sh); "
                        "explicit flags override preset values")
    p.add_argument("--name", default="streamflow")
    p.add_argument("--stage", default="things",
                   choices=["things", "sintel", "sintel2", "sintel3",
                            "spring", "kitti", "bithings"])
    p.add_argument("--output", default="output")
    p.add_argument("--restore_ckpt", default=None,
                   help=".npz params to warm-start from (stage transfer)")
    p.add_argument("--num_steps", type=int, default=120000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1.75e-4)
    p.add_argument("--wdecay", type=float, default=1e-5)
    p.add_argument("--epsilon", type=float, default=1e-8)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=0.85)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--T", type=int, default=4)
    p.add_argument("--image_size", type=int, nargs=2, default=[432, 960])
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--val_freq", type=int, default=5000)
    p.add_argument("--validation", default="none",
                   choices=["none", "sintel", "kitti", "spring"],
                   help="validator run every val_freq steps; best EPE "
                        "checkpoint is kept as best.npz")
    p.add_argument("--val_iters", type=int, default=15)
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--num_workers", type=int, default=8)
    # multi-process (one per GPU): all three, or the environment that
    # torchrun sets
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port (process 0's)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--mixed_precision", action="store_true", default=True)
    p.add_argument("--no_mixed_precision", dest="mixed_precision",
                   action="store_false")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    # dataset roots
    p.add_argument("--things_root", default="datasets/flyingthings3d")
    p.add_argument("--sintel_root", default="datasets/sintel")
    p.add_argument("--multi_root", default="datasets/multi-kitti")
    p.add_argument("--hd1k_root", default="datasets/HD1k")
    p.add_argument("--spring_root", default="datasets/spring")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The arguments, with ``--preset``'s values for every flag not given
    on the command line."""
    p = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    if args.preset:
        given = {a.dest for a in p._actions for s in a.option_strings
                 if any(x == s or x.startswith(s + "=") for x in argv)}
        for k, v in PRESETS[args.preset].items():
            if k not in given:
                setattr(args, k, v)
    return args


def run_validation(which: str, fwd, args) -> Dict[str, float]:
    """The validator ``which`` over its dataset root, through ``fwd`` (the
    run's GraphedForward, of ``args.val_iters`` iterations)."""
    from streamflow_tpu_torch import evaluation

    if which == "sintel":
        return evaluation.validate_sintel(
            fwd, root=args.sintel_root, iters=args.val_iters,
            nframes=args.T, dstypes=("clean",), progress=False)
    if which == "kitti":
        return evaluation.validate_kitti(
            fwd, multi_root=args.multi_root, iters=args.val_iters,
            nframes=args.T)
    if which == "spring":
        return evaluation.validate_spring(
            fwd, root=args.spring_root, iters=args.val_iters,
            nframes=args.T, progress=False)
    return {}


@dataclasses.dataclass
class Run:
    """What ``train`` leaves: the train state, the GraphedForward of the
    eval model (None without a validator), the last validation and the
    best value of its key, and host times: ``step_t[i]``, perf_counter
    after step i + 1 of this run and its bookkeeping; the seconds of each
    checkpoint save (the last one the final save, waited for) and of each
    validation."""
    state: object
    fwd: object
    val: Dict[str, float]
    best_val: float
    step_t: List[float]
    save_s: List[float]
    val_s: List[float]


@contextlib.contextmanager
def session(args):
    """``<output>/<name>`` and this process's device, with the process
    group joined (``parallel.initialize``, from ``args.coordinator``,
    ``args.num_processes`` and ``args.process_id`` where the parser has
    them, or from torchrun's environment) and, on the primary, the run's
    prints teed into its ``log.txt`` while open; the other ranks print
    nothing. A group joined here is left at the end. The set-up of both
    trainers (this one and tools/train_2f.py)."""
    import torch

    from streamflow_tpu_torch.parallel import multihost
    from streamflow_tpu_torch.utils.logger import Tee

    owned = not multihost.is_initialized()
    rank, world = multihost.initialize(
        getattr(args, "coordinator", None),
        getattr(args, "num_processes", None),
        getattr(args, "process_id", None), device=args.device)
    out = Path(args.output) / args.name
    out.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as stack:
        if rank == 0:
            stack.callback(Tee(out / "log.txt").install().close)
        else:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        if owned:
            stack.callback(multihost.shutdown)
        device = multihost.local_device(args.device)
        print(f"device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})"
                 if device.type == "cuda" else "")
              + (f"; process {rank} of {world}" if world > 1 else ""))
        print(vars(args))
        yield out, device


def run_loop(args, out, device, state, step_fn, dataset, unit: str,
             on_checkpoint: Optional[Callable] = None):
    """The loop of both trainers: ``dataset`` (``__len__`` and
    ``load(index, rng)``) -> DataLoader -> prefetch_to_device ->
    ``step_fn(state, batch)`` until ``args.num_steps``, resuming from the
    latest checkpoint in ``<out>/ckpts`` (keep 5); metrics stay on the
    device and are read every ``args.print_freq`` steps; every
    ``args.val_freq`` steps a checkpoint, then ``on_checkpoint(step,
    logger)``; at the end a save, waited for. Returns ``Run``'s
    ``step_t`` and ``save_s``.

    In a process group of ``world`` ranks: ``args.batch_size`` is the
    global batch, each rank loads its ``batch_size // world`` rows, the
    model is replicated from rank 0 and ``step_fn`` runs as
    ``shard_train_step(step_fn)``; every rank resumes from the same
    checkpoint; rank 0 alone logs, saves (the save waited for, then a
    barrier) and calls ``on_checkpoint`` (the others wait at a
    barrier)."""
    from streamflow_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from streamflow_tpu_torch.parallel import (barrier, multihost,
                                               replicate, shard_train_step)
    from streamflow_tpu_torch.training.checkpoint import CheckpointManager
    from streamflow_tpu_torch.utils.logger import MetricsLogger

    rank, world = multihost.process_index(), multihost.process_count()
    dist = multihost.is_initialized()
    if args.batch_size % world:
        raise ValueError(f"global batch {args.batch_size} does not divide "
                         f"over {world} processes")
    print(f"training with {len(dataset)} {unit}")
    loader = DataLoader(dataset, args.batch_size // world,
                        num_workers=args.num_workers, seed=args.seed,
                        process_index=rank, process_count=world)
    if not len(loader):
        raise ValueError(f"{len(dataset)} {unit} make no batch of "
                         f"{args.batch_size}")
    if dist:
        replicate(state.model)
        step_fn = shard_train_step(step_fn)
    ckpt = CheckpointManager(str(out / "ckpts"), max_to_keep=5)
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        print(f"resumed from step {state.step}")
    barrier("pre_train")
    step_t, save_s = [], []

    def save(wait):
        t0 = time.perf_counter()
        if rank == 0:
            ckpt.save(state, wait=wait or dist)
        barrier(f"saved@{state.step}")
        save_s.append(time.perf_counter() - t0)

    logger = (MetricsLogger(str(out), args.num_steps, args.print_freq)
              if rank == 0 else None)
    cur = state.step
    if logger is not None:
        logger.step = cur
    epoch = 0
    pending = []  # (metrics on the device, lr): read at print_freq
    while cur < args.num_steps:
        for batch in prefetch_to_device(loader.epoch(epoch), device):
            metrics = step_fn(state, batch)
            cur = state.step
            # no per-step host sync: the metrics wait on the device
            # until the logger prints, by which time they are computed
            if logger is not None:
                pending.append((metrics, state.lr))
            if cur % args.print_freq == 0:
                for m, lr in pending:
                    logger.push({k: float(v) for k, v in m.items()}, lr=lr)
                pending.clear()
            if cur % args.val_freq == 0:
                save(False)
                print(f"checkpointed at step {cur}")
                if on_checkpoint is not None:
                    if rank == 0:
                        on_checkpoint(cur, logger)
                    # as long as rank 0's validation may take
                    barrier(f"validated@{cur}", timeout_s=86400)
            step_t.append(time.perf_counter())
            if cur >= args.num_steps:
                break
        epoch += 1
    for m, lr in pending:
        logger.push({k: float(v) for k, v in m.items()}, lr=lr)
    save(True)
    ckpt.close()
    if logger is not None:
        logger.close()
    print("training complete")
    return step_t, save_s


def train(args, dataset, validate: Optional[Callable] = None) -> Run:
    """The training loop of ``main`` (``run_loop``) on ``dataset``
    (``__len__`` and ``load(index, rng)``, as data/mf_datasets.py) with
    StreamFlow's train step and, when ``validate`` is given,
    ``validate(fwd) -> results`` after every checkpoint, ``fwd`` the
    run's GraphedForward of the eval model; ``VAL_KEY[args.validation]``
    of the results picks ``best.npz``. In a process group, the eval
    model, its GraphedForward, the validation and ``best.npz`` are rank
    0's alone (``fwd`` is None on the other ranks)."""
    import math

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.evaluation import GraphedForward
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.parallel import is_primary
    from streamflow_tpu_torch.params import load_jax, to_jax
    from streamflow_tpu_torch.tools.common import init_weights
    from streamflow_tpu_torch.training.checkpoint import (load_variables_npz,
                                                          save_params_npz)
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step

    with session(args) as (out, device):
        cfg = StreamFlowConfig(T=args.T, iters=args.iters,
                               mixed_precision=args.mixed_precision,
                               remat=True)
        model = create_model("streamflow", cfg=cfg, device=device,
                             train=True)
        init_weights(model, args.seed)
        if args.restore_ckpt:
            load_jax(model, load_variables_npz(args.restore_ckpt))
            print(f"restored params from {args.restore_ckpt}")
        n_params = sum(p.numel() for p in model.parameters())
        print(f"parameter count: {n_params / 1e6:.2f}M")

        state = TrainState.create(model, args.lr, args.num_steps,
                                  args.wdecay, args.epsilon, args.clip)
        step_fn = make_train_step(
            args.gamma, args.iters,
            kitti_last_pair_only=args.stage == "kitti",
            bidirectional=args.stage == "bithings")
        fwd = None
        if validate is not None and is_primary():
            fwd = GraphedForward(create_model("streamflow", cfg=cfg,
                                              device=device), args.val_iters)
        val, best_val, val_s = {}, math.inf, []

        def on_checkpoint(cur, logger):
            nonlocal val, best_val
            if fwd is None:
                return
            t0 = time.perf_counter()
            # in place (load_state_dict copies into the eval model's
            # tensors, cast to their dtype): the held graph reads them by
            # address, and new tensors would leave it replaying the old
            # weights
            fwd.model.load_state_dict(model.state_dict())
            val = validate(fwd)
            val_s.append(time.perf_counter() - t0)
            logger.push_val(cur, val)
            print(f"val@{cur}: {val}")
            key = VAL_KEY[args.validation]
            if val.get(key, math.inf) < best_val:
                best_val = val[key]
                save_params_npz(str(out / "best.npz"),
                                to_jax(model.state_dict()))
                print(f"new best {key}={best_val:.4f} -> "
                      f"{out / 'best.npz'}")

        step_t, save_s = run_loop(args, out, device, state, step_fn,
                                  dataset, "clips", on_checkpoint)
        return Run(state, fwd, val, best_val, step_t, save_s, val_s)


def main(argv=None) -> Run:
    args = parse_args(argv)
    import numpy as np

    from streamflow_tpu_torch.data.mf_datasets import fetch_dataset

    np.random.seed(args.seed)
    dataset = fetch_dataset(
        args.stage, T=args.T, image_size=tuple(args.image_size),
        things_root=args.things_root, sintel_root=args.sintel_root,
        multi_root=args.multi_root, hd1k_root=args.hd1k_root,
        spring_root=args.spring_root)
    validate = None
    if args.validation != "none":
        def validate(fwd):
            return run_validation(args.validation, fwd, args)
    return train(args, dataset, validate)


if __name__ == "__main__":
    main()
