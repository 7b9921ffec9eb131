"""Worker process of tests/test_torch_parallel.py (not a test file): one
rank of a gloo group on the CPU, rendezvous through a file store.

    python tests/_torch_dist_worker.py steps   RANK WORLD STORE OUT
    python tests/_torch_dist_worker.py trainer RANK WORLD STORE OUT

``steps``: for each of CASES, two ``shard_train_step`` steps of the
port's model on this rank's rows of the global batch (``global_batch``),
from the variables the parent wrote to OUT/<case>.npz (the JAX package's
flat layout); the metrics and the state_dict after each step go to
OUT/<case>_<rank>.pt. Then, in a group of this rank alone (``new_group``),
two steps of the plain step and of ``shard_train_step`` from the same
weights on the same rows, against each other bit for bit (rank 0 the
canonical config, rank 1 'basic'): OUT/solo_<rank>.json.

``trainer``: tools/train.py::train on in-memory clips (global batch 2,
4 steps, a checkpoint and a validation every 2), counting each rank's
checkpoint writes and validations, then the latest checkpoint restored
into a fresh state against the live one bit for bit: OUT/trainer_<rank>.json
and the final state_dict in OUT/trainer_<rank>.pt.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, H, W, B = 4, 32, 32, 2      # B: the global batch, one row per rank
ITERS = 1
LR = 1e-4
# name -> (model kind, config fields, bidirectional)
CASES = {
    "canonical": ("streamflow", {}, False),
    "basic": ("streamflow", {"encoder": "basic"}, False),
    "bithings": ("streamflow", {}, True),
    "basic_bidir": ("streamflow", {"encoder": "basic"}, True),
    "raft": ("raft", {"update_block": "raft", "use_gma": False}, False),
}
GAMMA = {"streamflow": 0.85, "raft": 0.8}


def global_batch(kind, seed=7):
    """The seeded global batch of a case (numpy): uint8-range images,
    N(0, 4^2) px flows, and valid masks of 90% for row 0 and 35% for row
    1, so that the ranks' valid counts differ."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = 2 if kind == "raft" else T
    f = t - 1

    def valids():
        dens = np.array([0.9, 0.35], np.float32)[:, None, None, None]
        return (rng.random((B, f, H, W)) < dens).astype(np.float32)

    out = {"images": rng.integers(0, 256, (B, t, H, W, 3)).astype(
               np.float32),
           "flows": (4.0 * rng.standard_normal((B, f, H, W, 2))).astype(
               np.float32),
           "valids": valids()}
    if kind == "streamflow":
        out["flows_bw"] = (4.0 * rng.standard_normal((B, f, H, W, 2))
                           ).astype(np.float32)
        out["valids_bw"] = valids()
    return out


def port_config(kind, fields):
    from streamflow_tpu_torch.config import RAFTConfig, StreamFlowConfig

    if kind == "raft":
        return RAFTConfig(iters=ITERS, mixed_precision=False, **fields)
    return StreamFlowConfig(T=T, iters=ITERS, mixed_precision=False,
                            remat=True, **fields)


def make_state(name, out):
    """A TrainState of case ``name`` holding the parent's variables."""
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax
    from streamflow_tpu_torch.training.checkpoint import load_params_npz
    from streamflow_tpu_torch.training.state import TrainState

    kind, fields, _ = CASES[name]
    model = create_model(kind, cfg=port_config(kind, fields), device="cpu",
                         train=True)
    load_jax(model, load_params_npz(os.path.join(out, f"{name}.npz")))
    return TrainState.create(model, lr=LR, num_steps=100)


def make_step(name):
    from streamflow_tpu_torch.training.step import (make_train_step,
                                                    make_train_step_2f)

    kind, _, bidir = CASES[name]
    if kind == "raft":
        return make_train_step_2f(GAMMA[kind], ITERS)
    return make_train_step(GAMMA[kind], ITERS, bidirectional=bidir)


def tensors(batch):
    import torch

    return {k: torch.from_numpy(v) for k, v in batch.items()}


def snapshot(state):
    return {k: v.detach().clone() for k, v in
            state.model.state_dict().items()}


def steps(rank, world, out):
    import torch

    from streamflow_tpu_torch import parallel
    from streamflow_tpu_torch.training.loss import masked_means

    for name, (kind, _, _) in CASES.items():
        state = make_state(name, out)
        parallel.replicate(state.model)
        step = make_step(name)
        batch = tensors(parallel.shard_batch(global_batch(kind), rank,
                                             world))
        rec = {}
        if name == "canonical":
            # this rank's own masked sums with the pre-step weights (no
            # BatchNorm state to move)
            with torch.no_grad():
                _, local = step.loss_fn(state.model, batch, sums=True)
            rec["local_epe"] = [float(x) for x in local["epe"]]
            rec["local_mean_epe"] = float(masked_means(local)["epe"])
        sharded = parallel.shard_train_step(step)
        for i in (1, 2):
            m = sharded(state, batch)
            rec[f"m{i}"] = {k: float(v) for k, v in m.items()}
            rec[f"sd{i}"] = snapshot(state)
        rec["opt"] = state.optimizer.state_dict()
        torch.save(rec, os.path.join(out, f"{name}_{rank}.pt"))

    solos = [torch.distributed.new_group([r]) for r in range(world)]
    name = ("canonical", "basic")[rank % 2]
    kind = CASES[name][0]
    batch = tensors(parallel.shard_batch(global_batch(kind), rank, world))
    plain, grouped = make_state(name, out), make_state(name, out)
    plain_step = make_step(name)
    grouped_step = parallel.shard_train_step(plain_step, solos[rank])
    same = {}
    for i in (1, 2):
        mp = plain_step(plain, batch)
        mg = grouped_step(grouped, batch)
        same[f"metrics{i}"] = sorted(mp) == sorted(mg) and all(
            torch.equal(mp[k], mg[k]) for k in mp)
    same["state"] = all(torch.equal(v, grouped.model.state_dict()[k])
                        for k, v in plain.model.state_dict().items())
    op, og = plain.optimizer.state_dict(), grouped.optimizer.state_dict()
    same["optimizer"] = all(
        torch.equal(torch.as_tensor(v), torch.as_tensor(og["state"][i][k]))
        for i, s in op["state"].items() for k, v in s.items())
    same["synced"] = all(getattr(m, "group", None) is solos[rank]
                         for m in grouped.model.modules()
                         if hasattr(m, "running_mean"))
    with open(os.path.join(out, f"solo_{rank}.json"), "w") as fh:
        json.dump({"case": name, **same}, fh)


class Clips:
    """In-memory clips with the loader's interface (``len``, ``load(index,
    rng)``)."""

    def __len__(self):
        return 8

    def load(self, index, rng):
        import numpy as np

        f = T - 1
        return {"images": rng.integers(0, 256, (T, H, W, 3)).astype(
                    np.float32),
                "flows": (4.0 * rng.standard_normal((f, H, W, 2))).astype(
                    np.float32),
                "valids": (rng.random((f, H, W)) < 0.9).astype(np.float32)}


def trainer(rank, world, out):
    import numpy as np
    import torch

    from streamflow_tpu_torch.tools import train as cli
    from streamflow_tpu_torch.training import checkpoint
    from streamflow_tpu_torch.training.state import TrainState

    writes, validations = [], []
    write = checkpoint.CheckpointManager._write

    def counted(self, step, snapshot):
        writes.append(step)
        return write(self, step, snapshot)

    checkpoint.CheckpointManager._write = counted
    clip = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (1, T, H, W, 3)).astype(np.float32))

    def validate(fwd):
        validations.append(rank)
        return {"clean_epe": float(fwd(clip).abs().mean())}

    args = cli.parse_args([
        "--output", os.path.join(out, "run"), "--num_steps", "4",
        "--batch_size", str(B), "--image_size", str(H), str(W),
        "--T", str(T), "--iters", str(ITERS), "--val_iters", str(ITERS),
        "--val_freq", "2", "--print_freq", "1", "--validation", "sintel",
        "--num_workers", "1", "--no_mixed_precision", "--device", "cpu",
        "--lr", str(LR)])
    run = cli.train(args, Clips(), validate)
    fresh = TrainState.create(_trainer_model(args), args.lr, args.num_steps,
                              args.wdecay, args.epsilon, args.clip)
    ckpts = checkpoint.CheckpointManager(
        os.path.join(out, "run", args.name, "ckpts"))
    ckpts.restore(fresh)
    live, back = run.state.state_dict(), fresh.state_dict()
    same = back["step"] == live["step"] and all(
        torch.equal(v, back["model"][k]) for k, v in live["model"].items())
    same = same and all(
        torch.equal(torch.as_tensor(v),
                    torch.as_tensor(back["optimizer"]["state"][i][k]))
        for i, s in live["optimizer"]["state"].items()
        for k, v in s.items())
    torch.save(snapshot(run.state), os.path.join(out, f"trainer_{rank}.pt"))
    with open(os.path.join(out, f"trainer_{rank}.json"), "w") as fh:
        json.dump({"writes": writes, "validations": len(validations),
                   "fwd": run.fwd is not None, "step": run.state.step,
                   "resume_exact": bool(same),
                   "steps": sorted(ckpts.all_steps())}, fh)


def _trainer_model(args):
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model

    return create_model("streamflow", cfg=StreamFlowConfig(
        T=args.T, iters=args.iters, mixed_precision=args.mixed_precision,
        remat=True), device="cpu", train=True)


def main():
    mode, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(2)
    from streamflow_tpu_torch.parallel import initialize

    assert initialize(f"file://{store}", world, rank,
                      device="cpu") == (rank, world)
    {"steps": steps, "trainer": trainer}[mode](rank, world, out)
    from streamflow_tpu_torch.parallel.multihost import shutdown

    shutdown()


if __name__ == "__main__":
    main()
