"""Two-frame training harness of the port for the RAFT / RAFT-GMA / SKFlow
baselines over the C+T+K+S+H stages (twin of tools/train_2f.py), on the
card unless ``--device cpu``:

  python -m streamflow_tpu_torch.tools.train_2f --stage chairs \\
      --model raft --num_steps 100000 --batch_size 8 --lr 4e-4 \\
      --image_size 368 496

The flags are the JAX CLI's (tools/train_2f.py:21-50), with ``--device``
added. On N GPUs it runs under torchrun, one process per GPU, with
``--batch_size`` the global batch, as JAX's shards its step over every
device (:93-120); see tools/train.py's ``run_loop``:

  torchrun --nproc_per_node=N -m streamflow_tpu_torch.tools.train_2f \\
      --stage chairs --model raft --batch_size 8

What the loop does as the JAX CLI's (:107-142): the two-frame dataset
of the stage (``data/datasets.py::fetch_dataset_2f``) -> ``DataLoader``
-> ``prefetch_to_device`` -> ``make_train_step_2f`` (AdamW + OneCycle +
clip); metrics stay on the device and are read every
``--print_freq`` steps; a checkpoint every ``--val_freq`` steps and at
the end, keep 5, in ``<output>/<name>/ckpts``; resume from the latest one
(the loader starts again at epoch 0, as JAX's). ``--restore_ckpt`` (an
npz in the flax layout) restores the parameters only, as JAX's (:101-102);
the BatchNorm running statistics keep their start. Weights start random
from ``--seed`` (``tools/common.py::init_weights``); JAX's start from
flax's initialisers.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--name", default="raft")
    p.add_argument("--model", default="raft", choices=["raft", "gma", "sk"])
    p.add_argument("--stage", default="chairs",
                   choices=["chairs", "things", "sintel", "kitti"])
    p.add_argument("--output", default="output")
    p.add_argument("--restore_ckpt", default=None)
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--wdecay", type=float, default=1e-4)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=0.8)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--image_size", type=int, nargs=2, default=[368, 496])
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--val_freq", type=int, default=5000)
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--mixed_precision", action="store_true", default=True)
    p.add_argument("--no_mixed_precision", dest="mixed_precision",
                   action="store_false")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--chairs_root",
                   default="datasets/FlyingChairs_release/data")
    p.add_argument("--things_root", default="datasets/flyingthings3d")
    p.add_argument("--sintel_root", default="datasets/sintel")
    p.add_argument("--kitti_root", default="datasets/KITTI")
    p.add_argument("--hd1k_root", default="datasets/HD1k")
    return p


def train(args, dataset):
    """The training loop of ``main`` (tools/train.py::run_loop) on
    ``dataset`` (``__len__`` and ``load(index, rng)`` giving two-frame
    samples, as data/datasets.py) with ``make_train_step_2f``. Returns
    tools/train.py's ``Run`` (no validation: ``fwd`` None)."""
    import math

    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax
    from streamflow_tpu_torch.tools.common import TWO_FRAME, init_weights
    from streamflow_tpu_torch.tools.train import Run, run_loop, session
    from streamflow_tpu_torch.training.checkpoint import load_variables_npz
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step_2f

    with session(args) as (out, device):
        model = create_model(TWO_FRAME[args.model], device=device,
                             train=True, iters=args.iters,
                             mixed_precision=args.mixed_precision)
        init_weights(model, args.seed)
        if args.restore_ckpt:
            load_jax(model, load_variables_npz(args.restore_ckpt),
                     params_only=True)
            print(f"restored params from {args.restore_ckpt}")
        n_params = sum(p.numel() for p in model.parameters())
        print(f"parameter count: {n_params / 1e6:.2f}M")

        state = TrainState.create(model, args.lr, args.num_steps,
                                  args.wdecay, clip=args.clip)
        step_t, save_s = run_loop(args, out, device, state,
                                  make_train_step_2f(args.gamma, args.iters),
                                  dataset, "pairs")
        return Run(state, None, {}, math.inf, step_t, save_s, [])


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from streamflow_tpu_torch.data.datasets import fetch_dataset_2f

    np.random.seed(args.seed)
    dataset = fetch_dataset_2f(
        args.stage, image_size=tuple(args.image_size),
        chairs_root=args.chairs_root, things_root=args.things_root,
        sintel_root=args.sintel_root, kitti_root=args.kitti_root,
        hd1k_root=args.hd1k_root)
    return train(args, dataset)


if __name__ == "__main__":
    main()
