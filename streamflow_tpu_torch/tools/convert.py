"""Convert a PyTorch reference checkpoint (.pth) to flax variables (.npz),
the port's twin of tools/convert.py:

  python -m streamflow_tpu_torch.tools.convert \
      --pth streamflow-sintel.pth --out params.npz
  python -m streamflow_tpu_torch.tools.convert --pth raft-things.pth \
      --model raft --out raft.npz

Accepts the reference's checkpoint format (torch.save dict, optional
'model' key, DataParallel 'module.' prefixes; reference
train_mf.py:207-212, demo.py:388). The output is the npz JAX's CLI
writes: a flat npz of the flax variables ('params/...' and, for the
BatchNorm CNN baselines, 'batch_stats/...'), which both packages load
(``--ckpt`` of every tool; ``params.load_jax`` after
``training.checkpoint.load_variables_npz``).
"""

from __future__ import annotations

import argparse


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pth", required=True, help="torch checkpoint file")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--model", default="streamflow",
                   choices=["streamflow", "raft", "gma", "sk"],
                   help="target model family (selects the mapping table)")
    p.add_argument("--k_conv", type=int, nargs="+", default=[1, 15])
    p.add_argument("--pc_updater_conv", type=int, nargs="+", default=[1, 7])
    p.add_argument("--lenient", action="store_true",
                   help="skip missing source keys instead of failing")
    args = p.parse_args(argv)

    from streamflow_tpu_torch.convert import (convert_raft_checkpoint,
                                              convert_streamflow_checkpoint,
                                              load_torch_checkpoint)
    from streamflow_tpu_torch.training.checkpoint import save_params_npz

    sd = load_torch_checkpoint(args.pth)
    if args.model == "streamflow":
        variables = convert_streamflow_checkpoint(
            sd, k_conv=tuple(args.k_conv),
            pc_updater_conv=tuple(args.pc_updater_conv),
            strict=not args.lenient)
    else:
        variables = convert_raft_checkpoint(
            sd, update_block=args.model, strict=not args.lenient)

    save_params_npz(args.out, variables)
    n = sum(1 for _ in _leaves(variables))
    print(f"wrote {args.out}: {n} arrays "
          f"({', '.join(sorted(variables.keys()))})")
    return variables


if __name__ == "__main__":
    main()
