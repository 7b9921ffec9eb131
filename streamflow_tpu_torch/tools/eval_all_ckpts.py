"""Evaluate every checkpoint of a training run and report the best (twin of
tools/eval_all_ckpts.py; the reference's model selection,
scripts/infer_all_ckpts.sh + SURVEY §5.4), on the card unless
``--device cpu``:

  python -m streamflow_tpu_torch.tools.eval_all_ckpts \\
      --ckpt_dir output/streamflow/ckpts --dataset sintel \\
      --sintel_root datasets/sintel

``--ckpt_dir`` is a CheckpointManager directory of the port's trainer
(``step_<n>.pt`` files). Each step's weights go into one inference model
(in place), served by one GraphedForward for all of them. The best step
is the one with the lowest ``--metric``, by default the first ``*_epe``
the validator reports. Prints one JSON object last.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_dir", required=True,
                   help="the port's CheckpointManager directory")
    p.add_argument("--dataset", default="sintel",
                   choices=["sintel", "kitti", "spring"])
    p.add_argument("--metric", default=None,
                   help="selection metric (default: first *_epe)")
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--T", type=int, default=4)
    p.add_argument("--sintel_root", default="datasets/sintel")
    p.add_argument("--multi_root", default="datasets/multi-kitti")
    p.add_argument("--spring_root", default="datasets/spring")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    import torch

    from streamflow_tpu_torch import evaluation
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.training.checkpoint import CheckpointManager

    mgr = CheckpointManager(args.ckpt_dir)
    steps = mgr.all_steps()
    if not steps:
        raise SystemExit(f"no checkpoints in {args.ckpt_dir}")
    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=args.T, iters=args.iters), device=args.device)
    fwd = evaluation.GraphedForward(model, args.iters)

    results = {}
    for step in steps:
        sd = torch.load(mgr.path(step), map_location="cpu",
                        weights_only=True)["model"]
        model.load_state_dict(sd)   # in place: the graphs read by address
        if args.dataset == "sintel":
            r = evaluation.validate_sintel(fwd, args.sintel_root, args.iters,
                                           args.T, progress=False)
        elif args.dataset == "kitti":
            r = evaluation.validate_kitti(fwd, args.multi_root, args.iters,
                                          args.T)
        else:
            r = evaluation.validate_spring(fwd, args.spring_root, args.iters,
                                           args.T, progress=False)
        results[step] = r
        print(f"step {step}: {r}")

    key = args.metric or next(k for k in next(iter(results.values()))
                              if k.endswith("_epe"))
    best = min(results, key=lambda s: results[s][key])
    summary = {"best_step": best, "metric": key, "value": results[best][key],
               "all": {str(s): results[s] for s in results}}
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
