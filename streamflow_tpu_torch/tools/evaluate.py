"""Evaluation harness of the port (twin of tools/evaluate.py; reference
evaluate_mf.py __main__, scripts/infer.sh), on the card unless
``--device cpu``:

  python -m streamflow_tpu_torch.tools.evaluate --dataset sintel \
      --iters 15 --ckpt output/streamflow/params.npz \
      --sintel_root datasets/sintel
  python -m streamflow_tpu_torch.tools.evaluate --model raft \
      --dataset chairs --iters 24 --ckpt raft.npz \
      --chairs_root datasets/FlyingChairs_release/data

``--ckpt`` is an npz in the JAX package's flax layout (what tools/train.py,
tools/train_2f.py and tools/convert.py write); without it the weights are
random from a seed. The two-frame baselines (``--model raft|gma|sk``) run
the two-frame validators, as JAX's CLI: ``chairs``, ``things_2f`` and
``things`` (``validate_things``). JAX's CLI sends a two-frame model with
``--dataset sintel|kitti|spring|sintel_occ|all`` to the multi-frame
validators, which cannot run it; the port raises a ValueError there that
names ``evaluation.validate_sintel_2f``. Reading the datasets needs PIL
(and cv2 for KITTI, h5py for Spring).
"""

from __future__ import annotations

import argparse

from streamflow_tpu_torch.tools.common import (TWO_FRAME, add_model_args,
                                               build_model)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True,
                   choices=["sintel", "kitti", "spring", "sintel_occ",
                            "things", "chairs", "things_2f", "all"])
    p.add_argument("--model", default="streamflow",
                   choices=["streamflow", *TWO_FRAME],
                   help="two-frame baselines evaluate chairs, things_2f "
                        "and things (reference validate_chairs/things are "
                        "two-frame, evaluate_mf.py:375-429)")
    add_model_args(p, iters=15)
    p.add_argument("--sintel_root", default="datasets/sintel")
    p.add_argument("--multi_root", default="datasets/multi-kitti")
    p.add_argument("--spring_root", default="datasets/spring")
    p.add_argument("--things_root", default="datasets/flyingthings3d")
    p.add_argument("--chairs_root",
                   default="datasets/FlyingChairs_release/data")
    args = p.parse_args(argv)
    two_frame = args.model != "streamflow"
    if two_frame and args.dataset not in ("chairs", "things_2f", "things"):
        raise ValueError(
            f"--model {args.model} --dataset {args.dataset}: the multi-frame "
            f"validators take a (B, T, H, W, 3) clip, not a two-frame "
            f"model; its Sintel validator is "
            f"evaluation.validate_sintel_2f")
    if not two_frame and args.dataset in ("chairs", "things_2f"):
        raise ValueError(f"--dataset {args.dataset} needs a two-frame "
                         f"--model")

    from streamflow_tpu_torch import evaluation

    model = build_model(args, name=args.model)
    results = {}
    if two_frame:
        if args.dataset == "chairs":
            results.update(evaluation.validate_chairs(
                model, args.chairs_root, args.iters))
        else:
            results.update(evaluation.validate_things(
                model, args.things_root, args.iters))
        print(results)
        return results
    if args.dataset == "things":
        results.update(evaluation.validate_things_mf(
            model, args.things_root, args.iters, args.T))
    if args.dataset in ("sintel", "all"):
        results.update(evaluation.validate_sintel(
            model, args.sintel_root, args.iters, args.T))
    if args.dataset in ("kitti", "all"):
        results.update(evaluation.validate_kitti(
            model, args.multi_root, args.iters, args.T))
    if args.dataset in ("spring", "all"):
        results.update(evaluation.validate_spring(
            model, args.spring_root, args.iters, args.T))
    if args.dataset == "sintel_occ":
        results.update(evaluation.validate_sintel_occlusion(
            model, args.sintel_root, args.iters, args.T))
    print(results)
    return results


if __name__ == "__main__":
    main()
