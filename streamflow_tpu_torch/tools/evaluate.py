"""Evaluation harness of the port (twin of tools/evaluate.py; reference
evaluate_mf.py __main__, scripts/infer.sh), on the card unless
``--device cpu``:

  python -m streamflow_tpu_torch.tools.evaluate --dataset sintel \
      --iters 15 --ckpt output/streamflow/params.npz \
      --sintel_root datasets/sintel

``--ckpt`` is an npz in the JAX package's flax layout (what tools/train.py
and tools/convert.py write); without it the weights are random from a seed.
The multi-frame datasets only: ``--model`` other than ``streamflow`` and the
two-frame datasets (``chairs``, ``things_2f``) raise until the two-frame
models are ported. Reading the datasets needs PIL (and cv2 for KITTI,
h5py for Spring).
"""

from __future__ import annotations

import argparse

from streamflow_tpu_torch.tools.common import add_model_args, build_model


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True,
                   choices=["sintel", "kitti", "spring", "sintel_occ",
                            "things", "chairs", "things_2f", "all"])
    p.add_argument("--model", default="streamflow",
                   choices=["streamflow", "raft", "gma", "sk"])
    add_model_args(p, iters=15)
    p.add_argument("--sintel_root", default="datasets/sintel")
    p.add_argument("--multi_root", default="datasets/multi-kitti")
    p.add_argument("--spring_root", default="datasets/spring")
    p.add_argument("--things_root", default="datasets/flyingthings3d")
    args = p.parse_args(argv)
    if args.model != "streamflow" or args.dataset in ("chairs", "things_2f"):
        raise NotImplementedError(
            f"--model {args.model} --dataset {args.dataset}: the two-frame "
            f"models and validators are not ported yet")

    from streamflow_tpu_torch import evaluation

    model = build_model(args)
    results = {}
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
