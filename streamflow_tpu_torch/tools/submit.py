"""Leaderboard submission harness of the port (twin of tools/submit.py;
reference submit_mf.py, scripts/submit.sh), on the card unless ``--device
cpu``:

  python -m streamflow_tpu_torch.tools.submit --dataset sintel \
      --ckpt params.npz --iters 20

Writes the JAX package's files (Sintel .flo, KITTI 16-bit png, Spring
.flo5) under ``--output``. Reading the datasets needs PIL (cv2 for KITTI,
h5py for Spring).
"""

from __future__ import annotations

import argparse

from streamflow_tpu_torch.tools.common import add_model_args, build_model


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True,
                   choices=["sintel", "sintel_warm", "kitti", "spring"])
    add_model_args(p, iters=20)
    p.add_argument("--output", default="submission")
    p.add_argument("--vis", action="store_true")
    p.add_argument("--sintel_root", default="datasets/sintel")
    p.add_argument("--multi_root", default="datasets/multi-kitti")
    p.add_argument("--spring_root", default="datasets/spring")
    args = p.parse_args(argv)

    from streamflow_tpu_torch import submission

    model = build_model(args)
    if args.dataset == "sintel":
        submission.create_sintel_submission(
            model, args.sintel_root, args.output, args.iters, args.T,
            save_vis_flow=args.vis)
    elif args.dataset == "sintel_warm":
        submission.create_sintel_submission_warm(
            model, args.sintel_root, args.output, args.iters, args.T)
    elif args.dataset == "kitti":
        submission.create_kitti_submission(
            model, args.multi_root, args.output, args.iters, args.T)
    elif args.dataset == "spring":
        submission.create_spring_submission(
            model, args.spring_root, args.output, args.iters, args.T)
    print(f"submission ({args.dataset}) written to {args.output}")


if __name__ == "__main__":
    main()
