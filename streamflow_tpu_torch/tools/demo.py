"""Video inference demo of the port (twin of tools/demo.py; reference
demo.py): read a video, run sliding T-frame windows with 1-frame overlap
(tail window deduped), render flow with the Middlebury wheel, write an
mp4. On the card unless ``--device cpu``; video I/O needs cv2.

  python -m streamflow_tpu_torch.tools.demo --video input.mp4 \
      --ckpt params.npz --output flow.mp4
"""

from __future__ import annotations

import argparse

import numpy as np

from streamflow_tpu_torch.tools.common import add_model_args, build_model


def read_video(path, max_frames=None):
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1].copy())  # BGR -> RGB
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    return frames, fps


def write_video(path, frames, fps):
    import cv2

    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                          (w, h))
    for f in frames:
        out.write(f[:, :, ::-1])  # RGB -> BGR
    out.release()


def sliding_windows(n: int, t: int):
    """Start indices + per-pair keep flags (reference demo.py:514-532):
    step T-1 with the tail window re-anchored to the end, overlapping pairs
    flagged out."""
    wins = []
    i = 0
    while True:
        if i + t <= n:
            wins.append((i, [True] * (t - 1)))
        else:
            start = n - t
            keep = [start + j >= i for j in range(t - 1)]
            wins.append((start, keep))
        if i + t >= n:
            break
        i += t - 1
    return wins


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--output", default="flow_vis.mp4")
    add_model_args(p, iters=12)
    p.add_argument("--max_frames", type=int, default=None)
    args = p.parse_args(argv)

    from streamflow_tpu_torch.data.flow_viz import flow_to_image
    from streamflow_tpu_torch.evaluation import GraphedForward, window_flows

    frames, fps = read_video(args.video, args.max_frames)
    assert len(frames) >= args.T, f"need >= {args.T} frames"
    print(f"{len(frames)} frames @ {fps:.1f}fps, {frames[0].shape}")

    model = build_model(args)
    fwd = GraphedForward(model, args.iters)
    flows_out = []
    for start, keep in sliding_windows(len(frames), args.T):
        clip = np.stack(frames[start:start + args.T]).astype(np.float32)
        flows = window_flows(fwd, clip, args.device)
        flows_out += [flows[j] for j, k in enumerate(keep) if k]
        print(f"window @{start}: kept {sum(keep)} flows", flush=True)

    vis = [flow_to_image(f) for f in flows_out]
    write_video(args.output, vis, fps)
    print(f"wrote {len(vis)} flow frames -> {args.output}")


if __name__ == "__main__":
    main()
