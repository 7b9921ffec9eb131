"""High-resolution memory stress of the port (twin of tools/test_memory.py;
reference test_memory.py): one T-frame clip at 1440x2560 by default, run
``--loops`` times through the graphed forward, on the card unless
``--device cpu``. K1 never stores the correlation volume and K3 streams
its keys, so memory grows with the pixels, not with their square.

  python -m streamflow_tpu_torch.tools.test_memory --height 1440 \
      --width 2560 --iters 15 --loops 3

Prints each loop's time (the first includes the warm-up and the capture),
the steady time per clip and the peak ``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from streamflow_tpu_torch.tools.common import add_model_args, build_model


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=1440)
    p.add_argument("--width", type=int, default=2560)
    p.add_argument("--loops", type=int, default=3)
    add_model_args(p, iters=15)
    args = p.parse_args(argv)

    from streamflow_tpu_torch.evaluation import GraphedForward
    from streamflow_tpu_torch.ops.padding import InputPadder

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    model = build_model(args)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(
        0, 255, (1, args.T, args.height, args.width, 3)).astype(np.float32))
    padder = InputPadder(imgs.shape[-3:])
    imgs = padder.pad(imgs).to(dev)
    print(f"input {tuple(imgs.shape)} on {dev}, iters {args.iters}",
          flush=True)

    fwd = GraphedForward(model, args.iters)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t_loop = []
    t0 = time.perf_counter()
    for i in range(args.loops):
        t1 = time.perf_counter()
        flows = fwd(imgs)
        if cuda:
            torch.cuda.synchronize(dev)
        t_loop.append(time.perf_counter() - t1)
        assert bool(torch.isfinite(flows).all()), "non-finite flows"
        print(f"loop {i}: {t_loop[-1]:.3f}s (|flow| mean "
              f"{float(flows.norm(dim=-1).mean()):.4g})", flush=True)
    warm = min(t_loop[1:] or t_loop)
    print(f"OK: {args.loops} loops at {imgs.shape[2]}x{imgs.shape[3]} in "
          f"{time.perf_counter() - t0:.1f}s (incl. capture); warm "
          f"{warm:.3f}s/clip")
    peak = None
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
        print(f"device memory: peak {peak:.3f} GiB allocated, card "
              f"{total:.2f} GiB ({torch.cuda.get_device_name(dev)})")
    return {"loop_s": t_loop, "warm_s": warm, "peak_gib": peak}


if __name__ == "__main__":
    main()
