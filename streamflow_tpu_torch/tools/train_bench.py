"""Training-step benchmark of the port on one GPU: short synthetic-data runs
of the canonical StreamFlow at the sintel_kitti stage shape (432x960, T=4,
B=1, 12 iterations; tools/train.py's preset), bf16 compute with f32
parameters and remat, gamma 0.85, lr 1.75e-4, AdamW (weight decay 1e-5,
eps 1e-8) under the linear OneCycle schedule over the preset's 180000 +
100 steps, clip 1.0. Counterpart of tools/train_bench.py.

    python -m streamflow_tpu_torch.tools.train_bench [--steps N]
        [--height H] [--width W] [--batch B] [--iters N] [--T T]
        [--bidir] [--dw-impl LAYOUT] [--seed S]

``--dw-impl`` picks the SK blocks' layout (config.py), as the JAX tool's
``dw=`` spec: ``auto`` (the edge-fused default), ``pallas`` (K5
``dw_chain``), ``banded_mxu`` (K6), ``banded_mxu_t`` (K7),
``banded_chain`` (K8) or ``banded`` (the XLA banded composite).

Clips are synthetic, made from the seed: uint8-range images and N(0, 4^2)
px flows, all pixels valid. Weights are random (the model's own init from
the seed). Prints one line per step and a JSON summary: ms/step
(host clock around steps that end in a synchronize, after one warm-up
step), steps/s, clips/s, peak device memory, loss and grad_norm. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def synthetic_batch(b: int, t: int, h: int, w: int, seed: int, device,
                    bidir: bool = False):
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    batch = {"images": arr(rng.integers(0, 255, (b, t, h, w, 3))),
             "flows": arr(4.0 * rng.standard_normal((b, t - 1, h, w, 2))),
             "valids": arr(np.ones((b, t - 1, h, w)))}
    if bidir:
        batch["flows_bw"] = arr(4.0 * rng.standard_normal((b, t - 1, h, w,
                                                           2)))
        batch["valids_bw"] = arr(np.ones((b, t - 1, h, w)))
    return batch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--height", type=int, default=432)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--T", type=int, default=4)
    p.add_argument("--bidir", action="store_true")
    p.add_argument("--dw-impl", default="auto",
                   choices=("auto", "pallas", "banded_mxu", "banded_mxu_t",
                            "banded_chain", "banded"),
                   help="SK block layout: 'auto' (edge-fused default), "
                        "'pallas' (K5 dw chain), 'banded_mxu' (K6), "
                        "'banded_mxu_t' (K7), 'banded_chain' (K8), "
                        "'banded' (XLA banded composite)")
    p.add_argument("--seed", type=int, default=3407)
    args = p.parse_args(argv)

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("train_bench: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(args.seed)
    cfg = StreamFlowConfig(T=args.T, iters=args.iters, mixed_precision=True,
                           remat=True, dw_impl=args.dw_impl)
    model = create_model("streamflow", cfg=cfg, train=True)
    state = TrainState.create(model, lr=1.75e-4, num_steps=180_000)
    step = make_train_step(gamma=0.85, iters=args.iters,
                           bidirectional=args.bidir)
    batch = synthetic_batch(args.batch, args.T, args.height, args.width,
                            args.seed, "cuda", args.bidir)

    m = step(state, batch)            # warm-up (kernel build, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        print(f"step {i}: {1e3 * times[-1]:.3f} ms loss "
              f"{float(m['loss']):.6g} grad_norm {float(m['grad_norm']):.6g}",
              flush=True)
    ms = 1e3 * sum(times) / len(times)
    out = {"device": torch.cuda.get_device_name(0),
           "shape": [args.batch, args.T, args.height, args.width],
           "iters": args.iters, "dw_impl": args.dw_impl,
           "bidirectional": args.bidir, "ms_per_step": ms,
           "steps_per_s": 1e3 / ms, "clips_per_s": args.batch * 1e3 / ms,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    assert np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"]), out
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
