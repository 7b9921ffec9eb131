"""Input-pipeline throughput (port of tools/bench_input.py): builds a
synthetic Sintel-style tree (png frames and .flo flows), then measures the
port's ``DataLoader`` batches/s over ``SintelMultiframe`` at the stage-2
config (432x960 crops, T=4, bs 8, full augmentation) for several worker
counts. Compare the batches/s with the train step's steps/s: can the host
pipeline feed the step?

  python -m streamflow_tpu_torch.tools.bench_input [--bs 8] [--T 4]
      [--crop 432 960] [--size 436 1024] [--nscenes 4] [--frames 12]
      [--nbatches 12] [--workers 4 8 16] [--root DIR]

PIL writes and reads the png frames (the .flo flows go through the native
runtime); without PIL the tool raises, naming it. The tree goes into a
temporary directory under ``--root`` (default: the system's), removed at
the end. Prints one line per worker count and a JSON line with
``input_batches_per_sec`` by worker count, as JAX's does. The host alone
runs it: no device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np


def build_tree(root: Path, nscenes: int, frames: int, h: int, w: int):
    """JAX's tree (tools/bench_input.py:25-44): per scene, clean and final
    png frames of seeded uint8 noise and N(0, 8^2) px .flo flows."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("bench_input writes and reads its png frames "
                           "with PIL, which is not installed") from e

    from streamflow_tpu_torch.data import frame_utils

    rng = np.random.default_rng(0)
    for s in range(nscenes):
        for ds in ["clean", "final"]:
            d = root / "training" / ds / f"scene_{s}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(frames):
                Image.fromarray(
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                ).save(d / f"frame_{i + 1:04d}.png")
        fd = root / "training" / "flow" / f"scene_{s}"
        fd.mkdir(parents=True, exist_ok=True)
        for i in range(frames - 1):
            frame_utils.write_flo(
                fd / f"frame_{i + 1:04d}.flo",
                (8 * rng.standard_normal((h, w, 2))).astype(np.float32))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--T", type=int, default=4)
    p.add_argument("--crop", type=int, nargs=2, default=[432, 960])
    p.add_argument("--size", type=int, nargs=2, default=[436, 1024],
                   help="source image size")
    p.add_argument("--nscenes", type=int, default=4)
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--nbatches", type=int, default=12)
    p.add_argument("--workers", type=int, nargs="+", default=[4, 8, 16])
    p.add_argument("--root", default=None,
                   help="where the temporary tree goes")
    args = p.parse_args(argv)

    from streamflow_tpu_torch.data.loader import DataLoader
    from streamflow_tpu_torch.data.mf_datasets import SintelMultiframe

    tmp = Path(tempfile.mkdtemp(prefix="sf_input_bench_", dir=args.root))
    try:
        h, w = args.size
        build_tree(tmp, args.nscenes, args.frames, h, w)
        aug = {"crop_size": tuple(args.crop), "min_scale": -0.2,
               "max_scale": 0.6, "do_flip": True}
        ds = SintelMultiframe(aug, root=str(tmp), dstype="clean",
                              nframes=args.T)
        print(f"{len(ds)} clips; batch {args.bs} at {args.crop}")
        results = {}
        for nw in args.workers:
            dl = DataLoader(ds, args.bs, num_workers=nw, seed=0)
            if len(dl) < 2:
                raise ValueError(f"{len(ds)} clips make {len(dl)} batch(es) "
                                 f"of {args.bs}; the tool needs a warm-up "
                                 f"batch and a timed one: give more "
                                 f"--nscenes or --frames")
            it = dl.epoch(0)
            next(it)  # warm the pool / page cache
            t0 = time.perf_counter()
            n = 0
            for _ in it:
                n += 1
                if n >= args.nbatches:
                    break
            it.close()
            dt = (time.perf_counter() - t0) / n
            results[nw] = round(1.0 / dt, 3)
            print(f"workers={nw:3d}: {1.0 / dt:7.3f} batches/s "
                  f"({args.bs / dt:6.1f} clips/s)")
        record = {"metric": "input_batches_per_sec", "batch": args.bs,
                  "crop": args.crop, "by_workers": results}
        print(json.dumps(record))
        return record
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
