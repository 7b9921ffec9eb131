"""Shared helpers of the serving slice's parity tests
(tests/test_torch_serving_*.py): synthetic dataset trees written with
seeded numpy in the layouts the datasets read (the layouts of
tests/test_evaluation_e2e.py and tests/test_datasets.py), and the model
pair both packages run."""

from __future__ import annotations

import contextlib
import functools

import numpy as np

H, W, T, ITERS = 64, 96, 4, 2
# the flow head's output layer is scaled down (as chip_smoke.py does) so
# that random-weight flows stay at a few px, where the 1/3/5 px and F1
# thresholds of the validators see both sides of them
FLOW_HEAD_SCALE = 2e-3


def _png(path, rng, h=H, w=W):
    from PIL import Image

    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        path)


def _flow(rng, h=H, w=W, scale=2.0):
    return (scale * rng.standard_normal((h, w, 2))).astype(np.float32)


def sintel_tree(root, seed=0):
    """training: alley_1 (7 frames), ambush_2 (5 frames), clean and final,
    .flo GT and occlusion pngs; test: temple_1 (5 frames)."""
    from streamflow_tpu_torch.data import frame_utils
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, scenes in (("training", (("alley_1", 7), ("ambush_2", 5))),
                          ("test", (("temple_1", 5),))):
        for scene, n in scenes:
            for ds in ("clean", "final"):
                d = root / split / ds / scene
                d.mkdir(parents=True, exist_ok=True)
                for i in range(n):
                    _png(d / f"frame_{i + 1:04d}.png", rng)
            if split != "training":
                continue
            fd = root / split / "flow" / scene
            od = root / split / "occlusions" / scene
            fd.mkdir(parents=True, exist_ok=True)
            od.mkdir(parents=True, exist_ok=True)
            for i in range(n - 1):
                frame_utils.write_flo(fd / f"frame_{i + 1:04d}.flo",
                                      _flow(rng))
                occ = (rng.random((H, W)) < 0.3).astype(np.uint8) * 255
                Image.fromarray(occ).save(od / f"frame_{i + 1:04d}.png")
    return str(root)


def kitti_tree(root, seed=1, nseq=3):
    """multi-kitti: training (frames 8-12, 16-bit png GT of frame 10) and
    testing (frames 8-12), ``nseq`` sequences each."""
    from streamflow_tpu_torch.data import frame_utils

    rng = np.random.default_rng(seed)
    for split in ("training", "testing"):
        img_d = root / split / "image_2"
        img_d.mkdir(parents=True)
        if split == "training":
            flow_d = root / split / "flow_occ"
            flow_d.mkdir(parents=True)
        for seq in range(nseq):
            for i in range(8, 13):
                _png(img_d / f"{seq:06d}_{i:02d}.png", rng)
            if split == "training":
                frame_utils.write_flow_kitti(flow_d / f"{seq:06d}_10.png",
                                             _flow(rng, scale=3.0))
    return str(root)


def spring_tree(root, seed=3):
    """Spring: train/0041 (the val scene, 4 frames, both cams, FW + BW .flo5
    GT at 2x resolution with the top half NaN, speeds up to ~100 px),
    test/0001 (6 frames) and test/0002 (4 frames), both cams."""
    from streamflow_tpu_torch.data import frame_utils

    rng = np.random.default_rng(seed)
    for cam in ("left", "right"):
        d = root / "train" / "0041" / f"frame_{cam}"
        d.mkdir(parents=True)
        for i in range(1, 5):
            _png(d / f"frame_{cam}_{i:04d}.png", rng)
        for tag, idxs in (("FW", (1, 2, 3)), ("BW", (4, 3, 2))):
            fd = root / "train" / "0041" / f"flow_{tag}_{cam}"
            fd.mkdir(parents=True)
            for i in idxs:
                # speeds in every band of the validator (< 10, 10-40, > 40)
                gt = _flow(rng, 2 * H, 2 * W) * rng.choice(
                    [1.0, 10.0, 30.0], (2 * H, 2 * W, 1)).astype(np.float32)
                gt[:H] = np.nan
                frame_utils.write_flo5(
                    str(fd / f"flow_{tag}_{cam}_{i:04d}.flo5"), gt)
        for scene, n in (("0001", 6), ("0002", 4)):
            d = root / "test" / scene / f"frame_{cam}"
            d.mkdir(parents=True)
            for i in range(1, n + 1):
                _png(d / f"frame_{cam}_{i:04d}.png", rng)
    return str(root)


def things_tree(root, seed=2, split="TEST"):
    """FlyingThings ``split`` ('TEST', the validator's, or 'TRAIN', the
    trainer's): one 5-frame sequence, clean and final, .pfm flows into the
    future and the past."""
    from streamflow_tpu_torch.data import frame_utils

    rng = np.random.default_rng(seed)
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        idir = root / dstype / split / "A" / "0000" / "left"
        idir.mkdir(parents=True)
        for i in range(5):
            _png(idir / f"{i:04d}.png", rng)
    for sub in ("into_future", "into_past"):
        d = root / "optical_flow" / split / "A" / "0000" / sub / "left"
        d.mkdir(parents=True)
        for i in range(5):
            frame_utils.write_pfm(str(d / f"{i:04d}.pfm"), np.concatenate(
                [_flow(rng), np.zeros((H, W, 1), np.float32)], -1))
    return str(root)


@functools.lru_cache(maxsize=None)
def served_pair():
    """The f32 JAX StreamFlow (T=4, 64x96, iters=2, CPU) with fan-in-scaled
    random params, its flow head's output layer times FLOW_HEAD_SCALE, and
    the port's StreamFlow (CPU, f32) holding the same weights. Made once
    per process; callers must not change them. Returns (jax_model,
    params, port_model)."""
    from _torch_parity import streamflow_pair

    from streamflow_tpu_torch.convert import build_mapping
    from streamflow_tpu_torch.params import load_jax

    jm, params, tm, _ = streamflow_pair(T=T, H=H, W=W, iters=ITERS)

    def scaled(tree, path=""):
        out = {}
        for key, val in tree.items():
            p = f"{path}/{key}" if path else key
            out[key] = (scaled(val, p) if hasattr(val, "items")
                        else val * FLOW_HEAD_SCALE if p in head else val)
        return out

    head = {dst for dst, src, _ in build_mapping()
            if src.startswith("update_block.flow_head.ffn2.2.")}
    assert len(head) == 2, head
    params = {"params": scaled(params["params"])}
    load_jax(tm, params)
    return jm, params, tm


@contextlib.contextmanager
def shared_jax_forward():
    """While open, the JAX package's validators and writers share one
    jitted forward per (model, iters): each of them builds a
    JittedForward, which jits a fresh closure of ``model.apply`` and so
    traces and loads it again on every call (~5 s on the CPU). The shared
    function is the same ``model.apply(params, x, iters=iters,
    test_mode=True)``; what each validator computes is unchanged."""
    import jax

    from streamflow_tpu import evaluation, submission

    cache = {}

    class Shared(evaluation.JittedForward):
        def __call__(self, images):
            key = (id(self.model), self.iters)
            if key not in cache:
                model, iters = self.model, self.iters
                cache[key] = jax.jit(lambda p, x: model.apply(
                    p, x, iters=iters, test_mode=True))
            return cache[key](self.params, images)

    saved = evaluation.JittedForward, submission.JittedForward
    evaluation.JittedForward = submission.JittedForward = Shared
    try:
        yield
    finally:
        evaluation.JittedForward, submission.JittedForward = saved
