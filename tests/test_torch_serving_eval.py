"""Port parity of the validators (evaluation.py) against the JAX package's,
with the same weights on the same synthetic trees, on the CPU in f32, and
GraphedForward's API on the CPU (where it runs eagerly).

Tolerances: EPEs rtol 1e-4 (the forwards agree to test_torch_model.py's
rtol 1e-4); a threshold rate (1/3/5 px, F1, Spring's speed bands) within
2 pixels' worth of its denominator, since a pixel whose EPE lies within
rounding of a threshold may fall on either side of it."""

import os

import numpy as np
import pytest
import torch
from _torch_serving import (H, ITERS, T, W, kitti_tree, served_pair,
                            shared_jax_forward, sintel_tree, spring_tree,
                            things_tree)

from streamflow_tpu import evaluation as jev
from streamflow_tpu_torch import evaluation as ev

torch.set_num_threads(4)


@pytest.fixture(scope="module", autouse=True)
def _one_jax_forward():
    with shared_jax_forward():
        yield


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("serving_eval")
    return {"sintel": sintel_tree(base / "sintel"),
            "kitti": kitti_tree(base / "kitti"),
            "kitti1": kitti_tree(base / "kitti1", seed=4, nseq=1),
            "spring": spring_tree(base / "spring"),
            "things": things_tree(base / "things")}


def _agree(got, want, pixels):
    """got/want: validator dicts; ``pixels``: the denominator of the
    rates (count of pixels the rates are taken over), one for all or a
    dict by key."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        if "epe" in k:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
        else:
            n = pixels[k] if isinstance(pixels, dict) else pixels
            scale = 100.0 if "f1" in k else 1.0
            assert abs(got[k] - v) <= 2 * scale / n, (k, got[k], v, n)


def test_graphed_forward_on_the_cpu_is_the_model():
    _, _, tm = served_pair()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 255, (1, T, H, W, 3)).astype(
        np.float32))
    fwd = ev.GraphedForward(tm, ITERS)
    assert torch.equal(fwd(x), tm(x, iters=ITERS, test_mode=True))
    fwd(x)
    assert len(fwd.buckets) == 1
    y = torch.from_numpy(rng.integers(0, 255, (1, T, 48, 64, 3)).astype(
        np.float32))
    assert torch.equal(fwd(y), tm(y, iters=ITERS, test_mode=True))
    assert len(fwd.buckets) == 2
    init = torch.from_numpy(rng.standard_normal(
        (1, T - 1, H // 8, W // 8, 2)).astype(np.float32))
    flows, lowres = fwd(x, init)
    want = tm(x, iters=ITERS, flow_init=init, test_mode=True)
    assert torch.equal(flows, want[0]) and torch.equal(lowres, want[1])
    assert lowres.shape == init.shape
    assert len(fwd.buckets) == 3
    assert all(b.graph is None for b in fwd.buckets.values())


def test_validate_sintel_matches_jax(trees):
    jm, params, tm = served_pair()
    kw = dict(root=trees["sintel"], iters=ITERS, nframes=T,
              dstypes=("clean",), progress=False)
    got = ev.validate_sintel(tm, **kw)
    want = jev.validate_sintel(jm, params, **kw)
    # alley_1 (7 frames): 2 windows, 6 pairs; ambush_2 (5): 3 + 1 pairs
    _agree(got, want, 10 * H * W)


def test_validate_sintel_warm_matches_jax(trees):
    jm, params, tm = served_pair()
    kw = dict(root=trees["sintel"], iters=ITERS, nframes=T,
              dstypes=("final",), progress=False)
    got = ev.validate_sintel_warm(tm, **kw)
    _agree(got, jev.validate_sintel_warm(jm, params, **kw), 10 * H * W)
    cold = ev.validate_sintel(tm, **kw)
    assert got["final_warm_epe"] != cold["final_epe"]


def test_validate_kitti_matches_jax(trees):
    jm, params, tm = served_pair()
    kw = dict(multi_root=trees["kitti"], iters=ITERS, nframes=T)
    got = ev.validate_kitti(tm, **kw)
    want = jev.validate_kitti(jm, params, **kw)
    assert 0 < got["kitti_f1"] < 100
    # F1 over the valid pixels of 3 final pairs (all valid)
    _agree(got, want, 3 * H * W)


def test_validate_kitti_tiled_matches_jax(trees):
    jm, params, tm = served_pair()
    # 'kitti432' pads the 64x96 frames to 432x96; tiles of the other
    # tests' 64x96 shape (one JAX compile for all): 8 rows x 2 (equal)
    # columns of corners, overlapping by 8 rows or more
    kw = dict(multi_root=trees["kitti1"], iters=ITERS, nframes=T,
              patch_size=(H, W), min_overlap=8)
    got = ev.validate_kitti_tiled(tm, **kw)
    _agree(got, jev.validate_kitti_tiled(jm, params, **kw), H * W)


def test_validate_spring_matches_jax(trees):
    jm, params, tm = served_pair()
    kw = dict(root=trees["spring"], iters=ITERS, nframes=T, progress=False)
    got = ev.validate_spring(tm, **kw)
    want = jev.validate_spring(jm, params, **kw)
    # the rates' denominators: the valid pixels (the bottom half of 4
    # windows x 3 pairs), by GT speed band
    ds = ev.mf_datasets.SpringVal(os.path.join(trees["spring"], "train"),
                                  nframes=T, subsample_groundtruth=True)
    mags = np.concatenate([np.linalg.norm(s["flows"][p], axis=-1).ravel()
                           for s in map(ds.load, range(len(ds)))
                           for p in range(T - 1)])
    mags = mags[~np.isnan(mags)]
    assert mags.size == 12 * H * W // 2
    bands = {"spring_1px": mags.size,
             "spring_1px_s0_10": int((mags < 10).sum()),
             "spring_1px_s10_40": int(((mags >= 10) & (mags < 40)).sum()),
             "spring_1px_s40": int((mags >= 40).sum())}
    assert min(bands.values()) > 0, bands
    _agree(got, want, bands)


def test_validate_things_mf_matches_jax(trees):
    jm, params, tm = served_pair()
    kw = dict(root=trees["things"], iters=ITERS, nframes=T)
    got = ev.validate_things_mf(tm, **kw)
    # per pass: the first window's 3 pairs, then the last pair of each
    # of the other 3 (into_future and into_past share the scene)
    _agree(got, jev.validate_things_mf(jm, params, **kw), 6 * H * W)


def test_validate_sintel_occlusion_matches_jax(trees):
    jm, params, tm = served_pair()
    kw = dict(root=trees["sintel"], iters=ITERS, nframes=T, dstype="clean")
    got = ev.validate_sintel_occlusion(tm, **kw)
    _agree(got, jev.validate_sintel_occlusion(jm, params, **kw), 10 * H * W)


def test_mine_worst_cases_matches_jax(trees, tmp_path):
    jm, params, tm = served_pair()
    kw = dict(root=trees["sintel"], iters=ITERS, nframes=T,
              dstypes=("clean",), top_k=3)
    ev.mine_worst_cases(tm, save_root=str(tmp_path / "port"), **kw)
    jev.mine_worst_cases(jm, params, save_root=str(tmp_path / "jax"), **kw)

    def listing(root):
        return sorted((os.path.relpath(d, root), sorted(fs))
                      for d, _, fs in os.walk(root))

    assert listing(tmp_path / "port") == listing(tmp_path / "jax")
    ranked = sorted(os.listdir(tmp_path / "port" / "clean"))
    assert len(ranked) == 3
    for name in ranked:
        got, want = (float((tmp_path / side / "clean" / name / "epe.txt")
                           .read_text()) for side in ("port", "jax"))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
