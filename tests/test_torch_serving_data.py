"""Port parity of the serving slice's data layer against the JAX package:
InputPadder's every mode, the file codecs, the flow visualisation and the
eval datasets on synthetic trees. Everything here is exact: the port's
modules are copies of the JAX package's NumPy code (padding aside, which
copies edge pixels)."""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_serving import (H, W, kitti_tree, sintel_tree, spring_tree,
                            things_tree)

from streamflow_tpu.data import frame_utils as jfu
from streamflow_tpu.data import mf_datasets as jds
from streamflow_tpu.data.flow_viz import flow_to_image as jflow_to_image
from streamflow_tpu.ops import padding as jpadding
from streamflow_tpu_torch.data import frame_utils as fu
from streamflow_tpu_torch.data import mf_datasets as ds
from streamflow_tpu_torch.data.flow_viz import flow_to_image
from streamflow_tpu_torch.ops.padding import InputPadder


@pytest.mark.parametrize("mode", ["sintel", "kitti", "kitti432", "kitti400",
                                  "kitti376"])
@pytest.mark.parametrize("hw", [(370, 1226), (375, 1242), (368, 1232)])
def test_input_padder_modes(mode, hw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 2, *hw, 3)).astype(np.float32)
    p, jp = InputPadder(x.shape, mode=mode), jpadding.InputPadder(
        x.shape, mode=mode)
    assert p.padded_shape == jp.padded_shape
    got = p.pad(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.pad(x)))
    np.testing.assert_array_equal(p.unpad(got).numpy(), x)
    y = rng.standard_normal((2, *got.shape[-3:-1], 2)).astype(np.float32)
    np.testing.assert_array_equal(p.unpad(torch.from_numpy(y)).numpy(),
                                  np.asarray(jp.unpad(y)))
    a, b = p.pad_list([torch.from_numpy(x[0]), torch.from_numpy(x[0, :1])])
    ja, jb = jp.pad_list([x[0], x[0, :1]])
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_flo_pfm_roundtrip_and_readers(tmp_path):
    rng = np.random.default_rng(1)
    flow = rng.standard_normal((H, W, 2)).astype(np.float32)
    fu.write_flo(tmp_path / "a.flo", flow)
    np.testing.assert_array_equal(fu.read_flo(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(jfu.read_flo(tmp_path / "a.flo"), flow)
    jfu.write_flo(tmp_path / "b.flo", flow)
    assert (tmp_path / "a.flo").read_bytes() == (
        tmp_path / "b.flo").read_bytes()
    for shape in ((H, W, 3), (H, W)):
        img = rng.standard_normal(shape).astype(np.float32)
        fu.write_pfm(str(tmp_path / "a.pfm"), img)
        np.testing.assert_array_equal(fu.read_pfm(tmp_path / "a.pfm"), img)
        np.testing.assert_array_equal(jfu.read_pfm(tmp_path / "a.pfm"), img)
        np.testing.assert_array_equal(fu.read_gen(tmp_path / "a.pfm"),
                                      jfu.read_gen(tmp_path / "a.pfm"))
    np.testing.assert_array_equal(fu.read_gen(tmp_path / "a.flo"),
                                  jfu.read_gen(tmp_path / "a.flo"))
    with pytest.raises(ValueError, match="magic"):
        (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
        fu.read_flo(tmp_path / "bad.flo")


def test_kitti_png_flo5_and_image_readers(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    flow = 20 * rng.standard_normal((H, W, 2)).astype(np.float32)
    fu.write_flow_kitti(tmp_path / "k.png", flow)
    got, valid = fu.read_flow_kitti(tmp_path / "k.png")
    # 16-bit png: 1/64 px quanta, truncated on write
    assert np.abs(got - flow).max() <= 1 / 64
    assert (valid == 1).all()
    jgot, jvalid = jfu.read_flow_kitti(tmp_path / "k.png")
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(valid, jvalid)
    gt = rng.standard_normal((H, W, 2)).astype(np.float32)
    gt[:3] = np.nan
    fu.write_flo5(str(tmp_path / "a.flo5"), gt)
    np.testing.assert_array_equal(fu.read_flo5(str(tmp_path / "a.flo5")), gt)
    np.testing.assert_array_equal(jfu.read_flo5(str(tmp_path / "a.flo5")), gt)
    np.testing.assert_array_equal(fu.read_gen(str(tmp_path / "a.flo5")), gt)
    Image.fromarray(rng.integers(0, 255, (H, W), dtype=np.uint8)).save(
        tmp_path / "g.png")
    img = fu.read_image(tmp_path / "g.png")
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, jfu.read_image(tmp_path / "g.png"))


def test_flow_to_image_matches_jax():
    rng = np.random.default_rng(3)
    flow = 5 * rng.standard_normal((H, W, 2)).astype(np.float32)
    for clip in (None, 3.0):
        np.testing.assert_array_equal(flow_to_image(flow, clip),
                                      jflow_to_image(flow, clip))
    zero = np.zeros((8, 8, 2), np.float32)
    np.testing.assert_array_equal(flow_to_image(zero), jflow_to_image(zero))


def _same_dataset(got, want, n_load=None):
    assert [dataclasses.asdict(r) for r in got.records] == [
        dataclasses.asdict(r) for r in want.records]
    assert len(got) > 0
    for i in range(len(got) if n_load is None else n_load):
        a, b = got.load(i), want.load(i)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("serving_data")
    return {"sintel": sintel_tree(base / "sintel"),
            "kitti": kitti_tree(base / "kitti"),
            "spring": spring_tree(base / "spring"),
            "things": things_tree(base / "things")}


@pytest.mark.parametrize("split,dstype,occ", [
    ("training", "clean", False), ("training", "final", True),
    ("test", "clean", False)])
def test_sintel_eval_dataset(trees, split, dstype, occ):
    kw = dict(split=split, root=trees["sintel"], dstype=dstype, nframes=4,
              occ_map=occ)
    got, want = ds.SintelMultiframeEval(**kw), jds.SintelMultiframeEval(**kw)
    _same_dataset(got, want)
    if split == "training":
        ids = [r.frame_ids for r in got.records]
        assert ids == [(0, 1, 2, 3), (3, 4, 5, 6), (0, 1, 2, 3),
                       (-1, -1, 3, 4)]


@pytest.mark.parametrize("split", ["training", "testing"])
def test_kitti_eval_dataset(trees, split):
    got = ds.KITTIMultiFrameEval(trees["kitti"], split, nframes=4)
    _same_dataset(got, jds.KITTIMultiFrameEval(trees["kitti"], split,
                                               nframes=4))
    assert [r.frame_ids for r in got.records] == [(8, 9, 10, 11)] * 3


def test_spring_datasets(trees):
    import os.path as osp

    root = trees["spring"]
    got = ds.SpringVal(osp.join(root, "train"), nframes=4)
    _same_dataset(got, jds.SpringVal(osp.join(root, "train"), nframes=4))
    assert len(got) == 4
    test = ds.Spring(root=osp.join(root, "test"), nframes=4, is_test=True)
    _same_dataset(test, jds.Spring(root=osp.join(root, "test"), nframes=4,
                                   is_test=True), n_load=2)


def test_things_eval_dataset(trees):
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        kw = dict(root=trees["things"], dstype=dstype, split="validation",
                  nframes=4)
        _same_dataset(ds.FlyingThings3DMultiFrame(None, **kw),
                      jds.FlyingThings3DMultiFrame(None, **kw))
