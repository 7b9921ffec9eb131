"""Two-frame datasets (RAFT-compatible; reference core/datasets.py:14-302):
MpiSintel, FlyingChairs, FlyingThings3D, KITTI, HD1K and the C+T+K+S+H stage
mixes — for the RAFT/GMA/SKFlow baseline models.

Implemented as ClipRecord indexes with T=2 windows, sharing the multi-frame
loader machinery (data/mf_datasets.py).

The port's own copy of streamflow_tpu/data/datasets.py."""

from __future__ import annotations

import os
import os.path as osp
from glob import glob

import numpy as np

from streamflow_tpu_torch.data.mf_datasets import (ClipDataset, ClipRecord,
                                                  MixedDataset)


class MpiSintel(ClipDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/sintel", dstype="clean", occlusion=False):
        super().__init__(aug_params)
        self.is_test = split == "test"
        image_root = osp.join(root, split, dstype)
        flow_root = osp.join(root, split, "flow")
        occ_root = osp.join(root, split, "occlusions")
        for scene in sorted(os.listdir(image_root)):
            images = sorted(glob(osp.join(image_root, scene, "*.png")))
            flows = (sorted(glob(osp.join(flow_root, scene, "*.flo")))
                     if not self.is_test else [None] * (len(images) - 1))
            occs = (sorted(glob(osp.join(occ_root, scene, "*.png")))
                    if occlusion and not self.is_test else [None] * len(images))
            for i in range(len(images) - 1):
                self.records.append(ClipRecord(
                    images=(images[i], images[i + 1]),
                    flows=(flows[i],),
                    has_gt=(flows[i] is not None,),
                    frame_ids=(i, i + 1),
                    scene=scene,
                    occlusions=(occs[i],) if occlusion and occs[i] else (),
                ))


class FlyingChairs(ClipDataset):
    """Pairs (ppm, ppm, flo) with the released train/val split file
    (chairs_split.txt: 1 = train, 2 = val)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/FlyingChairs_release/data",
                 split_file="chairs_split.txt"):
        super().__init__(aug_params)
        images = sorted(glob(osp.join(root, "*.ppm")))
        flows = sorted(glob(osp.join(root, "*.flo")))
        assert len(images) == 2 * len(flows), "chairs layout mismatch"
        sf = osp.join(osp.dirname(root.rstrip("/")), split_file)
        if osp.exists(sf):
            split_ids = np.loadtxt(sf, dtype=np.int32)
        else:
            split_ids = np.ones(len(flows), np.int32)
        want = 1 if split == "training" else 2
        for i, flo in enumerate(flows):
            if i < len(split_ids) and split_ids[i] != want:
                continue
            self.records.append(ClipRecord(
                images=(images[2 * i], images[2 * i + 1]),
                flows=(flo,), has_gt=(True,), frame_ids=(0, 1),
                scene=f"{i:05d}"))


class FlyingThings3D(ClipDataset):
    def __init__(self, aug_params=None, root="datasets/flyingthings3d",
                 dstype="frames_cleanpass", split="training"):
        super().__init__(aug_params)
        sdir = "TRAIN" if split == "training" else "TEST"
        for cam in ["left"]:
            for direction in ["into_future", "into_past"]:
                image_dirs = sorted(glob(osp.join(root, dstype, f"{sdir}/*/*")))
                image_dirs = sorted(osp.join(f, cam) for f in image_dirs)
                flow_dirs = sorted(glob(osp.join(root, f"optical_flow/{sdir}/*/*")))
                flow_dirs = sorted(osp.join(f, direction, cam) for f in flow_dirs)
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob(osp.join(idir, "*.png")))
                    flows = sorted(glob(osp.join(fdir, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            pair, flo = (images[i], images[i + 1]), flows[i]
                        else:
                            pair, flo = (images[i + 1], images[i]), flows[i + 1]
                        self.records.append(ClipRecord(
                            images=pair, flows=(flo,), has_gt=(True,),
                            frame_ids=(i, i + 1), scene=idir))


class KITTI(ClipDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI"):
        super().__init__(aug_params, sparse=True)
        self.is_test = split == "testing"
        root = osp.join(root, split)
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
        flows = (sorted(glob(osp.join(root, "flow_occ/*_10.png")))
                 if not self.is_test else [None] * len(images1))
        for img1, img2, flo in zip(images1, images2, flows):
            self.records.append(ClipRecord(
                images=(img1, img2), flows=(flo,),
                has_gt=(flo is not None,), frame_ids=(0, 1),
                scene=osp.basename(img1), sparse=True))


class HD1K(ClipDataset):
    def __init__(self, aug_params=None, root="datasets/HD1k"):
        super().__init__(aug_params, sparse=True)
        seq = 0
        while True:
            flows = sorted(glob(osp.join(root, "hd1k_flow_gt",
                                         f"flow_occ/{seq:06d}_*.png")))
            images = sorted(glob(osp.join(root, "hd1k_input",
                                          f"image_2/{seq:06d}_*.png")))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.records.append(ClipRecord(
                    images=(images[i], images[i + 1]), flows=(flows[i],),
                    has_gt=(True,), frame_ids=(i, i + 1),
                    scene=f"{seq:06d}", sparse=True))
            seq += 1


def fetch_dataset_2f(stage: str, image_size=(368, 768), train_ds="C+T+K+S+H",
                     chairs_root="datasets/FlyingChairs_release/data",
                     things_root="datasets/flyingthings3d",
                     sintel_root="datasets/sintel",
                     kitti_root="datasets/KITTI",
                     hd1k_root="datasets/HD1k"):
    """Stage -> two-frame dataset mix (reference core/datasets.py:270-302)."""
    cs = {"crop_size": image_size}
    if stage == "chairs":
        aug = dict(cs, min_scale=-0.1, max_scale=1.0, do_flip=True)
        return MixedDataset([(FlyingChairs(aug, "training", chairs_root), 1)])
    if stage == "things":
        aug = dict(cs, min_scale=-0.4, max_scale=0.8, do_flip=True)
        return MixedDataset([
            (FlyingThings3D(aug, things_root, "frames_cleanpass"), 1),
            (FlyingThings3D(aug, things_root, "frames_finalpass"), 1),
        ])
    if stage == "sintel":
        aug = dict(cs, min_scale=-0.2, max_scale=0.6, do_flip=True)
        parts = [
            (MpiSintel(aug, "training", sintel_root, "clean"), 100),
            (MpiSintel(aug, "training", sintel_root, "final"), 100),
            (FlyingThings3D(aug, things_root, "frames_cleanpass"), 1),
        ]
        if train_ds == "C+T+K+S+H":
            parts += [
                (KITTI(dict(cs, min_scale=-0.3, max_scale=0.5, do_flip=True),
                       "training", kitti_root), 200),
                (HD1K(dict(cs, min_scale=-0.5, max_scale=0.2, do_flip=True),
                      hd1k_root), 5),
            ]
        return MixedDataset(parts)
    if stage == "kitti":
        aug = dict(cs, min_scale=-0.2, max_scale=0.4, do_flip=False)
        return MixedDataset([(KITTI(aug, "training", kitti_root), 1)])
    raise ValueError(f"unknown stage '{stage}'")
