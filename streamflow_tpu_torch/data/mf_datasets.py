"""Multi-frame optical-flow datasets (reference core/mf_datasets.py).

Design differences from the torch Dataset zoo:

- A dataset is an *index* (list of ClipRecord: image paths, flow paths, GT
  flags, dedup ids) plus a pure ``load(record, rng)`` function returning NumPy
  arrays — no framework base class, no hidden worker-seed state (each worker
  gets an explicit np.random.Generator; reference re-seeds globals per worker,
  core/mf_datasets.py:170-177).
- Mixing uses explicit per-dataset *replication counts* identical to the
  reference's ``100*sintel_clean + ...`` recipe (core/mf_datasets.py:1407)
  but stored as (dataset, count) pairs — no list multiplication of
  thousand-entry path lists.
- Samples are channel-last: images (T, H, W, 3) uint8/f32, flows (F, H, W, 2)
  f32, valids (F, H, W) f32.

Window/GT semantics preserved per dataset:
- FlyingThings: stride-1 windows, both into_future and reversed into_past
  (reference :346-375).
- Sintel train: stride-1 windows per scene; tail window padded from the end
  with -1 frame-id markers (:638).
- Sintel eval: stride T-1 windows; -1 marks frames already covered so EPE is
  counted once (:1150); optional occlusion maps.
- KITTI: pseudo-multiframe from multi-kitti frames 9..12; only the 10->11
  pair has GT, others get valid*0 (:754-756, 767).
- HD1K: sparse GT windows (:1316-1383).
- Spring: 1080p, fw+bw directions, both cameras, GT optionally subsampled
  [::2,::2] (:189-190), scene 0041 held out as val split (:244-247).

The port's own copy of streamflow_tpu/data/mf_datasets.py.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
from glob import glob
from typing import List, Optional, Sequence, Tuple

import numpy as np

from streamflow_tpu_torch.data import frame_utils
from streamflow_tpu_torch.data.augmentor import FlowAugmentor, SparseFlowAugmentor


@dataclasses.dataclass
class ClipRecord:
    images: Tuple[str, ...]
    flows: Tuple[Optional[str], ...]      # len T-1; None = no GT for that pair
    has_gt: Tuple[bool, ...]              # len T-1
    frame_ids: Tuple[int, ...]            # len T; -1 = duplicate (skip in eval)
    scene: str = ""
    occlusions: Tuple[str, ...] = ()
    subsample_gt: bool = False
    sparse: bool = False                  # KITTI-png GT with valid channel


def _dense_windows(images: Sequence[str], flows: Sequence[str], nframes: int,
                   stride: int, scene: str,
                   occs: Sequence[str] = ()) -> List[ClipRecord]:
    """Sliding windows with tail-window dedup markers (the reference's
    repeated while-loop pattern)."""
    recs = []
    n = len(images)
    assert n >= nframes, f"{scene}: {n} < {nframes} frames"
    i = 0
    while True:
        if i + nframes <= n:
            imgs = images[i : i + nframes]
            flos = flows[i : i + nframes - 1]
            ocs = occs[i : i + nframes - 1] if occs else ()
            ids = list(range(i, i + nframes))
        else:
            imgs = images[n - nframes : n]
            flos = flows[len(flows) - nframes + 1 :]
            ocs = occs[len(flows) - nframes + 1 :] if occs else ()
            ids = [-1 if j < i else j for j in range(n - nframes, n)]
        recs.append(ClipRecord(
            images=tuple(imgs), flows=tuple(flos),
            has_gt=tuple(True for _ in flos), frame_ids=tuple(ids),
            scene=scene, occlusions=tuple(ocs),
        ))
        if i + nframes >= n:
            break
        i += stride
    return recs


class ClipDataset:
    """Index + loader. Subclasses populate self.records in __init__."""

    def __init__(self, aug_params=None, sparse: bool = False):
        self.records: List[ClipRecord] = []
        self.sparse = sparse
        self.augmentor = None
        if aug_params is not None:
            self.augmentor = (SparseFlowAugmentor(**aug_params) if sparse
                              else FlowAugmentor(**aug_params))

    def __len__(self):
        return len(self.records)

    def load(self, index: int, rng: Optional[np.random.Generator] = None):
        rec = self.records[index % len(self.records)]
        rng = rng or np.random.default_rng()

        imgs = [frame_utils.read_image(p) for p in rec.images]

        flows, valids = [], []
        for p, gt in zip(rec.flows, rec.has_gt):
            if p is None:
                flows.append(np.zeros((*imgs[0].shape[:2], 2), np.float32))
                valids.append(np.zeros(imgs[0].shape[:2], np.float32))
                continue
            if rec.sparse:
                fl, v = frame_utils.read_flow_kitti(p)
            else:
                fl = np.asarray(frame_utils.read_gen(p), np.float32)
                if rec.subsample_gt:
                    fl = fl[::2, ::2]
                v = ((np.abs(fl[..., 0]) < 1000) & (np.abs(fl[..., 1]) < 1000))
            if not gt:
                v = np.zeros_like(v, dtype=np.float32)
            flows.append(fl.astype(np.float32))
            valids.append(np.asarray(v, np.float32))

        if self.augmentor is not None:
            if self.sparse:
                imgs, flows, valids = self.augmentor(imgs, flows, valids, rng)
                # pairs without GT keep valid == 0 through augmentation
                for i, gt in enumerate(rec.has_gt):
                    if not gt:
                        valids[i] = np.zeros_like(valids[i])
            else:
                imgs, flows = self.augmentor(imgs, flows, rng)
                valids = [
                    ((np.abs(fl[..., 0]) < 1000) & (np.abs(fl[..., 1]) < 1000)
                     ).astype(np.float32)
                    for fl in flows
                ]

        sample = {
            "images": np.stack(imgs).astype(np.float32),
            "flows": np.stack(flows),
            "valids": np.stack(valids).astype(np.float32),
            "frame_ids": np.asarray(rec.frame_ids, np.int32),
        }
        if rec.occlusions:
            occ = [np.asarray(frame_utils.read_image(p))[..., 0] // 255
                   for p in rec.occlusions]
            sample["occlusions"] = np.stack(occ).astype(bool)
        return sample

    # torch-Dataset-style conveniences
    def __getitem__(self, index):
        return self.load(index)


# --------------------------------------------------------------------- datasets
class FlyingThings3DMultiFrame(ClipDataset):
    def __init__(self, aug_params=None, root="datasets/flyingthings3d",
                 split="training", dstype="frames_cleanpass", nframes=4):
        super().__init__(aug_params)
        sdir = "TRAIN" if split == "training" else "TEST"
        for cam in ["left"]:
            image_dirs = sorted(glob(osp.join(root, dstype, f"{sdir}/*/*")))
            image_dirs = sorted(osp.join(f, cam) for f in image_dirs)
            for direction in ["into_future", "into_past"]:
                flow_dirs = sorted(glob(osp.join(root, f"optical_flow/{sdir}/*/*")))
                flow_dirs = sorted(osp.join(f, direction, cam) for f in flow_dirs)
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob(osp.join(idir, "*.png")))
                    flows = sorted(glob(osp.join(fdir, "*.pfm")))
                    if len(images) < nframes:
                        continue
                    if direction == "into_future":
                        self.records += _dense_windows(
                            images, flows[: len(images) - 1], nframes, 1,
                            scene=idir)
                    else:
                        # reversed sequence: flow file k describes k -> k-1
                        rev_imgs = images[::-1]
                        rev_flows = flows[::-1][: len(images) - 1]
                        self.records += _dense_windows(
                            rev_imgs, rev_flows, nframes, 1, scene=idir)


class SintelMultiframe(ClipDataset):
    """Training windows, stride 1 (reference :600-687)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/sintel", dstype="clean", nframes=4):
        super().__init__(aug_params)
        image_root = osp.join(root, split, dstype)
        flow_root = osp.join(root, split, "flow")
        for scene in sorted(os.listdir(image_root)):
            images = sorted(glob(osp.join(image_root, scene, "*.png")))
            flows = sorted(glob(osp.join(flow_root, scene, "*.flo")))
            if len(images) < nframes:
                continue
            self.records += _dense_windows(images, flows, nframes, 1, scene)


class SintelMultiframeEval(ClipDataset):
    """Eval/submission windows, stride T-1, with -1 dedup markers
    (reference :1095-1185). split='test' yields records without flows."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/sintel", dstype="clean", nframes=4,
                 occ_map: bool = False, stride: Optional[int] = None):
        super().__init__(aug_params)
        self.is_test = split == "test"
        image_root = osp.join(root, split, dstype)
        flow_root = osp.join(root, split, "flow")
        occ_root = osp.join(root, split, "occlusions")
        stride = stride or (nframes - 1)
        for scene in sorted(os.listdir(image_root)):
            images = sorted(glob(osp.join(image_root, scene, "*.png")))
            if len(images) < nframes:
                continue
            if self.is_test:
                flows = [None] * (len(images) - 1)
                recs = _dense_windows(images, flows, nframes, stride, scene)
                for r in recs:
                    r.has_gt = tuple(False for _ in r.flows)  # type: ignore
                self.records += recs
            else:
                flows = sorted(glob(osp.join(flow_root, scene, "*.flo")))
                occs = (sorted(glob(osp.join(occ_root, scene, "*.png")))
                        if occ_map else ())
                self.records += _dense_windows(images, flows, nframes, stride,
                                               scene, occs)


class KITTIMultiFrame(ClipDataset):
    """Pseudo-multiframe training windows from multi-kitti frames 9..12; GT
    only for the 10->11 pair (reference :691-771 and the _T4 variant
    :776-856 which pins start=9)."""

    def __init__(self, multi_root="datasets/multi-kitti", split="training",
                 aug_params=None, nframes=4, t4: bool = False):
        super().__init__(aug_params, sparse=True)
        img_root = osp.join(multi_root, split, "image_2")
        flow_root = osp.join(multi_root, split, "flow_occ")
        starts = [9] if t4 else list(range(9, 9 - nframes + 2, -1))
        for seq in range(200):
            # the reference hard-codes 200 sequences; skip absent ones so a
            # partial/missing multi-kitti root yields an empty dataset rather
            # than records that crash at load time
            if not osp.exists(osp.join(img_root, f"{seq:06d}_10.png")):
                continue
            for start in starts:
                frames = list(range(start, start + nframes))
                imgs = [osp.join(img_root, f"{seq:06d}_{i:02d}.png")
                        for i in frames]
                flow = osp.join(flow_root, f"{seq:06d}_10.png")
                has_gt = tuple(i == 10 for i in frames[:-1])
                self.records.append(ClipRecord(
                    images=tuple(imgs),
                    flows=tuple(flow for _ in frames[:-1]),
                    has_gt=has_gt,
                    frame_ids=tuple(frames),
                    scene=f"{seq:06d}",
                    sparse=True,
                ))


class KITTIMultiFrameEval(ClipDataset):
    """Frames [12-T..11]; only the final pair carries GT (reference :945-1016)."""

    def __init__(self, multi_root="datasets/multi-kitti", split="training",
                 nframes=4):
        super().__init__(None, sparse=True)
        self.is_test = split == "testing"
        img_root = osp.join(multi_root, split, "image_2")
        flow_root = osp.join(multi_root, split, "flow_occ")
        for seq in range(200):
            if not osp.exists(osp.join(img_root, f"{seq:06d}_10.png")):
                continue
            frames = list(range(12 - nframes, 12))
            imgs = [osp.join(img_root, f"{seq:06d}_{i:02d}.png") for i in frames]
            gt = None if self.is_test else osp.join(flow_root, f"{seq:06d}_10.png")
            flows = tuple([None] * (nframes - 2) + [gt])
            self.records.append(ClipRecord(
                images=tuple(imgs), flows=flows,
                has_gt=tuple(f is not None for f in flows),
                frame_ids=tuple(frames), scene=f"{seq:06d}_10.png",
                sparse=True,
            ))


class HD1KMultiFrame(ClipDataset):
    """Sparse-GT HD1K windows, stride 1 (reference :1316-1383)."""

    def __init__(self, aug_params=None, root="datasets/HD1k", nframes=4):
        super().__init__(aug_params, sparse=True)
        seq = 0
        while True:
            flows = sorted(glob(osp.join(root, "hd1k_flow_gt",
                                         f"flow_occ/{seq:06d}_*.png")))
            images = sorted(glob(osp.join(root, "hd1k_input",
                                          f"image_2/{seq:06d}_*.png")))
            if not flows:
                break
            if len(images) >= nframes:
                recs = _dense_windows(images, flows, nframes, 1, f"{seq:06d}")
                for r in recs:
                    r.sparse = True
                self.records += recs
            seq += 1


class Spring(ClipDataset):
    """Spring training/eval windows: stride T-1, fw+bw, both cameras
    (reference :120-247 for submission, :227-324 for train)."""

    def __init__(self, aug_params=None, root="datasets/spring/train",
                 nframes=4, subsample_groundtruth=False, split=False,
                 is_test=False):
        super().__init__(aug_params)
        self.is_test = is_test
        for scene in sorted(os.listdir(root)):
            if split and scene == "0041":
                continue  # validation scene held out (reference :244-247)
            for cam in ["left", "right"]:
                images = sorted(glob(osp.join(root, scene, f"frame_{cam}", "*.png")))
                if len(images) < nframes:
                    continue
                n = len(images)
                fw = [osp.join(root, scene, f"flow_FW_{cam}",
                               f"flow_FW_{cam}_{i:04d}.flo5")
                      for i in range(1, n)]
                bw = [osp.join(root, scene, f"flow_BW_{cam}",
                               f"flow_BW_{cam}_{i:04d}.flo5")
                      for i in range(n, 1, -1)]
                if is_test:
                    fw = [None] * (n - 1)
                    bw = [None] * (n - 1)
                for imgs, flows, tag in ((images, fw, "FW"),
                                         (images[::-1], bw, "BW")):
                    recs = _dense_windows(imgs, flows, nframes, nframes - 1,
                                          scene=f"{scene}/{cam}/{tag}")
                    for r in recs:
                        r.subsample_gt = subsample_groundtruth  # type: ignore
                    self.records += recs


class SpringVal(Spring):
    """Scene 0041 only (reference evaluate_mf.py:116-118)."""

    def __init__(self, root="datasets/spring/train", nframes=4,
                 subsample_groundtruth=True):
        ClipDataset.__init__(self, None)
        base = Spring(None, root, nframes, subsample_groundtruth, split=False)
        self.records = [r for r in base.records if r.scene.startswith("0041")]


class BiFlyingThings3DMultiFrame(ClipDataset):
    """Bidirectional-GT FlyingThings windows (forward + backward flow per
    pair) for the 'bithings' stage (reference Bi_FlyingThings3DMultiFrame,
    core/mf_datasets.py:523-596). Samples carry an extra 'flows_bw' array."""

    def __init__(self, aug_params=None, root="datasets/flyingthings3d",
                 split="training", dstype="frames_cleanpass", nframes=4):
        super().__init__(aug_params)
        self.bw_flows: List[Tuple[str, ...]] = []
        for cam in ["left"]:
            image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
            image_dirs = sorted(osp.join(f, cam) for f in image_dirs)
            flow_dirs = sorted(glob(osp.join(root, "optical_flow/TRAIN/*/*")))
            fw_dirs = sorted(osp.join(f, "into_future", cam) for f in flow_dirs)
            bw_dirs = sorted(osp.join(f, "into_past", cam) for f in flow_dirs)
            for idir, fdir, bdir in zip(image_dirs, fw_dirs, bw_dirs):
                images = sorted(glob(osp.join(idir, "*.png")))
                fw = sorted(glob(osp.join(fdir, "*.pfm")))
                bw = sorted(glob(osp.join(bdir, "*.pfm")))
                if len(images) < nframes:
                    continue
                n = len(images)
                i = 0
                while True:
                    s = i if i + nframes <= n else n - nframes
                    self.records.append(ClipRecord(
                        images=tuple(images[s : s + nframes]),
                        flows=tuple(fw[s : s + nframes - 1]),
                        has_gt=tuple(True for _ in range(nframes - 1)),
                        frame_ids=tuple(range(s, s + nframes)),
                        scene=idir))
                    # backward flow of pair (t, t+1) is into_past at t+1
                    self.bw_flows.append(tuple(bw[s + 1 : s + nframes]))
                    if i + nframes >= n:
                        break
                    i += nframes - 1

    def load(self, index, rng=None):
        i = index % len(self.records)
        rec = self.records[i]
        rng = rng or np.random.default_rng()

        imgs = [frame_utils.read_image(p) for p in rec.images]
        fw = [np.asarray(frame_utils.read_gen(p), np.float32)
              for p in rec.flows]
        bw = [np.asarray(frame_utils.read_gen(p), np.float32)
              for p in self.bw_flows[i]]

        if self.augmentor is not None:
            # ONE spatial/photometric draw applied to BOTH flow directions:
            # rerun the augmentor with an identically-seeded generator. (The
            # reference draws fresh randomness for the backward flows,
            # core/mf_datasets.py:583-586, leaving them spatially
            # inconsistent with the images — repaired here, not copied.)
            seed = int(rng.integers(0, 2**63))
            imgs_a, fw = self.augmentor(imgs, fw, np.random.default_rng(seed))
            _, bw = self.augmentor(imgs, bw, np.random.default_rng(seed))
            imgs = imgs_a

        def valids_of(flows):
            return np.stack([
                ((np.abs(fl[..., 0]) < 1000) & (np.abs(fl[..., 1]) < 1000)
                 ).astype(np.float32) for fl in flows])

        return {
            "images": np.stack(imgs).astype(np.float32),
            "flows": np.stack(fw),
            "valids": valids_of(fw),
            "flows_bw": np.stack(bw),
            "valids_bw": valids_of(bw),
            "frame_ids": np.asarray(rec.frame_ids, np.int32),
        }


# ----------------------------------------------------------------------- mixing
class MixedDataset:
    """Weighted concatenation: (dataset, replication) pairs, same epoch
    semantics as the reference's ``100*a + b`` list replication."""

    def __init__(self, parts: Sequence[Tuple[ClipDataset, int]]):
        self.parts = [(d, int(c)) for d, c in parts if len(d) > 0]
        self._sizes = [len(d) * c for d, c in self.parts]
        self._total = sum(self._sizes)

    def __len__(self):
        return self._total

    def load(self, index: int, rng=None):
        index = index % self._total
        for (d, _c), sz in zip(self.parts, self._sizes):
            if index < sz:
                return d.load(index % len(d), rng)
            index -= sz
        raise IndexError

    __getitem__ = load


def fetch_dataset(stage: str, T: int = 4, image_size=(432, 960),
                  things_root="datasets/flyingthings3d",
                  sintel_root="datasets/sintel",
                  multi_root="datasets/multi-kitti",
                  hd1k_root="datasets/HD1k",
                  spring_root="datasets/spring",
                  split=False):
    """Stage -> dataset mix (reference fetch_dataloader,
    core/mf_datasets.py:1386-1457)."""
    cs = {"crop_size": image_size}
    if stage == "things":
        aug = dict(cs, min_scale=-0.4, max_scale=0.8, do_flip=True)
        return MixedDataset([
            (FlyingThings3DMultiFrame(aug, things_root, dstype="frames_cleanpass", nframes=T), 1),
            (FlyingThings3DMultiFrame(aug, things_root, dstype="frames_finalpass", nframes=T), 1),
        ])
    if stage in ("sintel", "sintel2", "sintel3"):
        aug = dict(cs, min_scale=-0.2, max_scale=0.6, do_flip=True)
        kitti_weight = 200 if stage == "sintel2" else 50
        kitti_t4 = stage != "sintel3"
        return MixedDataset([
            (SintelMultiframe(aug, root=sintel_root, dstype="clean", nframes=T), 100),
            (SintelMultiframe(aug, root=sintel_root, dstype="final", nframes=T), 100),
            (KITTIMultiFrame(multi_root, "training",
                             dict(cs, min_scale=-0.3, max_scale=0.5, do_flip=True),
                             nframes=T, t4=kitti_t4), kitti_weight),
            (HD1KMultiFrame(dict(cs, min_scale=-0.5, max_scale=0.2, do_flip=True),
                            hd1k_root, nframes=T), 5),
            (FlyingThings3DMultiFrame(aug, things_root,
                                      dstype="frames_cleanpass", nframes=T), 1),
        ])
    if stage == "spring":
        aug = dict(cs, min_scale=-0.2, max_scale=0.6, do_flip=True)
        return MixedDataset([
            (Spring(aug, osp.join(spring_root, "train"), nframes=T,
                    subsample_groundtruth=True, split=split), 1),
        ])
    if stage == "kitti":
        aug = dict(cs, min_scale=-0.2, max_scale=0.4, do_flip=False)
        return MixedDataset([
            (KITTIMultiFrame(multi_root, "training", aug, nframes=T, t4=(T == 4)), 1),
        ])
    if stage == "bithings":
        # reference core/mf_datasets.py:1445-1450: clean+final bidirectional
        # FlyingThings with the things-stage augmentation
        aug = dict(cs, min_scale=-0.4, max_scale=0.8, do_flip=True)
        return MixedDataset([
            (BiFlyingThings3DMultiFrame(aug, things_root,
                                        dstype="frames_cleanpass", nframes=T), 1),
            (BiFlyingThings3DMultiFrame(aug, things_root,
                                        dstype="frames_finalpass", nframes=T), 1),
        ])
    raise ValueError(f"unknown stage '{stage}'")
