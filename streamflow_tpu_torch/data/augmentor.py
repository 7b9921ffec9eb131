"""Training-time augmentation for T-frame clips (reference
core/utils/augmentor.py:15-264): photometric jitter (asymmetric with p=0.2),
spatial scale 2^U(min,max) with p=0.8 stretch, h-flip p=0.5 / v-flip p=0.1,
random crop — all applied consistently across the frame list. The sparse
variant (KITTI/HD1K) resizes flow by point reprojection and uses crop margins.

Host-side NumPy/cv2. Color jitter is implemented natively (no torchvision):
brightness/contrast/saturation/hue with uniformly sampled factors applied in
random order, matching torchvision.ColorJitter semantics. The eraser
augmentation exists but is disabled by default exactly like the reference
(core/utils/augmentor.py:129).

All randomness flows through an explicit np.random.Generator so each data
worker is reproducibly seeded (SURVEY §5.2).

The port's own copy of streamflow_tpu/data/augmentor.py.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def _cv2():
    """cv2, imported at first use (a program that never augments, such as
    one that feeds the loader clips from memory, need not have it), or
    None where it is not installed."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return None
    cv2.setNumThreads(0)
    cv2.ocl.setUseOpenCL(False)
    return cv2


# ----------------------------------------------------------------- color jitter
def _adjust_brightness(img: np.ndarray, f: float) -> np.ndarray:
    return np.clip(img.astype(np.float32) * f, 0, 255)


def _adjust_contrast(img: np.ndarray, f: float) -> np.ndarray:
    gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
    mean = gray.mean()
    return np.clip(mean + f * (img.astype(np.float32) - mean), 0, 255)


def _adjust_saturation(img: np.ndarray, f: float) -> np.ndarray:
    gray = (img @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
    return np.clip(gray + f * (img.astype(np.float32) - gray), 0, 255)


def _adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is None or shift == 0.0:
        return img.astype(np.float32)
    hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2HSV)
    h = hsv[..., 0].astype(np.int32) + int(round(shift * 180))
    hsv[..., 0] = np.mod(h, 180).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)


class ColorJitter:
    """torchvision-style jitter: factors ~ U[max(0,1-x), 1+x], hue ~ U[-h, h],
    ops applied in a random order."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.5 / 3.14):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        fb = rng.uniform(max(0, 1 - self.b), 1 + self.b)
        fc = rng.uniform(max(0, 1 - self.c), 1 + self.c)
        fs = rng.uniform(max(0, 1 - self.s), 1 + self.s)
        fh = rng.uniform(-self.h, self.h)
        ops = [
            lambda x: _adjust_brightness(x, fb),
            lambda x: _adjust_contrast(x, fc),
            lambda x: _adjust_saturation(x, fs),
            lambda x: _adjust_hue(x, fh),
        ]
        out = img.astype(np.float32)
        for i in rng.permutation(4):
            out = ops[i](out)
        return out.astype(np.uint8)


# -------------------------------------------------------------------- augmentors
class FlowAugmentor:
    """Dense-GT augmentor over lists of T images and T-1 flows."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=True,
                 enable_eraser=False):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo = ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14)
        self.asymmetric_color_aug_prob = 0.2
        self.enable_eraser = enable_eraser
        self.eraser_aug_prob = 0.5

    # --- photometric
    def color_transform(self, imgs, rng):
        if rng.random() < self.asymmetric_color_aug_prob:
            return [self.photo(im, rng) for im in imgs]
        stack = np.concatenate(imgs, axis=0)
        stack = self.photo(stack, rng)
        return list(np.split(stack, len(imgs), axis=0))

    def eraser_transform(self, imgs, rng, bounds=(50, 100)):
        ht, wd = imgs[0].shape[:2]
        if rng.random() < self.eraser_aug_prob:
            for idx in range(len(imgs)):
                mean_color = imgs[idx].reshape(-1, 3).mean(axis=0)
                for _ in range(rng.integers(1, 3)):
                    x0 = rng.integers(0, wd)
                    y0 = rng.integers(0, ht)
                    dx = rng.integers(bounds[0], bounds[1])
                    dy = rng.integers(bounds[0], bounds[1])
                    imgs[idx][y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return imgs

    # --- spatial
    def _pad_to_crop(self, arrs, extra_dims=1):
        ch, cw = self.crop_size
        h, w = arrs[0].shape[:2]
        pad_b, pad_r = max(0, ch - h), max(0, cw - w)
        if pad_b or pad_r:
            cfg = ((0, pad_b), (0, pad_r)) + ((0, 0),) * extra_dims
            arrs = [np.pad(a, cfg[: a.ndim]) for a in arrs]
        return arrs

    def spatial_transform(self, imgs, flows, rng):
        imgs = self._pad_to_crop(imgs)
        flows = self._pad_to_crop(flows)

        ht, wd = imgs[0].shape[:2]
        min_scale = max((self.crop_size[0] + 8) / ht, (self.crop_size[1] + 8) / wd)
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        sx, sy = max(sx, min_scale), max(sy, min_scale)

        if rng.random() < self.spatial_aug_prob:
            cv2 = _cv2()
            imgs = [cv2.resize(im, None, fx=sx, fy=sy,
                               interpolation=cv2.INTER_LINEAR) for im in imgs]
            flows = [
                cv2.resize(fl, None, fx=sx, fy=sy,
                           interpolation=cv2.INTER_LINEAR) * [sx, sy]
                for fl in flows
            ]

        if self.do_flip:
            if rng.random() < self.h_flip_prob:
                imgs = [im[:, ::-1] for im in imgs]
                flows = [fl[:, ::-1] * [-1.0, 1.0] for fl in flows]
            if rng.random() < self.v_flip_prob:
                imgs = [im[::-1] for im in imgs]
                flows = [fl[::-1] * [1.0, -1.0] for fl in flows]

        h, w = imgs[0].shape[:2]
        y0 = 0 if h == self.crop_size[0] else rng.integers(0, h - self.crop_size[0])
        x0 = 0 if w == self.crop_size[1] else rng.integers(0, w - self.crop_size[1])
        imgs = [im[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]] for im in imgs]
        flows = [fl[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]] for fl in flows]
        return imgs, flows

    def __call__(self, imgs: Sequence[np.ndarray], flows: Sequence[np.ndarray],
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        imgs = self.color_transform(list(imgs), rng)
        if self.enable_eraser:
            imgs = self.eraser_transform(imgs, rng)
        imgs, flows = self.spatial_transform(imgs, list(flows), rng)
        return ([np.ascontiguousarray(i) for i in imgs],
                [np.ascontiguousarray(f, dtype=np.float32) for f in flows])


class SparseFlowAugmentor:
    """Sparse-GT augmentor (KITTI/HD1K): symmetric-only jitter, sparse flow
    resize via point reprojection, crop margins (reference
    core/utils/augmentor.py:137-264)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.do_flip = do_flip
        self.photo = ColorJitter(0.3, 0.3, 0.3, 0.3 / 3.14)

    def color_transform(self, imgs, rng):
        stack = np.concatenate(imgs, axis=0)
        stack = self.photo(stack, rng)
        return list(np.split(stack, len(imgs), axis=0))

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        ht, wd = flow.shape[:2]
        xs, ys = np.meshgrid(np.arange(wd), np.arange(ht))
        coords = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)
        flow = flow.reshape(-1, 2).astype(np.float32)
        valid = valid.reshape(-1) >= 1

        coords1 = coords[valid] * [fx, fy]
        flow1 = flow[valid] * [fx, fy]

        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)

        flow_img = np.zeros((ht1, wd1, 2), np.float32)
        valid_img = np.zeros((ht1, wd1), np.int32)
        flow_img[yy[keep], xx[keep]] = flow1[keep]
        valid_img[yy[keep], xx[keep]] = 1
        return flow_img, valid_img

    def spatial_transform(self, imgs, flows, valids, rng):
        ch, cw = self.crop_size
        h, w = imgs[0].shape[:2]
        pad_b, pad_r = max(0, ch - h), max(0, cw - w)
        if pad_b or pad_r:
            imgs = [np.pad(im, ((0, pad_b), (0, pad_r), (0, 0))) for im in imgs]
            flows = [np.pad(fl, ((0, pad_b), (0, pad_r), (0, 0))) for fl in flows]
            valids = [np.pad(v, ((0, pad_b), (0, pad_r))) for v in valids]

        ht, wd = imgs[0].shape[:2]
        min_scale = max((ch + 1) / ht, (cw + 1) / wd)
        scale = max(2 ** rng.uniform(self.min_scale, self.max_scale), min_scale)

        if rng.random() < self.spatial_aug_prob:
            cv2 = _cv2()
            imgs = [cv2.resize(im, None, fx=scale, fy=scale,
                               interpolation=cv2.INTER_LINEAR) for im in imgs]
            new = [self.resize_sparse_flow_map(fl, v, scale, scale)
                   for fl, v in zip(flows, valids)]
            flows = [n[0] for n in new]
            valids = [n[1] for n in new]

        if self.do_flip and rng.random() < 0.5:
            imgs = [im[:, ::-1] for im in imgs]
            flows = [fl[:, ::-1] * [-1.0, 1.0] for fl in flows]
            valids = [v[:, ::-1] for v in valids]

        margin_y, margin_x = 20, 50
        y0 = rng.integers(0, imgs[0].shape[0] - ch + margin_y)
        x0 = rng.integers(-margin_x, imgs[0].shape[1] - cw + margin_x)
        y0 = int(np.clip(y0, 0, imgs[0].shape[0] - ch))
        x0 = int(np.clip(x0, 0, imgs[0].shape[1] - cw))

        imgs = [im[y0 : y0 + ch, x0 : x0 + cw] for im in imgs]
        flows = [fl[y0 : y0 + ch, x0 : x0 + cw] for fl in flows]
        valids = [v[y0 : y0 + ch, x0 : x0 + cw] for v in valids]
        return imgs, flows, valids

    def __call__(self, imgs, flows, valids, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        imgs = self.color_transform(list(imgs), rng)
        imgs, flows, valids = self.spatial_transform(
            imgs, list(flows), list(valids), rng
        )
        return (
            [np.ascontiguousarray(i) for i in imgs],
            [np.ascontiguousarray(f, dtype=np.float32) for f in flows],
            [np.ascontiguousarray(v, dtype=np.float32) for v in valids],
        )
