"""File-format codecs for optical-flow datasets (reference
core/utils/frame_utils.py:13-160): Middlebury .flo, PFM, KITTI 16-bit png,
Spring .flo5 (HDF5), and the extension-dispatching reader.

Host-side by design: these feed the input pipeline, not the device. The
port's own copy of streamflow_tpu/data/frame_utils.py. Which decoder runs:

- ``.flo`` (``read_flo``, and ``read_gen`` of a ``.flo``): always the
  native runtime (``streamflow_tpu_torch.runtime``, C++ built with g++ at
  first use), as JAX's ``read_flo`` tries first. Unlike JAX's, it does not
  fall back: a failed build or a file the decoder rejects raises.
  ``read_flo_numpy`` is the NumPy decoder that JAX falls back to, kept as
  the plain version the tests hold the native one against.
- ``.ppm`` (``read_gen`` and ``read_image``; FlyingChairs' frames): the
  native runtime, so these frames load where PIL is absent. Other images
  (``.png``, ``.jpg``, ``.jpeg``) open with PIL.
- PFM in NumPy; KITTI's png with cv2; ``.flo5`` with h5py.

PIL, cv2 and h5py are imported where a reader or writer needs them.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np

FLO_MAGIC = 202021.25  # Middlebury sanity-check magic number


# --------------------------------------------------------------------------- .flo
def read_flo(path) -> np.ndarray:
    """A .flo file as (H, W, 2) float32, through the native decoder."""
    from streamflow_tpu_torch import runtime

    return runtime.read_flo_native(path)


def read_flo_numpy(path) -> np.ndarray:
    """The NumPy .flo decoder (JAX's fallback path)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != FLO_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path, flow: np.ndarray):
    flow = np.asarray(flow, dtype=np.float32)
    assert flow.ndim == 3 and flow.shape[2] == 2
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.tofile(f)


# --------------------------------------------------------------------------- PFM
def read_pfm(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape))


def write_pfm(path, image: np.ndarray, scale: float = 1.0):
    image = np.asarray(image)
    if image.dtype.name != "float32":
        raise ValueError("PFM requires float32")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("image must be HxWx3, HxW or HxWx1")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


# ------------------------------------------------------------------- KITTI png
def read_flow_kitti(path):
    """KITTI 16-bit png: flow = (uint16 - 2^15) / 64, channel 3 = valid
    (reference core/utils/frame_utils.py:118-128)."""
    import cv2

    raw = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)  # BGR -> RGB channel order
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2 ** 15) / 64.0
    return flow, valid


def write_flow_kitti(path, flow: np.ndarray):
    import cv2

    flow = 64.0 * np.asarray(flow, np.float32) + 2 ** 15
    valid = np.ones((*flow.shape[:2], 1), dtype=flow.dtype)
    out = np.concatenate([flow, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(str(path), out[..., ::-1])


# ----------------------------------------------------------------- Spring flo5
def read_flo5(path) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        if "flow" not in f:
            raise ValueError(f"{path}: missing 'flow' dataset")
        return f["flow"][()]


def write_flo5(path, flow: np.ndarray):
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("flow", data=flow, compression="gzip", compression_opts=5)


# ------------------------------------------------------------------- dispatch
def read_gen(path, pil: bool = False):
    """Extension-dispatching reader (reference frame_utils.py:144-160): a
    ``.ppm`` as an (H, W, 3) uint8 array through the native decoder; other
    images as PIL images."""
    ext = Path(path).suffix.lower()
    if ext == ".ppm":
        from streamflow_tpu_torch import runtime

        return runtime.read_ppm_native(path)
    if ext in (".png", ".jpeg", ".jpg"):
        from PIL import Image

        return Image.open(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(path).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    if ext == ".flo5":
        return read_flo5(path)
    return []


def read_image(path) -> np.ndarray:
    """Image as (H, W, 3) uint8 (grayscale broadcast to 3 channels); a
    ``.ppm`` through the native decoder, others through PIL."""
    if Path(path).suffix.lower() == ".ppm":
        return read_gen(path)
    from PIL import Image

    img = np.asarray(Image.open(path)).astype(np.uint8)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return img[..., :3]
