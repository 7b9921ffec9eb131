"""Native IO runtime of the port (counterpart of streamflow_tpu/runtime):
ctypes bindings over ``libsfio``, built from the port's own ``sfio.cpp``.

The library is compiled with ``g++`` at first use into
``build/streamflow_tpu_torch/`` (the kernels' build directory, ignored by
git), under a name that carries the source's content hash, so an edited
source is rebuilt; the compiler writes a temporary file that is renamed
into place, so processes that build at once do not clash.

Nothing falls back. Where JAX's runtime returns ``None`` on a failed
build or a rejected file and its ``read_flo`` then decodes in NumPy, here
a failed build raises ``RuntimeError`` with the compiler's message, and a
file the decoder rejects raises ``ValueError`` (``OSError`` when it cannot
be read) naming the file and the reason. The NumPy codecs of
``data/frame_utils.py`` decode the same formats; the tests hold the two
equal bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "sfio.cpp"
_BUILD = _HERE.parent.parent / "build" / "streamflow_tpu_torch"
_LOCK = threading.Lock()
_LIB = None

_I32P = ctypes.POINTER(ctypes.c_int32)
# the return codes of sfio.cpp
_REASONS = {1: "cannot be opened or read",
            2: "is shorter than its header says",
            3: {"flo": "has a bad .flo magic",
                "ppm": "is not a binary P6 PPM"},
            4: "has a bad size (or a PPM maxval other than 255)",
            5: "differs in size from the batch's first file"}


def _compile() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libsfio_{digest}.so"
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", str(_SRC), "-o",
           str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:      # no g++ on this machine
        raise RuntimeError(f"building libsfio: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building libsfio failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if this source has no build yet."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_compile()))
            lib.sfio_flo_header.argtypes = [ctypes.c_char_p, _I32P, _I32P]
            lib.sfio_read_flo.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32, ctypes.c_int32]
            lib.sfio_read_flo_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int)]
            lib.sfio_ppm_header.argtypes = [ctypes.c_char_p, _I32P, _I32P]
            lib.sfio_read_ppm.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32, ctypes.c_int32]
            for fn in (lib.sfio_flo_header, lib.sfio_read_flo,
                       lib.sfio_read_flo_batch, lib.sfio_ppm_header,
                       lib.sfio_read_ppm):
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _check(rc: int, path, kind: str) -> None:
    """Raise for a non-zero return code of sfio.cpp on ``path`` (a
    ``kind`` file: "flo" or "ppm")."""
    if rc == 0:
        return
    reason = _REASONS.get(rc, f"gave code {rc}")
    if isinstance(reason, dict):
        reason = reason[kind]
    raise (OSError if rc == 1 else ValueError)(
        f"{path}: the .{kind} decoder refused it: the file {reason}")


def _header(fn, path, kind: str) -> tuple:
    w, h = ctypes.c_int32(), ctypes.c_int32()
    _check(fn(str(path).encode(), ctypes.byref(w), ctypes.byref(h)), path,
           kind)
    return h.value, w.value


def read_flo_native(path) -> np.ndarray:
    """A Middlebury .flo as (H, W, 2) float32."""
    lib = get_lib()
    h, w = _header(lib.sfio_flo_header, path, "flo")
    out = np.empty((h, w, 2), np.float32)
    _check(lib.sfio_read_flo(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h), path,
        "flo")
    return out


def read_flo_batch_native(paths: Sequence) -> np.ndarray:
    """N same-sized .flo files decoded in parallel on the library's thread
    pool, as (N, H, W, 2) float32; the size is the first file's."""
    paths: List = list(paths)
    if not paths:
        raise ValueError("read_flo_batch_native: no paths")
    lib = get_lib()
    h, w = _header(lib.sfio_flo_header, paths[0], "flo")
    out = np.empty((len(paths), h, w, 2), np.float32)
    names = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    codes = (ctypes.c_int * len(paths))()
    lib.sfio_read_flo_batch(
        names, len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h, codes)
    for p, rc in zip(paths, codes):
        _check(rc, p, "flo")
    return out


def read_ppm_native(path) -> np.ndarray:
    """A binary PPM (P6, maxval 255) as (H, W, 3) uint8."""
    lib = get_lib()
    h, w = _header(lib.sfio_ppm_header, path, "ppm")
    out = np.empty((h, w, 3), np.uint8)
    _check(lib.sfio_read_ppm(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h), path,
        "ppm")
    return out
