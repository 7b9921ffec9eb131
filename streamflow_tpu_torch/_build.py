"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` into ONE shared library with
a plain C interface (no PyTorch headers: seconds to build, not minutes),
loaded with ``ctypes``. The build runs at first use, from the repository's
own sources, into ``build/streamflow_tpu_torch/`` (ignored by git), and is
redone whenever the sources' content hash changes.

Every exported launcher takes device pointers and the CUDA stream as
``c_void_p`` plus ``c_int``/``c_float`` scalars, and returns the
``cudaGetLastError()`` code of its launch; :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "streamflow_tpu_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# launcher name -> argument types (pointers, ints, floats, then the stream)
_SIGNATURES = {
    "sf_corr_lookup": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "sf_ffn_pair": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _P],
    "sf_flash_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sf_lga_attn": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
}

_lib = None
build_seconds = None


def _sources():
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def _digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library():
    """Compile (if the sources changed) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    _BUILD.mkdir(parents=True, exist_ok=True)
    so = _BUILD / f"libsf_kernels_{_digest()}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp)]
        cmd += [str(p) for p in _sources() if p.suffix == ".cu"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        (_BUILD / "ptxas.log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr[-6000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {code}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    return None if t is None else t.data_ptr()


def dtype_code(dtype) -> int:
    """io-type code of the C launchers (see csrc/common.cuh)."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def require(t, name: str, dtype=None, ndim=None) -> None:
    """Wrapper-side checks of what a kernel takes: a contiguous CUDA tensor
    of the given dtype and rank."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")


def ptxas_summary() -> str:
    """Registers, shared memory and spills per kernel, from the last
    build's ``nvcc -Xptxas -v`` output."""
    log = _BUILD / "ptxas.log"
    if not log.exists():
        return "ptxas: no log (library was already built)"
    lines, fn = [], None
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
        elif "Used" in ln and "registers" in ln and fn:
            lines.append(f"{fn[:60]}: {ln.split('info    :')[-1].strip()}")
        elif "spill" in ln and ("bytes spill stores" in ln) and fn:
            stores = ln.split("bytes stack frame,")[-1].strip()
            lines.append(f"{fn[:60]}: {stores}")
    return "ptxas:\n  " + "\n  ".join(lines)
