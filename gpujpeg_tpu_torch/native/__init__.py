"""Native C++ host runtime (ctypes-bound; numpy fallback when unavailable).

A copy of gpujpeg_tpu.native for the port, trimmed to what the encode path
calls: ``assemble_rows``.  ``stream.cpp`` is the JAX package's source as it
is; it builds into the port's own directory under its own library name, so
the two packages never load each other's shared object.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def build_dir(name: str) -> str:
    """Directory for the port's build outputs (native host library, CUDA
    kernels): ``GPUJPEG_TPU_TORCH_BUILD`` or ``_build/`` inside the
    package, one subdirectory per kind."""
    root = os.environ.get("GPUJPEG_TPU_TORCH_BUILD") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "_build")
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    return d


def _ensure_built() -> Optional[str]:
    src = os.path.join(os.path.dirname(__file__), "stream.cpp")
    out = os.path.join(build_dir("native"), "libgpujpeg_tpu_torch_native.so")
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp]
    try:
        subprocess.run(cmd + ["-fopenmp", "-march=native"],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
    os.replace(tmp, out)
    return out


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (the numpy fallback engages)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _ensure_built()
    if path is None:
        return None
    try:
        L = ctypes.CDLL(path)
        L.gj_assemble_rows.restype = None
        L.gj_assemble_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _LIB = L
    except OSError:
        _LIB = None
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def assemble_rows(rows_bytes: np.ndarray, row_bytes: np.ndarray) -> bytes:
    """Compact (nseg, stride) uint8 rows into one contiguous byte string."""
    nseg, stride = rows_bytes.shape
    row_bytes = np.ascontiguousarray(row_bytes, np.int32)
    if nseg and int(row_bytes.max()) > stride:
        raise ValueError("row_bytes exceeds the row stride")
    offsets = np.zeros(nseg, np.int64)
    np.cumsum(row_bytes[:-1], out=offsets[1:])
    total = int(offsets[-1] + row_bytes[-1]) if nseg else 0
    L = lib()
    if L is None:
        mask = (np.arange(stride)[None, :] < row_bytes[:, None])
        return rows_bytes[mask].tobytes()
    out = np.empty(total, np.uint8)
    rows_bytes = np.ascontiguousarray(rows_bytes)
    L.gj_assemble_rows(_ptr(rows_bytes), nseg, stride, _ptr(row_bytes),
                       _ptr(offsets), _ptr(out))
    return out.tobytes()
