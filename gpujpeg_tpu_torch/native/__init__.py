"""Native C++ host runtime (ctypes-bound; numpy fallback when unavailable).

A copy of gpujpeg_tpu.native for the port, trimmed to what the encode and
decode paths call: ``assemble_rows`` and ``pack_tokens`` (encode; the
latter packs the scans of restart interval 0), ``scan_split``,
``parse_offsets`` (stream/reader.py), ``unstuff_rows``
(stream/segments.py) and ``lcg_fill`` (io/tst.py's random pattern).  ``stream.cpp`` is the JAX package's source as it
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
        L.gj_scan_split.restype = ctypes.c_int64
        L.gj_scan_split.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        L.gj_unstuff_rows.restype = None
        L.gj_unstuff_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]
        L.gj_parse_offsets.restype = ctypes.c_int64
        L.gj_parse_offsets.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        L.gj_pack_tokens.restype = ctypes.c_int64
        L.gj_pack_tokens.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]
        L.gj_lcg_fill.restype = None
        L.gj_lcg_fill.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_uint32]
        _LIB = L
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return lib() is not None


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


def scan_split(data: np.ndarray, start: int, max_segments: int):
    """Split scan entropy data at RST markers (native memchr loop).

    Returns (segments (n, 2) int64 [abs_start, abs_end) rows, end_pos,
    bad_markers) or None when the native library is unavailable."""
    L = lib()
    if L is None:
        return None
    data = np.ascontiguousarray(data)
    sub = data[start:]
    starts = np.zeros(max_segments, np.int64)
    ends = np.zeros(max_segments, np.int64)
    end_pos = ctypes.c_int64(0)
    bad = ctypes.c_int64(0)
    n = L.gj_scan_split(_ptr(sub), len(sub), _ptr(starts), _ptr(ends),
                        max_segments, ctypes.byref(end_pos),
                        ctypes.byref(bad))
    segs = np.stack([starts[:n], ends[:n]], axis=1) + start
    return segs, int(end_pos.value) + start, int(bad.value)


def unstuff_rows(data: np.ndarray, ranges, row_words: int, out=None):
    """Unstuff segments into a (nseg, row_words) u32 matrix of host-order
    words (stream byte k is byte k of the row).

    ranges: (nseg, 2) int64 [start, end) rows (or a list of pairs), or a
    (starts, ends) tuple of contiguous int64 1-D arrays (the copy-free
    form ScanInfo.segment_bounds produces).
    out: optional (nseg, row_words * 4) uint8 C-contiguous buffer that the
    matrix is written into (the decoder session's reused buffer); a fresh
    one is allocated when it is missing or of another shape.
    Row bytes past the payload are not zeroed: the decode kernels gate
    every bit they commit by the segment's bit count, so the tail is never
    decoded into a result.
    Returns (words, nbits) or None when the native library is missing."""
    L = lib()
    if L is None:
        return None
    if isinstance(ranges, tuple):
        starts, ends = ranges
        starts = np.ascontiguousarray(starts, np.int64)
        ends = np.ascontiguousarray(ends, np.int64)
        nseg = len(starts)
    else:
        r = np.asarray(ranges, np.int64).reshape(-1, 2)
        nseg = len(r)
        starts = np.ascontiguousarray(r[:, 0])
        ends = np.ascontiguousarray(r[:, 1])
    mat = out if _fits(out, (nseg, row_words * 4)) \
        else np.empty((nseg, row_words * 4), np.uint8)
    out_bytes = np.zeros(nseg, np.int32)
    data = np.ascontiguousarray(data)
    L.gj_unstuff_rows(_ptr(data), nseg, _ptr(starts), _ptr(ends),
                      _ptr(mat), row_words, _ptr(out_bytes), 0)
    return mat.view(np.uint32), (out_bytes * 8).astype(np.int32)


def _fits(out, shape) -> bool:
    """out is a C-contiguous uint8 array of this shape."""
    return (out is not None and out.shape == shape
            and out.dtype == np.uint8 and out.flags.c_contiguous)


def parse_offsets(data: np.ndarray, chunks, base: int):
    """Decode APP13 segment-info chunks (list of (offset, byte_len) into
    `data`) to absolute int64 positions + monotonicity flag: (offsets,
    bad) or None when the native library is unavailable or a chunk is
    malformed."""
    L = lib()
    if L is None or not chunks:
        return None
    offs = np.ascontiguousarray([c[0] for c in chunks], np.int64)
    lens = np.ascontiguousarray([c[1] for c in chunks], np.int64)
    if (lens % 4).any():
        return None
    total = int(lens.sum()) // 4
    out = np.empty(total, np.int64)
    bad = ctypes.c_int64(0)
    data = np.ascontiguousarray(data)
    n = L.gj_parse_offsets(_ptr(data), len(offs), _ptr(offs), _ptr(lens),
                           base, _ptr(out), ctypes.byref(bad))
    if n < 0:
        return None
    return out, int(bad.value)


def pack_tokens(bits: np.ndarray, lens: np.ndarray) -> bytes:
    """Sequentially pack (right-aligned codeword, bit length) token arrays
    into a stuffed, F.1.2.3-padded byte string: the restart_interval == 0
    entropy coder (counterpart of gpujpeg_huffman_cpu_encoder.c:72-107).
    Zero-length slots are padding and are skipped."""
    bits = np.ascontiguousarray(bits.reshape(-1), np.uint32)
    lens = np.ascontiguousarray(lens.reshape(-1), np.int32)
    L = lib()
    if L is not None:
        cap = int(lens[lens > 0].sum()) // 8 * 2 + 16
        out = np.empty(cap, np.uint8)
        n = L.gj_pack_tokens(_ptr(bits), _ptr(lens), len(bits),
                             _ptr(out), cap)
        if n < 0:
            raise RuntimeError("pack_tokens capacity overflow")
        return out[:n].tobytes()
    # pure-Python fallback (correct, slow; small images only)
    acc = 0
    nb = 0
    out = bytearray()
    for b, l in zip(bits.tolist(), lens.tolist()):
        if l <= 0:
            continue
        acc = (acc << l) | (b & ((1 << l) - 1))
        nb += l
        while nb >= 8:
            byte = (acc >> (nb - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nb -= 8
        acc &= (1 << nb) - 1
    if nb:
        byte = ((acc << (8 - nb)) | ((1 << (8 - nb)) - 1)) & 0xFF
        out.append(byte)
        if byte == 0xFF:
            out.append(0)
    return bytes(out)


def lcg_fill(n: int, seed: int) -> np.ndarray:
    """n bytes of the reference's deterministic LCG test pattern
    (image_delegate.c:560-582), the .tst "random" pattern; io.tst.lcg_bytes
    (numpy) when the library is unavailable, as in gpujpeg_tpu.native."""
    L = lib()
    out = np.empty(n, np.uint8)
    if L is None:
        from ..io.tst import lcg_bytes

        return lcg_bytes(n, seed)
    L.gj_lcg_fill(_ptr(out), n, seed & 0xFFFFFFFF)
    return out
