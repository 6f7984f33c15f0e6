"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, into a build
directory that ``.gitignore`` lists (``native.build_dir("kernels")``); all
sources compile in parallel.  A kernel's source is ``csrc/<name>.cu``
unless ``SOURCES`` names another (``relayout.cu`` holds four kernels,
``huffdec_block.cu`` two: phase C and its direct instance).  A
library's file name carries a hash of its source and of the shared
headers (``csrc/*.cuh``), so an edited kernel is rebuilt.  The libraries
are loaded with ctypes: every pointer and the stream pass as
``c_void_p``, every C function returns
``cudaGetLastError()`` after its launch, and ``launch`` raises when that
is not 0.  Nothing here runs when the module is imported, and nothing runs
on the CPU: the wrappers in prepost_kernel.py, fusedpack.py,
huffdec_kernel.py, relayout.py and models/decoder.py (the DC fix-up)
take their plain versions for CPU tensors and call ``launch`` for CUDA
tensors.  ``csrc/*.cuh`` are headers
shared between kernels (colour transform, DCT tiles, the Huffman coders'
warp bit buffer, the Huffman decoders' bit window).

``LAUNCHES`` counts kernel launches by name; ``launch`` is the one place
that adds to it.  ``probe`` launches the decomposition stages of a tiled
kernel (``PROBE_STAGES``, entry point gj_<name>_probe) for chip_smoke.py's
probe; no codec path calls it, and it counts nothing.  ``empty`` launches
an empty kernel as a row kernel of relayout.cu would be launched
(``EMPTIES``, entry point gj_<name>_empty), chip_smoke.py's floor of a
launch; it counts nothing either.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from .. import native

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: kernel name -> argtypes of its C entry point gj_<name>
_SIGNATURES: Dict[str, List] = {
    # raw, H, W, geo (host int32[16]: dx, dy, data_h, data_w a plane),
    # source (host int64[16]: the input's kind and layout), params (host
    # int32[26]), out0..3 (null past the last component), vector
    # instance, stream
    "pre_rgb_to_planes": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # plane, data_h, data_w, nblocks_out, then the output map (bpm, off,
    # sh, sv, mcux; 1, 0, 1, 1, blocks a row = raster order), mq, bias,
    # out, stream
    "fdct_quant": [_P, _I, _I, _I64, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # coefs, rows, blocks a row, nblocks, valid (null = prefix), luts0,
    # luts1, row_luma (null = all 1), bpm, luma_pat, comp_pat, markers,
    # stride, out rows, row_bytes, needs, stream
    "huffman_segments": [_P, _I64, _I, _I64, _P, _P, _P, _P, _I, _I64,
                         _I64, _P, _I, _P, _P, _P, _P],
    # bits, lens, R, T, markers, stride, rows, row_bytes, needs, stream
    "pack_stuff_rows": [_P, _P, _I64, _I, _P, _I, _P, _P, _P, _P],
    # words, nseg, W, nbits, nblocks, dc_sel, ac_sel, bpm, dc_pat, ac_pat,
    # table sets, tables, lookahead table, bps, bstart, err, stream
    "huffdec_scan": [_P, _I64, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                     _I, _P, _P, _P],
    # words, nseg, W, bstart, bps, nblocks, dc_sel, ac_sel, bpm, dc_pat,
    # ac_pat, table sets, tables, lookahead table, coefs, err, stream
    "huffdec_block": [_P, _I64, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P,
                      _P, _P, _P, _P],
    # phase C's direct instance (one block a segment): words, nseg, W,
    # nbits, nblocks, dc_sel, ac_sel, bpm, dc_pat, ac_pat, table sets,
    # tables, lookahead table, coefs, err, stream
    "huffdec_block_direct": [_P, _I64, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P],
    # coefs, L, offsets (host int64[3]), luma blocks, luma blocks per row,
    # dx, dy, H, W, bytes a pixel (3 or 4), qtabs, idct matrix, params
    # (host int32[26]), out, stream
    "dpost_rgb": [_P, _I64, _P, _I64, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                  _P, _P],
    # coefs, L, geo (host int64[2 + 6 * 4]), qtabs, idct matrix, out0..3
    # (null past the last component), stream
    "idct_planes": [_P, _I64, _P, _P, _P, _P, _P, _P, _P, _P],
    # planes 0..3 (null past the last component), geo (host int32[16]),
    # H, W, target (host int64[16]: a planar output's planes), params
    # (host int32[26]), out, stream
    "post_rgb": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    # in, H, W/4, rst, out, stream
    "xbd_relayout": [_P, _I, _I, _I, _P, _P],
    # in, R, C, out, stream
    "transpose_u32": [_P, _I, _I, _P, _P],
    # in, R, C, out, stream
    "pair_sum_rows": [_P, _I64, _I, _P, _P],
    "pack_u8_quads": [_P, _I64, _I, _P, _P],
    # DC row, nseg, bps, bpm, component pattern, components, tile sums
    # (null for short rows), tiles, stream
    "dc_fixup": [_P, _I64, _I64, _I, _I64, _I, _P, _I, _P],
}

#: kernels whose source is not csrc/<name>.cu: kernel name -> source name
SOURCES: Dict[str, str] = {name: "relayout" for name in (
    "xbd_relayout", "transpose_u32", "pair_sum_rows", "pack_u8_quads")}
SOURCES["huffdec_block_direct"] = "huffdec_block"

#: kernels with a gj_<name>_probe entry point: (stage, *the kernel's
#: arguments), stage one of PROBE_STAGES' values (csrc/tile.cuh gj::Stage)
PROBES = ("fdct_quant", "dpost_rgb", "huffman_segments", "huffdec_block",
          "pack_stuff_rows")
PROBE_STAGES = {"full": 0, "load_store": 1, "no_store": 2}

#: kernels with a gj_<name>_empty entry point: an empty kernel on the
#: grid and block that gj_<name> would launch for the same arguments
EMPTIES = ("pair_sum_rows", "pack_u8_quads")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in _SIGNATURES}

_LIBS: Dict[str, ctypes.CDLL] = {}

#: ptxas resource reports of the last build, by source name
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def source_of(name: str) -> str:
    """The source (csrc/<source>.cu) that holds kernel `name`."""
    return SOURCES.get(name, name)


def source_path(name: str) -> str:
    return os.path.join(_CSRC, f"{source_of(name)}.cu")


def nvcc() -> str:
    """Path of nvcc; raises when the CUDA toolkit is missing."""
    cands = [os.path.join(d, "bin", "nvcc")
             for d in (os.environ.get("CUDA_HOME"),
                       os.environ.get("CUDA_PATH"), "/usr/local/cuda") if d]
    found = shutil.which("nvcc")
    if found:
        cands.insert(0, found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "CUDA is present but nvcc was not found (looked on PATH, in "
        "$CUDA_HOME and in /usr/local/cuda); the port's kernels are built "
        "from csrc/ with nvcc and there is no fallback")


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source_path(name)] + sorted(
            os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
            if f.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(native.build_dir("kernels"),
                        f"lib{source_of(name)}_{digest.hexdigest()[:16]}.so")


def build(names=None) -> float:
    """Compile the source of every kernel whose library is missing, all
    nvcc processes at once; returns the seconds spent.  Raises with nvcc's
    output on a failed build."""
    first: Dict[str, str] = {}          # source -> one of its kernels
    for n in names or _SIGNATURES:
        first.setdefault(source_of(n), n)
    todo = [(src, _lib_path(n)) for src, n in first.items()
            if not os.path.exists(_lib_path(n))]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    exe = nvcc()
    procs = []
    for name, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        BUILD_LOG[name] = log
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def _lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`'s source, with the argument
    types of every kernel it holds."""
    src = source_of(name)
    lib = _LIBS.get(src)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build()
        lib = ctypes.CDLL(path)
        for kname in _SIGNATURES:
            if source_of(kname) != src:
                continue
            fn = getattr(lib, f"gj_{kname}")
            fn.argtypes = _SIGNATURES[kname]
            fn.restype = ctypes.c_int
            if kname in PROBES:
                pf = getattr(lib, f"gj_{kname}_probe")
                pf.argtypes = [_I] + _SIGNATURES[kname]
                pf.restype = ctypes.c_int
            if kname in EMPTIES:
                ef = getattr(lib, f"gj_{kname}_empty")
                ef.argtypes = _SIGNATURES[kname]
                ef.restype = ctypes.c_int
        _LIBS[src] = lib
    return lib


def _call(name: str, symbol: str, lead, args) -> None:
    fn = getattr(_lib(name), symbol)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor)
              else a.ctypes.data if isinstance(a, np.ndarray) else a
              for a in args]
    with torch.cuda.device(dev):
        err = fn(*lead, *c_args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {symbol[3:]} failed to launch: "
                           f"error {err}")


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream of the first tensor's
    device with C arguments `args` (tensors pass as device pointers, numpy
    arrays as host pointers), count it, and raise on a launch error."""
    _call(name, f"gj_{name}", (), args)
    LAUNCHES[name] += 1


def probe(name: str, stage: str, *args) -> None:
    """Launch decomposition stage `stage` (PROBE_STAGES) of kernel `name`
    with launch's arguments; not counted in LAUNCHES."""
    _call(name, f"gj_{name}_probe", (PROBE_STAGES[stage],), args)


def empty(name: str, *args) -> None:
    """Launch an empty kernel on the grid and block that kernel `name`
    (EMPTIES) takes for launch's arguments; not counted."""
    _call(name, f"gj_{name}_empty", (), args)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Check what a kernel takes: CUDA tensors, contiguous, on one
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must lie on one CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
