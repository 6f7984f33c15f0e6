"""PyTorch port, non-interleaved scans with subsampled chroma planes
(planar 4:2:0, 4:2:2, 4:4:0): the bytes equal the JAX package's encoder
(its megakernel path, mega_supported) on the CPU.  The decode is in
test_torch_planar_decode.py, the fused tail at dx, dy = 2 in
test_torch_planar_dpost.py (on the card: test_torch_kernels.py)."""

import pytest

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt

from .test_torch_encode import _gradient
from tests import torch_threads  # noqa: F401

SAMP = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
        "440": ((1, 2), (1, 1), (1, 1))}

#: (height, width, quality, restart interval): auto is 8 blocks a
#: segment; 41x67 and 33x40 have odd edges and ragged last segments
SIZES = {"64x64": (64, 64, 75, -1), "41x67": (41, 67, 90, 3),
         "33x40": (33, 40, 100, 2)}


def _params(mod, samp, quality, rst):
    return mod.Parameters(quality=quality,
                          restart_interval=rst).chroma_subsampled(SAMP[samp])


def _frame(size, samp):
    h, w, _, _ = SIZES[size]
    return _gradient(h, w, 20 + len(samp) + h)


@pytest.mark.parametrize("samp,size", [("420", "64x64"), ("422", "41x67"),
                                       ("440", "33x40")])
def test_planar_bytes_match_jax(samp, size):
    _, _, quality, rst = SIZES[size]
    frame = _frame(size, samp)
    ref = bytes(gj.Encoder().encode(frame, _params(gj, samp, quality, rst)))
    got = gt.Encoder(device="cpu").encode(frame,
                                          _params(gt, samp, quality, rst))
    assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"
    assert got == ref
