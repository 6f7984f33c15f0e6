"""PyTorch port, decode of interleaved streams the JAX encoder writes:
interleaved 4:4:4, 4:1:1 (both layouts) and greyscale decode to the JAX
package's pixels and coefficients (4:2:0, 4:2:2, 4:4:0 and the Huffman
phases: test_torch_interleaved_decode.py)."""

import numpy as np
import pytest

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt

from .test_torch_encode import _gradient
from .test_torch_interleaved_decode import _JDEC, _params, check_decode


def _jax(frame, samp, quality=75, rst=-1):
    return bytes(gj.Encoder().encode(frame, _params(gj, samp, quality, rst)))


STREAMS = {
    # segments that tile MCU rows (8 MCUs a row, 2 a segment)
    "444_64x48": lambda: _jax(_gradient(48, 64, 4), "444"),
    # 9 MCUs a row, segments of 4: a ragged last segment
    "444_67x41_q90_rst4": lambda: _jax(_gradient(41, 67, 5), "444", 90, 4),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_interleaved_444_decode_matches_jax(name):
    check_decode(STREAMS[name]())


@pytest.mark.parametrize("case,items", [
    ("planar_411", (6,)), ("il_411", (6,)), ("grey", (6,))])
def test_outside_the_slice_raises(case, items):
    """Non-interleaved and interleaved 4:1:1 and a greyscale stream, once
    refused as ROADMAP item 6 (done): each decodes to the JAX package's
    array and quantized coefficients (restart interval 0 is in
    tests/test_torch_foreign_decode_jax.py)."""
    frame = _gradient(32, 64, 7)
    if case == "planar_411":
        p = gj.Parameters(quality=75, restart_interval=4).chroma_subsampled(
            ((4, 1), (1, 1), (1, 1)))
    elif case == "il_411":
        p = gj.Parameters(quality=75, restart_interval=2, interleaved=True) \
            .chroma_subsampled(((4, 1), (1, 1), (1, 1)))
    else:
        frame, p = frame[..., 0], gj.Parameters(quality=75)
    data = bytes(gj.Encoder().encode(frame, p))
    ref = np.asarray(_JDEC.decode(data))
    dec = gt.Decoder(device="cpu")
    got = dec.decode(data)
    assert got.shape == ref.shape and np.array_equal(got, ref), items
    ref_c = _JDEC.decode_coefficients(data)
    got_c = dec.decode_coefficients(data)
    assert len(got_c) == len(ref_c)
    for a, b in zip(got_c, ref_c):
        assert a.shape == b.shape and np.array_equal(a, b)
