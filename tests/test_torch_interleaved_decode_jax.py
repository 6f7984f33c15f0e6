"""PyTorch port, decode of interleaved streams the JAX encoder writes:
interleaved 4:4:4 decodes to the JAX package's pixels and coefficients;
what the slice does not decode raises, naming its ROADMAP items (4:2:0,
4:2:2, 4:4:0 and the Huffman phases: test_torch_interleaved_decode.py)."""

import re

import numpy as np
import pytest

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt

from .test_torch_encode import _gradient
from .test_torch_interleaved_decode import _params, check_decode


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
    """Non-interleaved and interleaved 4:1:1 and a greyscale stream raise,
    naming their ROADMAP items (restart interval 0 is ported:
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
    with pytest.raises(NotImplementedError) as e:
        gt.Decoder(device="cpu").decode(data)
    named = {int(m) for m in re.findall(r"item (\d+)", str(e.value))}
    assert named == set(items), str(e.value)
