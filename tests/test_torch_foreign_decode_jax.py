"""PyTorch port, decode of the JAX package's foreign-table streams: Annex-K
tables at restart interval 4 and 0 in the four layouts of the port
(planar 4:4:4 and 4:2:0, interleaved 4:4:4 and 4:2:0), and streams of
three Huffman table sets (tests/test_legacy_decode.py's rewrite: a copy
of the chroma AC table under id 2, component 3 pointed at it), which the
JAX package decodes on its legacy path and the port with its four-set
kernel instances.  Pixels equal the JAX package's exactly, coefficients
wherever the JAX method returns them."""

import numpy as np
import pytest

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt

from tests import scan_rows

from .test_torch_encode import _gradient

_JDEC = gj.Decoder()

S420 = ((2, 2), (1, 1), (1, 1))
LAYOUTS = {"planar_444": (False, None), "planar_420": (False, S420),
           "il_444": (True, None), "il_420": (True, S420)}


def _stream(layout, rst, tables="annexk", quality=75, hw=(80, 112)):
    il, samp = LAYOUTS[layout]
    p = gj.Parameters(quality=quality, restart_interval=rst,
                      interleaved=il, huffman_tables=tables)
    if samp:
        p = p.chroma_subsampled(samp)
    return bytes(gj.Encoder().encode(_gradient(*hw, 5), p))


@pytest.mark.parametrize("rst", [4, 0])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_annexk_stream_matches_jax(layout, rst):
    """Pixels and quantized coefficients equal the JAX package's."""
    data = _stream(layout, rst)
    dec = gt.Decoder(device="cpu")
    got = dec.decode(data)
    ref = np.asarray(_JDEC.decode(data))
    assert got.shape == ref.shape and np.array_equal(got, ref)
    for a, b in zip(dec.decode_coefficients(data),
                    _JDEC.decode_coefficients(data)):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("layout,rst", [("planar_444", 4), ("il_420", 0)])
def test_three_table_sets_match_jax(layout, rst):
    """A stream of three table sets decodes through the four-set plan to
    the JAX package's pixels (its legacy path) and to the unmodified
    stream's; decode_coefficients raises ValueError, as the JAX method
    does."""
    base = _stream(layout, rst, tables="tuned", quality=85, hw=(48, 64))
    data = scan_rows.three_sets(base)
    dec = gt.Decoder(device="cpu")
    hf = dec.prepare(data)
    assert tuple(hf.plan.tables.shape) == (8, 290)
    got = dec.decode(data)
    assert np.array_equal(got, np.asarray(_JDEC.decode(data)))
    assert np.array_equal(got, dec.decode(base))
    with pytest.raises(ValueError):
        _JDEC.decode_coefficients(data)
    with pytest.raises(ValueError, match="table sets"):
        dec.decode_coefficients(data)
