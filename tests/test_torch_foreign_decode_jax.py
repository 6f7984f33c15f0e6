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
from tests import torch_threads  # noqa: F401

_JDEC = gj.Decoder()

S420 = ((2, 2), (1, 1), (1, 1))
LAYOUTS = {"planar_444": (False, None), "planar_420": (False, S420),
           "il_444": (True, None), "il_420": (True, S420)}


def _stream(layout, rst, tables="annexk", quality=75, hw=(80, 112),
            enc=None):
    il, samp = LAYOUTS[layout]
    p = gj.Parameters(quality=quality, restart_interval=rst,
                      interleaved=il, huffman_tables=tables)
    if samp:
        p = p.chroma_subsampled(samp)
    return bytes((enc or gj.Encoder()).encode(_gradient(*hw, 5), p))


THREE_SETS = [("planar_444", 4), ("il_420", 0)]


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX package's streams and decodes, from one JAX encoder and the
    module's JAX decoder: ("annexk", layout, rst) -> (the Annex-K stream,
    its pixels, its coefficients); ("three_sets", layout, rst) -> (the
    tuned Q85 stream, its three-set rewrite's pixels)."""
    enc = gj.Encoder()
    out = {}
    for layout in LAYOUTS:
        for rst in (4, 0):
            data = _stream(layout, rst, enc=enc)
            out["annexk", layout, rst] = (
                data, np.asarray(_JDEC.decode(data)),
                [np.asarray(c) for c in _JDEC.decode_coefficients(data)])
    for layout, rst in THREE_SETS:
        base = _stream(layout, rst, tables="tuned", quality=85, hw=(48, 64),
                       enc=enc)
        out["three_sets", layout, rst] = (
            base, np.asarray(_JDEC.decode(scan_rows.three_sets(base))))
    return out


@pytest.mark.parametrize("rst", [4, 0])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_annexk_stream_matches_jax(jax_streams, layout, rst):
    """Pixels and quantized coefficients equal the JAX package's."""
    data, ref, ref_c = jax_streams["annexk", layout, rst]
    dec = gt.Decoder(device="cpu")
    got = dec.decode(data)
    assert got.shape == ref.shape and np.array_equal(got, ref)
    for a, b in zip(dec.decode_coefficients(data), ref_c):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("layout,rst", THREE_SETS)
def test_three_table_sets_match_jax(jax_streams, layout, rst):
    """A stream of three table sets decodes through the four-set plan to
    the JAX package's pixels (its legacy path) and to the unmodified
    stream's; decode_coefficients raises ValueError, as the JAX method
    does."""
    base, ref = jax_streams["three_sets", layout, rst]
    data = scan_rows.three_sets(base)
    dec = gt.Decoder(device="cpu")
    hf = dec.prepare(data)
    assert tuple(hf.plan.tables.shape) == (8, 290)
    got = dec.decode(data)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, dec.decode(base))
    with pytest.raises(ValueError):
        _JDEC.decode_coefficients(data)
    with pytest.raises(ValueError, match="table sets"):
        dec.decode_coefficients(data)
