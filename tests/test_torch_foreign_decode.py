"""PyTorch port, decode of the streams other encoders write: libjpeg's
(through PIL) at 4:4:4 and 4:2:0, one interleaved scan, with the standard
(Annex K) and with optimised Huffman tables, with restart markers and
without (restart interval 0: a scan is one segment).  Decoder(device=
"cpu") must give the JAX package's pixels and quantized coefficients
exactly (on the card: tests/test_torch_kernels.py, chip_smoke.py)."""

import io

import numpy as np
import pytest

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt

from .test_torch_encode import _gradient
from tests import torch_threads  # noqa: F401

#: one JAX session for the module, as a server would keep one
_JDEC = gj.Decoder()


def _pil(subsampling: int, restart: bool, optimize: bool) -> bytes:
    """A libjpeg stream of a 128x96 frame at Q75."""
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    kw = {"restart_marker_blocks": 8} if restart else {}
    Image.fromarray(_gradient(96, 128, 1)).save(
        buf, "JPEG", quality=75, subsampling=subsampling, optimize=optimize,
        **kw)
    return buf.getvalue()


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("tables", ["standard", "optimised"])
@pytest.mark.parametrize("restart", ["rst8", "rst0"])
def test_pil_stream_matches_jax(sampling, tables, restart):
    """Pixels and quantized coefficients equal the JAX package's."""
    data = _pil(0 if sampling == "444" else 2, restart == "rst8",
                tables == "optimised")
    dec = gt.Decoder(device="cpu")
    hf = dec.prepare(data)
    assert (hf.words.shape[0] == 1) == (restart == "rst0")
    got = dec.decode(data)
    ref = np.asarray(_JDEC.decode(data))
    assert got.shape == ref.shape == (96, 128, 3)
    assert np.array_equal(got, ref)
    for a, b in zip(dec.decode_coefficients(data),
                    _JDEC.decode_coefficients(data)):
        assert a.shape == b.shape and np.array_equal(a, b)
