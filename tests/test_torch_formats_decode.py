"""PyTorch port, decode to every output pixel format and pseudo request
on the CPU: the arrays equal gpujpeg_tpu.Decoder().decode's, tolerance 0
and the same shape ((H, W) for U8, (H, W, C) interleaved, flat for UYVY
and the planar formats) — greyscale and 4-component streams here; 4:4:4
and planar 4:2:0 streams in test_torch_formats_decode_rgb.py,
interleaved 4:2:2 and PIL greyscale streams in
test_torch_formats_decode_options.py with the row alignment, flip and
remap options (on the card: test_torch_kernels.py).  The streams come from the port's encoder, whose
bytes are the JAX package's (test_torch_formats_encode.py)."""

import numpy as np
import pytest

import gpujpeg_tpu as gj
from gpujpeg_tpu.types import PixelFormatRequest as JRequest

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.types import PixelFormatRequest as TRequest

from tests import format_cases as fc
from tests import torch_threads  # noqa: F401

#: every request: the seven formats, then the pseudo formats
REQUESTS = fc.OUTPUTS + [r.name for r in TRequest]

#: stream name -> (input kind, sampling, interleaved)
STREAMS = {"grey": ("u8", None, False), "rgba": ("rgba", None, False)}

#: JAX sessions by their options, one a module: a session keeps its
#: plans and compiled programs
_JDECS = {}


def make_stream(kind, samp=None, interleaved=False, hw=(48, 64), seed=0):
    raw, pf, pad = fc.raw_input(kind, *hw, seed=seed)
    return gt.Encoder(device="cpu").encode(
        raw, fc.params(gt, samp, interleaved, rst=4),
        fc.image_params(gt, pf, *hw, pad))


def request(mod, name, cs="RGB"):
    """mod.ImageParameters asking for a format or a pseudo format."""
    pf = (getattr(mod.PixelFormat, name, None)
          or (JRequest if mod is gj else TRequest)[name])
    return mod.ImageParameters(color_space=mod.ColorSpace[cs],
                               pixel_format=pf)


def decode_both(data, name, options=(), cs="RGB"):
    """(JAX array, port array) of a stream decoded to a request with the
    same options set on each session."""
    jdec = _JDECS.get(tuple(options))
    if jdec is None:
        jdec = _JDECS[tuple(options)] = gj.Decoder()
        for key, value in options:
            jdec.set_option(key, value)
    tdec = gt.Decoder(device="cpu")
    for key, value in options:
        tdec.set_option(key, value)
    out = []
    for mod, dec in ((gj, jdec), (gt, tdec)):
        out.append(np.asarray(dec.decode(data, request(mod, name, cs))))
    return out


@pytest.fixture(scope="module")
def streams():
    return {k: make_stream(*v, seed=len(k)) for k, v in STREAMS.items()}


@pytest.mark.parametrize("name", REQUESTS)
@pytest.mark.parametrize("stream", list(STREAMS))
def test_output_format_matches_jax(streams, stream, name):
    want, got = decode_both(streams[stream], name)
    assert got.dtype == np.uint8
    assert got.shape == want.shape and np.array_equal(got, want)
