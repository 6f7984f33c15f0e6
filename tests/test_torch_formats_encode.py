"""PyTorch port, encode of every input pixel format on the CPU: the
bytes equal gpujpeg_tpu.Encoder().encode's, tolerance 0 — greyscale as
an (H, W) array and as a flat buffer, RGB and RGBA flat with rows padded
by width_padding bytes, UYVY with and without padding.  The planar
formats and RGBA at 4 components are in test_torch_formats_planar.py,
component counts and samplings in test_torch_formats_layouts.py, the
flip and remap options in test_torch_formats_options.py (on the card:
test_torch_kernels.py).  Each JAX geometry compiles once (5-15 s), so
each file holds a handful."""

import pytest

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt

from tests import format_cases as fc

#: at most 192 x 112 and an even width (UYVY)
HW = (48, 64)


@pytest.fixture(scope="module")
def jenc():
    return gj.Encoder()


def encode_both(jenc, kind, samp=None, interleaved=False, hw=HW, seed=0,
                options=(), rst=None):
    """(JAX bytes, port bytes) of an input kind encoded with the same
    parameters, image parameters and options on each session."""
    raw, pf, pad = fc.raw_input(kind, *hw, seed=seed)
    tenc = gt.Encoder(device="cpu")
    if options:
        jenc = gj.Encoder()
        for key, value in options:
            jenc.set_option(key, value)
            tenc.set_option(key, value)
    out = []
    for mod, enc in ((gj, jenc), (gt, tenc)):
        out.append(bytes(enc.encode(raw, fc.params(mod, samp, interleaved,
                                                   rst=rst),
                                    fc.image_params(mod, pf, *hw, pad))))
    return out


@pytest.mark.parametrize("kind", ["u8", "u8_flat", "rgb_pad", "rgba_pad",
                                  "uyvy", "uyvy_pad"])
def test_input_format_bytes_match_jax(jenc, kind):
    want, got = encode_both(jenc, kind, seed=len(kind))
    assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"
    assert got == want
