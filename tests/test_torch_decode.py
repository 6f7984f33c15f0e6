"""PyTorch port, whole decode: Decoder(device="cpu") returns the JAX
package's pixels and coefficients on the slice's streams and on the
layouts and outputs it once refused, and contains a corrupt segment (on
the card: test_torch_kernels.py)."""

import io
import logging

import numpy as np
import pytest

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt

from .test_torch_encode import FRAMES, _gradient


def _encode(frame, quality=75, rst=gt.RESTART_AUTO):
    return gt.Encoder(device="cpu").encode(frame, gt.Parameters(
        quality=quality, restart_interval=rst))


STREAMS = dict(
    {name: (lambda f=f: _encode(f())) for name, f in FRAMES.items()},
    # auto interval at Q98: one block a segment
    q98_bps1=lambda: _encode(_gradient(48, 64, 5), quality=98),
    noise_q75_rst4=lambda: _encode(np.random.default_rng(6).integers(
        0, 256, (56, 72, 3), dtype=np.uint8), rst=4),
)

#: one JAX session for the module, as a server would keep one
_JDEC = gj.Decoder()


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_jax(name):
    """Pixels and quantized coefficients equal the JAX package's (whose
    decode_coefficients runs scan -> split -> block)."""
    data = STREAMS[name]()
    ref = np.asarray(_JDEC.decode(data))
    dec = gt.Decoder(device="cpu")
    got = dec.decode(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    ref_c = _JDEC.decode_coefficients(data)
    got_c = dec.decode_coefficients(data)
    assert len(got_c) == len(ref_c) == 3
    for a, b in zip(got_c, ref_c):
        assert a.dtype == np.int16 and a.shape == b.shape
        assert np.array_equal(a, b)


def test_port_round_trip_q90():
    """Port encoder -> port decoder, as test_encode_decodes_with_pil."""
    frame = _gradient(120, 160, 4)
    out = gt.Decoder(device="cpu").decode(_encode(frame, quality=90))
    mse = np.mean((frame.astype(float) - out.astype(float)) ** 2)
    assert 10 * np.log10(255 ** 2 / mse) > 30


def _refused(kind):
    """A stream the port refused before it took every layout: PIL's
    greyscale, 4:1:1 (non-interleaved and interleaved) and four
    components, written by the port's encoder (the JAX package's bytes:
    tests/test_torch_formats_layouts.py and _planar.py hold them equal;
    the port's CPU encode takes a tenth of a second where a cold JAX
    encode compiles for ten)."""
    frame = _gradient(48, 64, 2)
    p = gt.Parameters(quality=75, restart_interval=4)
    s411 = ((4, 1), (1, 1), (1, 1))
    if kind == "pil_grey":
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(frame[..., 0]).save(buf, "JPEG", quality=75)
        return buf.getvalue()
    if kind == "planar_411":
        p = p.chroma_subsampled(s411)
    elif kind == "il_411":
        p = p.with_(interleaved=True).chroma_subsampled(s411)
    else:
        frame = np.concatenate([frame, frame[..., :1]], axis=2)
    return gt.Encoder(device="cpu").encode(frame, p)


@pytest.mark.parametrize("kind,items", [
    ("pil_grey", (6,)), ("planar_411", (6,)), ("il_411", (6,)),
    ("four_components", (6,))])
def test_outside_the_slice_raises(kind, items):
    """Streams once outside the slice (they named ROADMAP item 6, now
    done): each decodes to the JAX package's array, shape and pixels
    (greyscale to (H, W), four components to (H, W, 4))."""
    data = _refused(kind)
    ref = np.asarray(_JDEC.decode(data))
    got = gt.Decoder(device="cpu").decode(data)
    assert got.shape == ref.shape and np.array_equal(got, ref), items


def test_unported_output_raises(monkeypatch):
    """A planar output of a greyscale stream gives the JAX package's flat
    buffer; the RLE TGA option (item 11, ported) sets the file writer's
    flag as the JAX option does; a JAX ImageParameters is accepted as
    param_image."""
    data = STREAMS["grey"]()
    dec = gt.Decoder(device="cpu")
    got = dec.decode(data, gt.ImageParameters(
        pixel_format=gt.PixelFormat.P444_U8_P0P1P2))
    ref = np.asarray(_JDEC.decode(data, gj.ImageParameters(
        pixel_format=gj.PixelFormat.P444_U8_P0P1P2)))
    assert got.shape == ref.shape and np.array_equal(got, ref)
    from gpujpeg_tpu.io import image as jio
    from gpujpeg_tpu_torch.io import image as tio

    monkeypatch.setattr(jio, "TGA_RLE", True)
    monkeypatch.setattr(tio, "TGA_RLE", True)
    dec.set_option("dec_opt_tga_rle", "false")
    _JDEC.set_option("dec_opt_tga_rle", "false")
    assert tio.TGA_RLE is jio.TGA_RLE is False
    # a JAX ImageParameters is accepted as param_image
    got = dec.decode(data, gj.ImageParameters(
        color_space=gj.ColorSpace.RGB,
        pixel_format=gj.PixelFormat.P444_U8_P012))
    ref = np.asarray(_JDEC.decode(data, gj.ImageParameters(
        color_space=gj.ColorSpace.RGB,
        pixel_format=gj.PixelFormat.P444_U8_P012)))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("request_kind", ["none_autodetect", "rgb_p444"])
def test_set_output_format_matches_jax(request_kind):
    """After set_output_format with the default request or RGB
    P444_U8_P012, a decode equals the JAX decoder's after the same call."""
    from gpujpeg_tpu.types import PixelFormatRequest as JRequest
    from gpujpeg_tpu_torch.types import PixelFormatRequest as TRequest

    data = _encode(_gradient(40, 56, 8))
    jdec, dec = gj.Decoder(), gt.Decoder(device="cpu")
    if request_kind == "none_autodetect":
        jdec.set_output_format(gj.ColorSpace.NONE, JRequest.AUTODETECT)
        dec.set_output_format(gt.ColorSpace.NONE, TRequest.AUTODETECT)
    else:
        jdec.set_output_format(gj.ColorSpace.RGB,
                               gj.PixelFormat.P444_U8_P012)
        dec.set_output_format(gt.ColorSpace.RGB, gt.PixelFormat.P444_U8_P012)
    ref = np.asarray(jdec.decode(data))
    got = dec.decode(data)
    assert got.shape == ref.shape and np.array_equal(got, ref)


@pytest.mark.parametrize("fmt", ["P444_U8_P0P1P2", "P4444_U8_P0123"])
def test_set_output_format_other_format_raises(fmt):
    """A request for another pixel format (once refused as item 6) gives
    the JAX decoder's array after the same set_output_format call; a
    param_image passed to decode still takes precedence."""
    data = STREAMS["grey"]()
    jdec, dec = gj.Decoder(), gt.Decoder(device="cpu")
    jdec.set_output_format(gj.ColorSpace.RGB, gj.PixelFormat[fmt])
    dec.set_output_format(gt.ColorSpace.RGB, gt.PixelFormat[fmt])
    ref = np.asarray(jdec.decode(data))
    got = dec.decode(data)
    assert got.shape == ref.shape and np.array_equal(got, ref)
    got = dec.decode(data, gt.ImageParameters(
        pixel_format=gt.PixelFormat.P444_U8_P012))
    assert np.array_equal(got, gt.Decoder(device="cpu").decode(
        data, gt.ImageParameters(pixel_format=gt.PixelFormat.P444_U8_P012)))


def test_corrupt_stream_is_contained(caplog):
    """A damaged segment logs the warning on the port's logger; block rows
    outside it decode as before (template: tests/test_dec_kernel.py)."""
    from gpujpeg_tpu_torch.stream import reader

    data = _encode(_gradient(64, 80, 7), rst=4)
    segs = reader.parse(data).scans[0].segments
    ref = gt.Decoder(device="cpu").decode(data)
    k = len(segs) // 2
    for pos in range(int(segs[k][0]) + 1, int(segs[k][1])):
        bad = bytearray(data)
        if 0xFF in (bad[pos - 1], bad[pos], bad[pos] ^ 0x5A):
            continue
        bad[pos] ^= 0x5A
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="gpujpeg_tpu_torch"):
            out = gt.Decoder(device="cpu").decode(bytes(bad))
        if any("corrupt segment" in r.message for r in caplog.records):
            break
    else:
        pytest.fail("no detectable single-byte damage")
    assert out.shape == ref.shape
    # the damaged luma segment k covers 4 blocks of block row k * 4 // 10
    rows_bad = np.nonzero((out != ref).any(axis=(1, 2)))[0]
    assert len(rows_bad) and rows_bad.min() >= 8 * (k * 4 // 10)
    assert rows_bad.max() < 8 * ((k * 4 + 3) // 10 + 1)
    assert np.array_equal(out, np.asarray(_JDEC.decode(bytes(bad))))
