"""PyTorch port, the session surface against the JAX package on the CPU:
encode_pipelined's bytes, decode_pipelined's and the device-only
decode's pixels, pack_stream's arrays, warm-up, pre-allocation and the
memory planners (the JAX package's tests/test_encode.py,
tests/test_decode.py and tests/test_dec_kernel.py cases of the same
methods).  Frames of 48x64 (one of 32x48), seeded with numpy."""

import numpy as np
import pytest

import gpujpeg_tpu as gj
from gpujpeg_tpu.models import decoder as jdec
from gpujpeg_tpu.stream import reader as jreader
from gpujpeg_tpu.utils.geometry import get_geometry as jget_geometry

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models import decoder as tdec
from gpujpeg_tpu_torch.stream import reader as treader
from gpujpeg_tpu_torch.utils.geometry import get_geometry as tget_geometry

H, W = 48, 64
LAYOUTS = {
    "planar_444": dict(interleaved=False, samp=None),
    "il_420": dict(interleaved=True, samp=((2, 2), (1, 1), (1, 1))),
}


def _smooth(rng, h=H, w=W, amp=10):
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  ((xx + yy) * 255 // (w + h))], -1)
    return np.clip(f + rng.integers(-amp, amp, f.shape), 0, 255) \
        .astype(np.uint8)


def _noise(rng, h=H, w=W):
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


def _params(layout, rst=4, quality=85):
    lay = LAYOUTS[layout]
    p = gj.Parameters(quality=quality, restart_interval=rst,
                      interleaved=lay["interleaved"])
    return p.chroma_subsampled(lay["samp"]) if lay["samp"] else p


@pytest.fixture(scope="module")
def sequences():
    """Per layout: (frames, the JAX package's streams of them, its decoded
    pixels); a noise frame mid-sequence."""
    rng = np.random.default_rng(13)
    out = {}
    for layout in LAYOUTS:
        frames = [_smooth(rng), _smooth(rng), _noise(rng), _smooth(rng)]
        p = _params(layout)
        streams = [bytes(gj.Encoder().encode(f, p)) for f in frames]
        jd = gj.Decoder()
        pixels = [np.asarray(jd.decode(s)) for s in streams]
        out[layout] = (frames, streams, pixels)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_encode_pipelined_equals_jax(sequences, layout):
    frames, streams, _ = sequences[layout]
    enc = gt.Encoder(device="cpu")
    got = list(enc.encode_pipelined(frames, gt.from_reference(
        _params(layout))))
    assert got == streams


def test_encode_pipelined_restart0_equals_jax():
    """Restart interval 0 encodes each frame through encode()."""
    rng = np.random.default_rng(14)
    p = gj.Parameters(quality=85, restart_interval=0)
    frames = [_smooth(rng), _noise(rng)]
    got = list(gt.Encoder(device="cpu").encode_pipelined(
        frames, gt.from_reference(p)))
    assert got == [bytes(gj.Encoder().encode(f, p)) for f in frames]


def test_encode_pipelined_refuses_and_empty():
    """A frame of another shape or dtype raises ValueError; an empty
    iterator yields nothing."""
    rng = np.random.default_rng(15)
    p = gt.Parameters(quality=85, restart_interval=4)
    enc = gt.Encoder(device="cpu")
    assert list(enc.encode_pipelined([], p)) == []
    for bad in (_smooth(rng, 32, 48), _smooth(rng).astype(np.int16)):
        with pytest.raises(ValueError, match="shape"):
            list(enc.encode_pipelined([_smooth(rng), bad], p))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_pipelined_equals_jax(sequences, monkeypatch, layout):
    """Pixels equal the JAX package's; the noise stream, wider than the
    first stream's row width, goes through CapacityError to decode()."""
    _, streams, pixels = sequences[layout]
    dec = gt.Decoder(device="cpu")
    calls = []
    sequential = dec.decode
    monkeypatch.setattr(dec, "decode",
                        lambda d, *a: calls.append(d) or sequential(d, *a))
    kept = list(dec.decode_pipelined(streams + streams[:1]))
    assert len(kept) == len(streams) + 1
    for got, want in zip(kept, pixels + pixels[:1]):
        assert np.array_equal(got, want)
    assert calls == [streams[2]]
    assert list(dec.decode_pipelined(iter(()))) == []


def test_decode_pipelined_refuses_geometry_and_tables():
    rng = np.random.default_rng(16)
    enc = gt.Encoder(device="cpu")
    p = gt.Parameters(quality=85, restart_interval=4)
    s1 = enc.encode(_smooth(rng), p)
    for other in (enc.encode(_smooth(rng, 32, 48), p),
                  enc.encode(_smooth(rng), p.with_(quality=60))):
        with pytest.raises(ValueError, match="geometry|tables"):
            list(gt.Decoder(device="cpu").decode_pipelined([s1, other]))


def _geo(data, reader, get_geometry, dec_mod):
    ps = reader.parse(data)
    out_pi = dec_mod.resolve_output(ps, None)
    return get_geometry(reader.parsed_to_parameters(ps),
                        out_pi.with_(width_padding=0))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pack_stream_equals_jax(sequences, layout):
    """For the same max_words the arrays equal the JAX method's (every
    segment's payload bytes and bit counts; bytes past a payload are not
    written by either); both refuse a narrower width and a per-component
    width alike."""
    _, streams, _ = sequences[layout]
    data = streams[2]
    jgeo = _geo(data, jreader, jget_geometry, jdec)
    tgeo = _geo(data, treader, tget_geometry, tdec)
    need = max((e - s + 3) // 4 for s, e in zip(
        *treader.parse(data).scans[0].segment_bounds()))
    jw, jn = gj.Decoder().pack_stream(data, jgeo, need + 5)
    tw, tn = gt.Decoder(device="cpu").pack_stream(data, tgeo, need + 5)
    assert tw.shape == jw.shape and tw.dtype == jw.dtype
    assert np.array_equal(tn, jn)
    for s, nb in enumerate(tn):
        n = int(nb) // 8
        assert np.array_equal(tw.view(np.uint8)[s, :n],
                              jw.view(np.uint8)[s, :n]), s
    nseg = tw.shape[0]
    for args in ((1,), (need + 5, [(0, nseg, 2)])):
        with pytest.raises(jdec.CapacityError):
            gj.Decoder().pack_stream(data, jgeo, *args)
        with pytest.raises(tdec.CapacityError):
            gt.Decoder(device="cpu").pack_stream(data, tgeo, *args)


def test_pipeline_fn_and_warmup_equal_jax(sequences):
    """compile_stream_pipeline's fn decodes its words to the JAX pixels; a
    warmed-up session decodes the next stream exactly, with its stats
    left as they were."""
    _, streams, pixels = sequences["il_420"]
    dec = gt.Decoder(device="cpu")
    fn, words, nbits = dec.compile_stream_pipeline(streams[1])
    assert np.array_equal(fn(words, nbits).numpy(), pixels[1])
    warm = gt.Decoder(device="cpu")
    warm.warmup(streams[0])
    assert warm._plans and warm.get_stats().frames == 0
    assert np.array_equal(warm.decode(streams[3]), pixels[3])


def test_allocate_then_encode_equals_jax():
    """allocate runs a zero frame (the tables made, nothing returned); the
    first frame after it is the JAX package's bytes, at restart auto and
    0."""
    rng = np.random.default_rng(17)
    f = _smooth(rng)
    pi = gt.ImageParameters(width=W, height=H, color_space=gt.ColorSpace.RGB,
                            pixel_format=gt.PixelFormat.P444_U8_P012)
    for p in (_params("il_420", gt.RESTART_AUTO, 75), _params("planar_444",
                                                              0, 75)):
        enc = gt.Encoder(device="cpu")
        enc.allocate(gt.from_reference(p), pi)
        assert enc._tables
        assert enc.encode(f, gt.from_reference(p)) == \
            bytes(gj.Encoder().encode(f, p))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tables,rst", [("tuned", gt.RESTART_AUTO),
                                        ("annexk", gt.RESTART_AUTO),
                                        ("tuned", 0)])
def test_memory_planners_are_inverse(layout, tables, rst):
    """max_pixels and max_memory are each other's inverse, and
    estimate_memory of an 8K frame is max_memory of its pixels."""
    p = gt.from_reference(_params(layout, rst, 75)).with_(
        huffman_tables=tables)
    for pixels in (1, 640 * 480, 7680 * 4320, 123457):
        m = gt.Encoder.max_memory(p, pixels)
        assert gt.Encoder.max_pixels(p, m) == pixels
        assert gt.Encoder.max_pixels(p, m - 1) == pixels - 1
    for mem in (1 << 30, 80 << 30, (1 << 30) + 12345):
        n = gt.Encoder.max_pixels(p, mem)
        assert gt.Encoder.max_memory(p, n) <= mem \
            < gt.Encoder.max_memory(p, n + 1)
    pi = gt.ImageParameters(width=7680, height=4320,
                            color_space=gt.ColorSpace.RGB,
                            pixel_format=gt.PixelFormat.P444_U8_P012)
    assert gt.Encoder.estimate_memory(p, pi) == \
        gt.Encoder.max_memory(p, 7680 * 4320)
    assert gt.Encoder.max_pixels(p, 0) == 0
