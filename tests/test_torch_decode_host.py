"""PyTorch port, decode host layer: the stream parser, the segment matrix
and the output resolution against the JAX package's copies, on the same
bytes."""

import dataclasses

import numpy as np
import pytest
import torch

import gpujpeg_tpu as gj
from gpujpeg_tpu.models import decoder as jdec
from gpujpeg_tpu.stream import reader as jreader
from gpujpeg_tpu.stream import segments as jseg

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch import native as tnative
from gpujpeg_tpu_torch.models import decoder as tdec
from gpujpeg_tpu_torch.stream import reader as treader
from gpujpeg_tpu_torch.stream import segments as tseg

from .test_torch_encode import _gradient
from tests import torch_threads  # noqa: F401


def _stream(kind, segment_info):
    frame = (np.random.default_rng(4).integers(0, 256, (40, 72, 3),
                                                dtype=np.uint8)
             if kind == "noise" else _gradient(72, 96, 3))
    return gt.Encoder(device="cpu").encode(frame, gt.Parameters(
        quality=75, restart_interval=4 if kind == "noise" else
        gt.RESTART_AUTO, segment_info=segment_info))


def _same(a, b):
    """Field-by-field equality of a port value and a JAX value (enums by
    name, arrays by content)."""
    if hasattr(a, "name") and hasattr(b, "name") and not isinstance(a, str):
        return a.name == b.name
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


@pytest.mark.parametrize("kind", ["gradient", "noise"])
@pytest.mark.parametrize("segment_info", [False, True])
def test_parse_matches_jax(kind, segment_info):
    """ParsedStream fields, scans and segment bounds are identical; with
    segment_info=True both take the APP13 offsets path."""
    data = _stream(kind, segment_info)
    assert (b"\xff\xed" in data) == segment_info
    tp, jp = treader.parse(data), jreader.parse(data)
    for f in dataclasses.fields(jp):
        if f.name != "scans":
            assert _same(getattr(tp, f.name), getattr(jp, f.name)), f.name
    assert len(tp.scans) == len(jp.scans) == 3
    for ts, js in zip(tp.scans, jp.scans):
        assert (ts.comp_indices, ts.dc_table, ts.ac_table) == \
            (js.comp_indices, js.dc_table, js.ac_table)
        assert (ts.offsets is not None) == (js.offsets is not None) \
            == segment_info
        for a, b in zip(ts.segment_bounds(), js.segment_bounds()):
            assert np.array_equal(a, b)
        assert np.array_equal(ts.segments, js.segments)
    assert _same(treader.parsed_to_parameters(tp),
                 jreader.parsed_to_parameters(jp))


@pytest.mark.parametrize("native", [True, False])
def test_segment_matrix_matches_jax(monkeypatch, native):
    """pack_segments_matrix gives the same payload words and bit counts,
    through the native unstuffer and through the numpy version."""
    data = _stream("noise", False)
    ps = treader.parse(data)
    geo = gt.Decoder(device="cpu").prepare(data).plan.geo
    bounds = tdec.Decoder._segment_bounds(ps, geo)
    W = (int((bounds[1] - bounds[0]).max()) + 3) // 4
    if not native:
        monkeypatch.setattr(tnative, "lib", lambda: None)
    tw, tb = tseg.pack_segments_matrix(ps.data, bounds, W)
    jw, jb = jseg.pack_segments_matrix(ps.data, bounds, W)
    assert tw.shape == jw.shape == (len(bounds[0]), W + 1)
    assert np.array_equal(tb, jb)
    tbytes, jbytes = tw.view(np.uint8), np.asarray(jw).view(np.uint8)
    for s, n in enumerate(tb // 8):
        assert np.array_equal(tbytes[s, :n], jbytes[s, :n]), s
    if not native:      # the numpy version zero-fills past the payload
        assert not tbytes[np.arange(tbytes.shape[1])[None, :]
                          >= (tb // 8)[:, None]].any()


@pytest.mark.parametrize("request_", [
    None, "NATIVE", "STD", "YCBCR_RGB_ALIGN"])
def test_output_resolution_matches_jax(request_):
    """get_image_info and resolve_output agree; JAX ImageInfo and
    ImageParameters convert to the port's."""
    data = _stream("gradient", False)
    info = gt.Decoder(device="cpu").get_image_info(data)
    assert info == gt.from_reference(gj.Decoder().get_image_info(data))
    ps, jps = treader.parse(data), jreader.parse(data)
    align = 0
    if request_ is None:
        jreq = None
    elif request_ == "YCBCR_RGB_ALIGN":
        jreq = gj.ImageParameters(color_space=gj.ColorSpace.YCBCR_BT709,
                                  pixel_format=gj.PixelFormat.P444_U8_P012)
        align = 64
    else:
        from gpujpeg_tpu.types import PixelFormatRequest

        jreq = gj.ImageParameters(
            color_space=gj.ColorSpace.YCBCR_BT601,
            pixel_format=PixelFormatRequest[request_])
    treq = None if jreq is None else gt.from_reference(jreq)
    got = tdec.resolve_output(ps, treq, align)
    assert got == gt.from_reference(jdec.resolve_output(jps, jreq, align))
    assert tdec._native_pixel_format(ps).name == \
        jdec._native_pixel_format(jps).name
    assert _same(tdec.default_output(ps), jdec.default_output(jps))


@pytest.mark.parametrize("native", [True, False])
def test_segment_matrix_out_matches_fresh(monkeypatch, native):
    """out= fills the caller's buffer with the same words and bit counts
    as a fresh matrix, through the native unstuffer and the numpy
    version."""
    data = _stream("noise", False)
    ps = treader.parse(data)
    geo = gt.Decoder(device="cpu").prepare(data).plan.geo
    bounds = tdec.Decoder._segment_bounds(ps, geo)
    W = (int((bounds[1] - bounds[0]).max()) + 3) // 4
    if not native:
        monkeypatch.setattr(tnative, "lib", lambda: None)
    fw, fb = tseg.pack_segments_matrix(ps.data, bounds, W)
    out = np.full((len(bounds[0]), (W + 1) * 4), 0xA5, np.uint8)
    ow, ob = tseg.pack_segments_matrix(ps.data, bounds, W, out=out)
    assert np.shares_memory(ow, out)
    assert np.array_equal(ob, fb)
    obytes, fbytes = ow.view(np.uint8), fw.view(np.uint8)
    for s, n in enumerate(fb // 8):
        assert np.array_equal(obytes[s, :n], fbytes[s, :n]), s
    if not native:
        assert np.array_equal(ow, fw)      # zero-filled past the payload
    # a buffer of another shape is not written; a fresh matrix is returned
    bad = np.zeros((len(bounds[0]), W * 4), np.uint8)
    bw, bb = tseg.pack_segments_matrix(ps.data, bounds, W, out=bad)
    assert not np.shares_memory(bw, bad) and not bad.any()
    assert np.array_equal(bb, fb)


def _reusing_decoder(monkeypatch, step=256):
    """A CPU session that reuses its segment buffer as a CUDA session
    does, with plain numpy memory in place of pinned memory; returns the
    decoder and the list of buffer sizes it allocated."""
    sizes = []

    def fake_pinned(nbytes):
        sizes.append(nbytes)
        return np.empty(nbytes, np.uint8)

    monkeypatch.setattr(tdec, "pinned_empty", fake_pinned)
    monkeypatch.setattr(tdec, "SCRATCH_STEP", step)
    dec = gt.Decoder(device="cpu")
    dec._reuse_scratch = True
    return dec, sizes


def test_scratch_grows_then_is_reused(monkeypatch):
    """The session's buffer grows (in whole steps) for a larger stream and
    is reused, not reallocated, after that; words, bits and pixels equal
    a fresh matrix's."""
    streams = [_stream("gradient", False), _stream("noise", False)]
    fresh = gt.Decoder(device="cpu")
    need = [fresh.prepare(d).words.nbytes for d in streams]
    small, large = (streams if need[0] < need[1] else streams[::-1])
    dec, sizes = _reusing_decoder(monkeypatch)
    bufs = []
    for data in (small, large, small, large):
        hf, ref = dec.prepare(data), fresh.prepare(data)
        assert np.shares_memory(hf.words, dec._prep_buf)
        assert np.array_equal(hf.nbits, ref.nbits)
        for s, n in enumerate(ref.nbits // 32):
            assert np.array_equal(hf.words[s, :n], ref.words[s, :n]), s
        bufs.append(dec._prep_buf)
        assert np.array_equal(dec.decode(data), fresh.decode(data))
    assert len(sizes) == 2 and sizes[0] < sizes[1]
    assert all(n % 256 == 0 for n in sizes)
    assert sizes[1] >= max(need)
    assert bufs[1] is bufs[2] is bufs[3] is not bufs[0]


@pytest.mark.parametrize("entry", ["decode", "decode_to_device"])
def test_scratch_dropped_when_decode_raises(monkeypatch, entry):
    """A decode that raises drops the reused buffer (an upload from it may
    still be in flight); the next decode takes a new one."""
    data = _stream("gradient", False)
    dec, sizes = _reusing_decoder(monkeypatch)
    want = dec.decode(data)
    assert dec._prep_buf is not None

    def boom(*a, **k):
        raise RuntimeError("back half failed")

    monkeypatch.setattr(tdec.Decoder, "back_half", staticmethod(boom))
    with pytest.raises(RuntimeError, match="back half failed"):
        getattr(dec, entry)(data)
    assert dec._prep_buf is None and dec._prep_event is None
    monkeypatch.undo()
    monkeypatch.setattr(tdec, "pinned_empty", lambda n: np.empty(n, np.uint8))
    assert np.array_equal(dec.decode(data), want)
    assert dec._prep_buf is not None


def test_cpu_session_never_pins(monkeypatch):
    """A CPU session allocates no pinned memory and gives every frame a
    fresh matrix (torch.from_numpy aliases it)."""
    def no_pinning(*a, **k):
        raise AssertionError("a CPU session asked for pinned memory")

    monkeypatch.setattr(tdec, "pinned_empty", no_pinning)
    real_empty = torch.empty

    def empty(*a, **k):
        if k.get("pin_memory"):
            no_pinning()
        return real_empty(*a, **k)

    monkeypatch.setattr(torch, "empty", empty)
    dec = gt.Decoder(device="cpu")
    data = _stream("gradient", False)
    a, b = dec.prepare(data), dec.prepare(data)
    assert not np.shares_memory(a.words, b.words)
    dec.decode(data)
    assert dec._prep_buf is None and dec._prep_event is None
