"""PyTorch port, the sessions' options and stats against the JAX package:
header, orientation and EXIF options give the JAX package's bytes (its
tests/test_options.py), the flip, remap and alignment keys give its
bytes and arrays, the RLE TGA key sets the file writer's flag, and
the stats classes have the JAX fields, labels and summary, with the
phases filled under perf_stats (its tests/test_stats.py).  CPU, 64x80
frames."""

import dataclasses
import io

import numpy as np
import pytest

import gpujpeg_tpu as gj
from gpujpeg_tpu.models import decoder as jdec
from gpujpeg_tpu.models import encoder as jenc

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models import decoder as tdec
from gpujpeg_tpu_torch.models import encoder as tenc
from tests import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def frame():
    h, w = 64, 80
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  np.full((h, w), 128)], -1)
    rng = np.random.default_rng(7)
    return np.clip(f + rng.integers(-10, 10, f.shape), 0, 255) \
        .astype(np.uint8)


def _both(options, frame, rst=4):
    """(JAX bytes, port bytes) of the frame encoded with the options set
    on each session."""
    p = gj.Parameters(quality=80, restart_interval=rst)
    out = []
    for enc in (gj.Encoder(), gt.Encoder(device="cpu")):
        for key, value in options:
            enc.set_option(key, value)
        out.append(enc.encode(frame, gt.from_reference(p)
                              if isinstance(enc, gt.Encoder) else p))
    return out


@pytest.mark.parametrize("hdr", ["JFIF", "Adobe", "Exif", "SPIFF"])
def test_header_type_option(frame, hdr):
    want, got = _both([("enc_hdr", hdr)], frame)
    assert got == want


@pytest.mark.parametrize("options,rst", [
    ([("enc_metadata", "orientation=1")], 4),
    ([("enc_metadata", "orientation=3,flip")], 4),
    ([("enc_exif_tag", "0x013B:ASCII=tpujpeg")], 4),
    ([("enc_exif_tag", "0x013B:ASCII=tpujpeg"),
      ("enc_metadata", "orientation=2")], 4),
    ([("enc_hdr", "SPIFF"), ("enc_metadata", "orientation=1,flip")], 0),
    ([("enc_opt_out", "enc_out_val_pinned")], 4),
])
def test_metadata_and_exif_options(frame, options, rst):
    """Orientation (SPIFF or EXIF), custom EXIF tags and the accepted
    output-buffer option give the JAX package's bytes, on the device
    route and on restart interval 0's host route."""
    want, got = _both(options, frame, rst)
    assert got == want
    if any(k == "enc_exif_tag" for k, _ in options):
        assert b"Exif\x00\x00" in got


def test_invalid_options():
    enc, dec = gt.Encoder(device="cpu"), gt.Decoder(device="cpu")
    for key, value in (("enc_bogus", "1"), ("enc_hdr", "TIFF"),
                       ("enc_metadata", "rotation=1")):
        with pytest.raises(ValueError):
            enc.set_option(key, value)
    with pytest.raises(ValueError):
        dec.set_option("dec_bogus", "1")


@pytest.mark.parametrize("session,key,item", [
    ("Encoder", "enc_opt_flipped", 6),
    ("Encoder", "enc_opt_channel_remap", 6),
    ("Decoder", "dec_opt_flipped", 6),
    ("Decoder", "dec_opt_channel_remap", 6),
    ("Decoder", "dec_opt_alignment_bytes", 6),
    ("Decoder", "dec_opt_tga_rle", 11),
])
def test_unported_options_name_their_item(frame, session, key, item,
                                          tmp_path, monkeypatch):
    """The keys of ROADMAP queue 1 item 6 (done) give the JAX package's
    bytes (encoder) or array (decoder) with the option set on both
    sessions; the key of item 11 (RLE TGA file output, done) sets each
    package's io.image.TGA_RLE, and the TGA files written after it are
    the JAX package's bytes, with RLE on and off."""
    value = {"enc_opt_flipped": "true", "enc_opt_channel_remap": "2F0Z",
             "dec_opt_flipped": "true", "dec_opt_channel_remap": "1Z2F",
             "dec_opt_alignment_bytes": "64", "dec_opt_tga_rle": "true"}[key]
    if item != 6:
        from gpujpeg_tpu.io import image as jio
        from gpujpeg_tpu_torch.io import image as tio

        monkeypatch.setattr(jio, "TGA_RLE", jio.TGA_RLE)
        monkeypatch.setattr(tio, "TGA_RLE", tio.TGA_RLE)
        sizes = []
        for v in (value, "false"):
            files = []
            for pkg, dec, mod in (("jax", gj.Decoder(), jio),
                                  ("port", gt.Decoder(device="cpu"), tio)):
                dec.set_option(key, v)
                assert mod.TGA_RLE is (v == "true")
                path = str(tmp_path / f"{pkg}_{v}.tga")
                mod.save(path, mod.formats.implied_parameters(
                    mod.FileFormat.TGA).with_(width=80, height=64), frame)
                with open(path, "rb") as f:
                    files.append(f.read())
            assert files[1] == files[0]
            sizes.append(len(files[0]))
        assert sizes[0] != sizes[1]          # RLE on and off differ
        return
    if session == "Encoder":
        want, got = _both([(key, value)], frame)
        assert got == want
        return
    data = bytes(gj.Encoder().encode(frame, gj.Parameters(
        quality=80, restart_interval=4)))
    out = []
    for dec in (gj.Decoder(), gt.Decoder(device="cpu")):
        dec.set_option(key, value)
        out.append(np.asarray(dec.decode(data)))
    assert out[1].shape == out[0].shape and np.array_equal(out[1], out[0])


def test_print_options():
    """Both sessions list the reference's keys; the decoder's text is the
    JAX package's, the encoder's differs only in what enc_opt_out does
    on the card."""
    assert gt.Decoder.print_options() == gj.Decoder.print_options()
    got = gt.Encoder.print_options().splitlines()
    want = gj.Encoder.print_options().splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.split(" - ")[0] == w.split(" - ")[0]
        if not g.startswith("\tenc_opt_out"):
            assert g == w
    assert "pinned" in got[0] and "TPU" not in got[0]


def test_stats_classes_match_jax():
    """The stats classes have the JAX fields, print labels and summary
    text."""
    assert [f.name for f in dataclasses.fields(tenc.DurationStats)] == \
        [f.name for f in dataclasses.fields(jenc.DurationStats)]
    assert [f.name for f in dataclasses.fields(tenc.AggregateStats)] == \
        [f.name for f in dataclasses.fields(jenc.AggregateStats)]
    assert vars(tdec.DecoderStats()) == vars(jdec.DecoderStats())
    vals = dict(duration_memory_to=1.5, duration_memory_from=2.25,
                duration_preprocessor=0.5, duration_dct_quantization=0.75,
                duration_huffman_coder=1.125, duration_stream=3.0,
                duration_in_gpu=4.5, retries=2)
    outs = []
    for st in (tenc.DurationStats(**vals), jenc.DurationStats(**vals),
               tdec.DecoderStats(), jdec.DecoderStats()):
        for k, v in vals.items():
            if k != "retries" and hasattr(st, k):
                setattr(st, k, v)
        buf = io.StringIO()
        st.print(file=buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[2] == outs[3]
    for a, b in ((tenc.AggregateStats(), jenc.AggregateStats()),
                 (tdec.DecoderStats(), jdec.DecoderStats())):
        assert a.summary() == b.summary() == "no frames"
        for ms in (12.5, 3.25, 4.0):
            getattr(a, "add", getattr(a, "add_frame", None))(ms)
            getattr(b, "add", getattr(b, "add_frame", None))(ms)
        assert a.summary() == b.summary()
        assert "(3 frames)" in a.summary()


def test_encoder_phase_stats(frame):
    """perf_stats fills the encoder's phase splits (the host's clock on
    the CPU); retries stays 0; the aggregate counts encode()'s frames."""
    enc = gt.Encoder(device="cpu")
    p = gt.Parameters(quality=75, restart_interval=4)
    enc.encode(frame, p)
    st = enc.get_stats()
    assert st.duration_in_gpu > 0 and st.duration_stream > 0
    assert st.duration_preprocessor == st.duration_huffman_coder == 0
    enc.perf_stats = True
    out = enc.encode(frame, p)
    assert enc.get_stats() is st
    assert st.duration_preprocessor > 0
    assert st.duration_dct_quantization > 0
    assert st.duration_huffman_coder > 0
    assert st.retries == 0
    assert (st.duration_preprocessor + st.duration_dct_quantization
            + st.duration_huffman_coder) <= st.duration_in_gpu * 1.01
    buf = io.StringIO()
    st.print(file=buf)
    assert "Preprocessing" in buf.getvalue()
    assert "Huffman Encoder" in buf.getvalue()
    assert len(out) > 100
    assert "(2 frames)" in enc.aggregate.summary()
    enc.encode(frame, p.with_(restart_interval=0))
    assert "(3 frames)" in enc.aggregate.summary()


def test_decoder_phase_stats(frame):
    """perf_stats fills the decoder's phase splits; decode() counts its
    frames."""
    data = gt.Encoder(device="cpu").encode(
        frame, gt.Parameters(quality=75, restart_interval=4))
    dec = gt.Decoder(device="cpu")
    dec.perf_stats = True
    arr = dec.decode(data)
    st = dec.get_stats()
    assert arr.shape == frame.shape
    assert st.duration_stream > 0 and st.duration_in_gpu > 0
    assert st.duration_huffman_coder > 0
    assert st.duration_dct_quantization > 0
    buf = io.StringIO()
    st.print(file=buf)
    assert "Huffman Decoder" in buf.getvalue()
    assert "Stream Reader" in buf.getvalue()
    dec.decode(data)
    assert "(2 frames)" in st.summary()
