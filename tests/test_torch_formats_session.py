"""PyTorch port, the session surface with every format on the CPU:
encode_pipelined of flat UYVY and planar frames with the flip and remap
options gives sequential encode()'s bytes (whose equality with the JAX
package's is test_torch_formats_encode.py's), decode_pipelined to
padded, flipped and planar outputs gives sequential decode()'s arrays,
compile_stream_pipeline's function leaves the output options out (as
the JAX method's does), allocate takes each input format's frame shape,
and the planners count each format's raw bytes and row padding."""

import numpy as np
import pytest
import torch

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models import encoder as tenc
from gpujpeg_tpu_torch.ops import sample as tsample
from gpujpeg_tpu_torch.utils.geometry import get_geometry

from tests import format_cases as fc

HW = (48, 64)


@pytest.mark.parametrize("kind,options", [
    ("uyvy", [("enc_opt_flipped", "true")]),
    ("p420", []),
    ("rgba", [("enc_opt_channel_remap", "3210")]),
    ("u8", [("enc_opt_flipped", "true")])])
def test_encode_pipelined_equals_sequential(kind, options):
    frames, p, pi = [], None, None
    for seed in range(3):
        raw, pf, pad = fc.raw_input(kind, *HW, seed=seed)
        frames.append(raw)
        p, pi = fc.params(gt, rst=4), fc.image_params(gt, pf, *HW, pad)
    enc = gt.Encoder(device="cpu")
    for key, value in options:
        enc.set_option(key, value)
    want = [enc.encode(f, p, pi) for f in frames]
    assert list(enc.encode_pipelined(frames, p, pi)) == want


def _stream(kind="rgb", samp=None, seed=0):
    raw, pf, pad = fc.raw_input(kind, *HW, seed=seed)
    return gt.Encoder(device="cpu").encode(
        raw, fc.params(gt, samp, rst=4), fc.image_params(gt, pf, *HW, pad))


@pytest.mark.parametrize("pf,options", [
    ("P444_U8_P012", [("dec_opt_alignment_bytes", "256"),
                      ("dec_opt_flipped", "true")]),
    ("P420_U8_P0P1P2", [("dec_opt_flipped", "true")]),
    ("P4444_U8_P0123", [("dec_opt_channel_remap", "3F1")]),
    ("U8", [("dec_opt_alignment_bytes", "128")])])
def test_decode_pipelined_and_pipeline_fn(pf, options):
    streams = [_stream(seed=s) for s in range(3)]
    dec = gt.Decoder(device="cpu")
    dec.set_output_format(gt.ColorSpace.RGB, gt.PixelFormat[pf])
    for key, value in options:
        dec.set_option(key, value)
    want = [dec.decode(s) for s in streams]
    got = list(dec.decode_pipelined(streams))
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b)
    # the device-only function: no flip, remap or row padding
    plain = gt.Decoder(device="cpu")
    plain.set_output_format(gt.ColorSpace.RGB, gt.PixelFormat[pf])
    fn, words, nbits = dec.compile_stream_pipeline(streams[1])
    out = fn(words, nbits).numpy()
    ref = plain.decode(streams[1])
    assert out.shape == ref.shape and np.array_equal(out, ref)
    dec.warmup(streams[0])
    assert np.array_equal(dec.decode(streams[2]), want[2])


@pytest.mark.parametrize("kind", list(fc.INPUTS))
def test_allocate_and_planners_take_every_format(kind):
    """allocate encodes a zero frame of the format's shape (frame_shape:
    the JAX Encoder.allocate's), and estimate_memory counts the format's
    raw bytes and row padding."""
    raw, pf, pad = fc.raw_input(kind, *HW, seed=1)
    pi = fc.image_params(gt, pf, *HW, pad)
    p = fc.params(gt, rst=4)
    enc = gt.Encoder(device="cpu")
    if pad and fc.INPUTS[kind][1] == "flat" and pf != "P444_U8_P012" \
            and pf != "P4444_U8_P0123":
        # the JAX Encoder.allocate makes an unpadded flat buffer, which
        # its unpack cannot reshape into padded rows (ROADMAP queue 3)
        with pytest.raises(TypeError):
            enc.allocate(p, pi)
    else:
        enc.allocate(p, pi)
    shape = tenc.frame_shape(pi)
    if fc.INPUTS[kind][1] != "2d" or pf != "U8":
        assert np.prod(shape) == raw.size - HW[0] * pad
    geo = get_geometry(tenc.adjust_params(p, pi), pi)
    nopad = get_geometry(tenc.adjust_params(p, pi), pi.with_(width_padding=0))
    assert tenc.frame_bytes(geo) - tenc.frame_bytes(nopad) in (
        0, HW[0] * pad)
    assert gt.Encoder.estimate_memory(p, pi) == tenc.frame_bytes(geo)
    assert enc.encode(raw, p, pi)[:2] == b"\xff\xd8"


def test_flip_and_remap_are_device_ops():
    """sample.flip_remap flips (H, W[, C]) arrays only and remaps
    (H, W, C) ones only, with F = 255 and Z = 0 (the JAX package's
    apply_pre_transform and Decoder._apply_output_options)."""
    x = torch.arange(24, dtype=torch.uint8).reshape(2, 4, 3)
    out = tsample.flip_remap(x, True, "2FZ0")
    assert out.shape == (2, 4, 4)
    assert torch.equal(out[..., 0], x.flip(0)[..., 2])
    assert bool((out[..., 1] == 255).all()) and bool((out[..., 2] == 0).all())
    flat = torch.arange(8, dtype=torch.uint8)
    assert torch.equal(tsample.flip_remap(flat, True, "210"), flat)
    grey = x[..., 0]
    assert torch.equal(tsample.flip_remap(grey, False, "210"), grey)
    assert tsample.flip_remap(x, False, None) is x
