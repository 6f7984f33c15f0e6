"""PyTorch port, file I/O and stream reformat against the JAX package: every
case of tests/test_io.py but the CLI ones, run through both packages'
modules (gpujpeg_tpu.io and gpujpeg_tpu_torch.io, the two reformat
modules, the two colour converters) with equal results: the bytes
written, the arrays loaded, the ImageParameters and the exception types.
CPU, small arrays; the JAX colour converter is the one JAX computation."""

import os

import numpy as np
import pytest
import torch

import gpujpeg_tpu as gj
from gpujpeg_tpu.io import formats as jfmt, image as jimg, pnm as jpnm
from gpujpeg_tpu.io import tst as jtst, y4m as jy4m
from gpujpeg_tpu.ops import color as jcolor
from gpujpeg_tpu.stream import reformat as jref

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch import native as tnative
from gpujpeg_tpu_torch.io import formats as tfmt, image as timg, pnm as tpnm
from gpujpeg_tpu_torch.io import tst as ttst, y4m as ty4m
from gpujpeg_tpu_torch.ops import color as tcolor
from gpujpeg_tpu_torch.stream import reformat as tref
from tests import torch_threads  # noqa: F401


def _pi(pi):
    """An ImageParameters of either package as plain values."""
    return (pi.width, pi.height, pi.color_space.name, pi.pixel_format.name,
            pi.width_padding)


def _port_pi(pi):
    """The port's ImageParameters of the JAX package's one."""
    return gt.ImageParameters(
        width=pi.width, height=pi.height,
        color_space=gt.ColorSpace[pi.color_space.name],
        pixel_format=gt.PixelFormat[pi.pixel_format.name],
        width_padding=pi.width_padding)


def _same_result(jfn, tfn):
    """Both calls' results, or both calls' exception type names."""
    out = []
    for fn in (jfn, tfn):
        try:
            out.append(("ok", fn()))
        except Exception as e:       # the exception types must agree
            out.append(("raised", type(e).__name__))
    assert out[0][0] == out[1][0], out
    return out


@pytest.mark.parametrize("name", sorted(jfmt._EXT_MAP) + [
    "noext", "a/b/c.Y4M", "x.PPM", "1920x1080.tst", "x.unknown"])
def test_extension_map(name):
    path = name if "." in name or name == "noext" else f"x.{name}"
    assert tfmt.get_file_format(path).name == \
        jfmt.get_file_format(path).name


@pytest.mark.parametrize("fmt", [f.name for f in jfmt.FileFormat])
def test_implied_parameters(fmt):
    assert _pi(tfmt.implied_parameters(tfmt.FileFormat[fmt])) == \
        _pi(jfmt.implied_parameters(jfmt.FileFormat[fmt]))


def test_name_maps():
    for n in list(jfmt.PIXEL_FORMAT_NAMES) + ["bogus"]:
        a, b = jfmt.pixel_format_by_name(n), tfmt.pixel_format_by_name(n)
        assert (a is None and b is None) or a.name == b.name
    for n in list(jfmt.COLOR_SPACE_NAMES) + ["bogus"]:
        a, b = jfmt.color_space_by_name(n), tfmt.color_space_by_name(n)
        assert (a is None and b is None) or a.name == b.name
    assert {k.name: v for k, v in tfmt.COLOR_SPACE_DISPLAY.items()} == \
        {k.name: v for k, v in jfmt.COLOR_SPACE_DISPLAY.items()}
    assert {k.name: v for k, v in tfmt.PIXEL_FORMAT_BY_VALUE.items()} == \
        {k.name: v for k, v in jfmt.PIXEL_FORMAT_BY_VALUE.items()}


@pytest.mark.parametrize("shape,pam", [((17, 23, 3), False),
                                       ((7, 9), False), ((5, 6, 4), False),
                                       ((5, 6, 3), True), ((4, 3), True)])
def test_pnm_bytes_and_loads(shape, pam):
    """P6, P5 and PAM (4 channels, or asked for) bytes, and the loaded
    arrays and parameters."""
    arr = np.random.default_rng(len(shape) + pam).integers(
        0, 256, shape, dtype=np.uint8)
    jb = jpnm.save_pnm(gj.ImageParameters(width=shape[1], height=shape[0]),
                       arr, pam=pam)
    tb = tpnm.save_pnm(gt.ImageParameters(width=shape[1], height=shape[0]),
                       arr, pam=pam)
    assert tb == jb
    (ja, jpi), (ta, tpi) = jpnm.load_pnm(jb), tpnm.load_pnm(jb)
    assert np.array_equal(ta, arr) and np.array_equal(ta, ja)
    assert _pi(tpi) == _pi(jpi)


@pytest.mark.parametrize("data", [
    b"P5\n# a comment\n4 2\n# another\n255\n" + bytes(8),
    b"P6 2 1 255\n" + bytes(range(6)),
    b"P5\n4 2\n65535\n" + bytes(16),
    b"P3\n1 1\n255\n0 0 0\n",
    b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 2\nMAXVAL 255\nENDHDR\n" + bytes(4),
    b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 3\nMAXVAL 15\nENDHDR\n" + bytes(3),
])
def test_pnm_headers_and_refusals(data):
    """Comments, a header on one line, and the refusals (maxval other
    than 255, ASCII PNM, PAM depth 2) with the same exception types."""
    j, t = _same_result(lambda: jpnm.load_pnm(data),
                        lambda: tpnm.load_pnm(data))
    if j[0] == "ok":
        assert np.array_equal(t[1][0], j[1][0])
        assert _pi(t[1][1]) == _pi(j[1][1])
    else:
        assert t == j


Y4M_FORMATS = ["P420_U8_P0P1P2", "P422_U8_P0P1P2", "P444_U8_P0P1P2", "U8"]


@pytest.mark.parametrize("pf", Y4M_FORMATS)
@pytest.mark.parametrize("cs", ["YCBCR_BT601_256LVLS", "YCBCR_BT601"])
@pytest.mark.parametrize("frames", [1, 5])
def test_y4m_bytes_and_loads(pf, cs, frames):
    """Single- and multi-frame Y4M of every chroma type, full and limited
    range: bytes, the frames loaded, the parameters."""
    jpi = gj.ImageParameters(width=32, height=16,
                             color_space=gj.ColorSpace[cs],
                             pixel_format=gj.PixelFormat[pf])
    size = gj.types.image_size_bytes(32, 16, jpi.pixel_format)
    rng = np.random.default_rng(frames)
    arrs = [rng.integers(0, 256, size, dtype=np.uint8)
            for _ in range(frames)]
    if frames == 1:
        jb, tb = jy4m.save_y4m(jpi, arrs[0]), ty4m.save_y4m(_port_pi(jpi),
                                                           arrs[0])
    else:
        jb = jy4m.save_y4m_frames(jpi, arrs)
        tb = ty4m.save_y4m_frames(_port_pi(jpi), arrs)
    assert tb == jb
    (jpi2, jit), (tpi2, tit) = jy4m.load_y4m_frames(jb), \
        ty4m.load_y4m_frames(jb)
    assert _pi(tpi2) == _pi(jpi2)
    got = list(tit)
    assert len(got) == frames and all(np.array_equal(a, b)
                                      for a, b in zip(got, arrs))
    first, pi1 = ty4m.load_y4m(jb)
    assert np.array_equal(first, jy4m.load_y4m(jb)[0])
    assert _pi(pi1) == _pi(jy4m.load_y4m(jb)[1])


@pytest.mark.parametrize("data", [
    b"YUV4MPEG2 W4 H2 C420p10\nFRAME\n" + bytes(24),
    b"YUV4MPEG2 W4 H2 C411\nFRAME\n" + bytes(12),
    b"YUV4MPEG2 W4 H2 C444alpha\nFRAME\n" + bytes(32),
    b"YUV4MPEG2 W4 H2 C420jpeg\nFRAME\n" + bytes(5),
    b"YUV4MPEG2 W4 H2 Cmono\nFRAMX\n" + bytes(8),
    b"NOTY4M W4 H2\n",
])
def test_y4m_headers_and_refusals(data):
    """10-bit and 4:1:1 refused, 444alpha read, a truncated frame and a
    missing FRAME marker refused, a foreign header refused: the same
    frames or exception types."""
    j, t = _same_result(lambda: list(jy4m.load_y4m_frames(data)[1]),
                        lambda: list(ty4m.load_y4m_frames(data)[1]))
    if j[0] == "ok":
        assert all(np.array_equal(a, b) for a, b in zip(t[1], j[1]))
    else:
        assert t == j
    pf = gt.PixelFormat.P4444_U8_P0123
    with pytest.raises(ValueError):
        ty4m.save_y4m(gt.ImageParameters(width=4, height=2,
                                         pixel_format=pf), bytes(32))


@pytest.mark.parametrize("name", [
    "1920x1080.tst", "64x32.c_ycbcr-jpeg.p_u8.random_77.tst",
    "16x8.blank_128.tst", "8x8.p_u8.tst", "24x10.p_420-u8-p0p1p2.tst",
    "30x6.c_ycbcr-bt709.p_422-u8-p1020.gradient.tst",
    "6x4.p_4444-u8-p0123.random.tst", "5x3.blank_0x7f.tst",
    "8x8.c_bogus.tst", "8x8.p_bogus.tst", "8x8.sparkle.tst", "88.tst"])
def test_tst_parse_and_patterns(name):
    """The filename grammar and the gradient, blank and random patterns:
    parameters and bytes (random from the native LCG)."""
    j, t = _same_result(lambda: jtst.parse_tst_filename(name),
                        lambda: ttst.parse_tst_filename(name))
    if j[0] != "ok":
        assert t == j
        return
    assert _pi(t[1][0]) == _pi(j[1][0]) and t[1][1] == j[1][1]
    if "1920" in name:
        return
    (ja, jpi), (ta, tpi) = jtst.generate(name), ttst.generate(name)
    assert _pi(tpi) == _pi(jpi)
    assert ta.dtype == np.uint8 and np.array_equal(ta, ja)


def test_tst_noise_is_unseeded():
    """noise is unseeded in both packages: only its size and type agree."""
    ja, _ = jtst.generate("16x8.noise.tst")
    ta, _ = ttst.generate("16x8.noise.tst")
    assert ta.shape == ja.shape and ta.dtype == ja.dtype


@pytest.mark.parametrize("n,seed", [(1000, 12345), (70001, 7),
                                    (3, 0xFFFFFFFF)])
def test_lcg_fill_matches_lcg_bytes(n, seed):
    """The native LCG fill equals the numpy LCG of both packages and the
    reference's scalar loop (image_delegate.c:560-582)."""
    assert tnative.available()
    got = tnative.lcg_fill(n, seed)
    assert np.array_equal(got, jtst.lcg_bytes(n, seed))
    assert np.array_equal(got, ttst.lcg_bytes(n, seed))
    A, C, M = 1664525, 1013904223, 2147483647
    state, want = seed % M, []
    for _ in range(min(n, 500)):
        state = (A * state + C) % M
        want.append(state % 256)
    assert np.array_equal(got[:len(want)], np.asarray(want, np.uint8))


def test_lcg_fill_without_library(monkeypatch):
    """Without the native library lcg_fill is io.tst.lcg_bytes, as in
    the JAX package."""
    monkeypatch.setattr(tnative, "lib", lambda: None)
    assert np.array_equal(tnative.lcg_fill(999, 5), jtst.lcg_bytes(999, 5))


def _raw(shape_or_size, seed):
    return np.random.default_rng(seed).integers(0, 256, shape_or_size,
                                                dtype=np.uint8)


SAVES = [
    ("img.ppm", (9, 11, 3)), ("img.pgm", (9, 11)), ("img.pnm", (9, 11, 3)),
    ("img.pam", (9, 11, 4)), ("img.pam", (9, 11, 3)), ("img.rgb", (9, 11, 3)),
    ("img.rgba", (9, 11, 4)), ("img.r", (9, 11)), ("img.yuv", (9, 11, 3)),
    ("img.uyvy", 8 * 4 * 2), ("img.i420", 8 * 4 * 3 // 2),
    ("img.y4m", 8 * 4 * 3 // 2), ("img.raw", 100), ("img.xxx", 17)]


@pytest.mark.parametrize("name,shape", SAVES)
def test_image_dispatch(tmp_path, name, shape):
    """save by extension writes the same file, load reads the same array
    and parameters, probe gives the same parameters, in both packages."""
    arr = _raw(shape, len(name))
    fmt = jfmt.get_file_format(name)
    jpi = jfmt.implied_parameters(fmt).with_(
        width=arr.shape[1] if arr.ndim > 1 else 8,
        height=arr.shape[0] if arr.ndim > 1 else 4)
    if fmt == jfmt.FileFormat.Y4M:
        jpi = jpi.with_(pixel_format=gj.PixelFormat.P420_U8_P0P1P2)
    paths = []
    for pkg, mod, pi in (("jax", jimg, jpi), ("port", timg, _port_pi(jpi))):
        d = tmp_path / pkg
        d.mkdir()
        p = str(d / name)
        mod.save(p, pi, arr)
        paths.append(p)
    with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
        assert f1.read() == f0.read()
    (ja, jpi2), (ta, tpi2) = jimg.load(paths[0]), timg.load(paths[1])
    assert np.array_equal(ta, ja) and _pi(tpi2) == _pi(jpi2)
    assert np.array_equal(ta.reshape(-1), arr.reshape(-1))
    assert _pi(timg.probe(paths[1])) == _pi(jimg.probe(paths[0]))
    j, t = _same_result(lambda: jimg.calculate_size(jpi),
                        lambda: timg.calculate_size(_port_pi(jpi)))
    assert t == j


@pytest.mark.parametrize("name,exists", [
    ("320x200.p_u8.tst", True), ("nonexistent.uyvy", False),
    ("nonexistent.ppm", True), ("nonexistent.jpg", False),
    ("x.y4m", False), ("x.bmp", False)])
def test_image_probe(tmp_path, name, exists):
    path = name if name.endswith(".tst") else str(tmp_path / name)
    assert _pi(timg.probe(path, file_exists=exists)) == \
        _pi(jimg.probe(path, file_exists=exists))


@pytest.mark.parametrize("call", ["load", "save"])
def test_image_refusals(tmp_path, call):
    """An unknown extension raises the same exception in both."""
    p = str(tmp_path / "x.jpg")
    with open(p, "wb") as f:
        f.write(b"\xff\xd8")
    if call == "load":
        fns = (lambda: jimg.load(p), lambda: timg.load(p))
    else:
        fns = (lambda: jimg.save(p, gj.ImageParameters(), _raw(4, 0)),
               lambda: timg.save(p, gt.ImageParameters(), _raw(4, 0)))
    j, t = _same_result(*fns)
    assert j[0] == "raised" and t == j


@pytest.mark.parametrize("ext", ["png", "bmp", "tga", "gif"])
@pytest.mark.parametrize("rle", ["true", "false"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_pil_formats(tmp_path, monkeypatch, ext, rle, channels):
    """PNG, BMP and TGA files (TGA with RLE on and off, set through each
    package's Decoder.set_option) are the same bytes, and loading them
    (and a GIF written by PIL) gives the same arrays and parameters."""
    pytest.importorskip("PIL")
    from PIL import Image

    monkeypatch.setattr(jimg, "TGA_RLE", jimg.TGA_RLE)
    monkeypatch.setattr(timg, "TGA_RLE", timg.TGA_RLE)
    gj.Decoder().set_option("dec_opt_tga_rle", rle)
    gt.Decoder(device="cpu").set_option("dec_opt_tga_rle", rle)
    assert timg.TGA_RLE is jimg.TGA_RLE is (rle == "true")
    shape = (5, 4) if channels == 1 else (5, 4, channels)
    arr = np.repeat(_raw(shape, channels), 3, axis=0)    # runs for RLE
    paths = []
    for pkg, mod, pi in (("jax", jimg, gj.ImageParameters(width=4,
                                                          height=15)),
                         ("port", timg, gt.ImageParameters(width=4,
                                                           height=15))):
        p = str(tmp_path / f"{pkg}.{ext}")
        if ext == "gif":
            Image.fromarray(arr).save(p)
        else:
            mod.save(p, pi, arr)
        paths.append(p)
    with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
        assert f1.read() == f0.read()
    (ja, jpi), (ta, tpi) = jimg.load(paths[0]), timg.load(paths[1])
    assert np.array_equal(ta, ja) and _pi(tpi) == _pi(jpi)


def _stream(rst, il=False, samp=None, seg_info=False):
    frame = _raw((40, 56, 3), rst)
    p = gt.Parameters(quality=80, restart_interval=rst, interleaved=il,
                      segment_info=seg_info)
    if samp:
        p = p.chroma_subsampled(samp)
    return gt.Encoder(device="cpu").encode(frame, p)


@pytest.mark.parametrize("rst,il,samp,seg_info", [
    (4, False, None, False), (2, True, ((2, 2), (1, 1), (1, 1)), False),
    (1, False, ((2, 2), (1, 1), (1, 1)), False), (4, False, None, True),
    (0, False, None, False)])
def test_reformat_add_segment_info(tmp_path, rst, il, samp, seg_info):
    """add_segment_info writes the JAX package's bytes (old APP13 headers
    dropped, tables between scans kept), refuses a stream without restart
    markers with the same exception, and the port decodes its output to
    the pixels of the input; main() writes the same file."""
    data = _stream(rst, il, samp, seg_info)
    j, t = _same_result(lambda: jref.add_segment_info(data),
                        lambda: tref.add_segment_info(data))
    assert t[0] == j[0] and (t[1] == j[1])
    if j[0] != "ok":
        return
    assert b"\xff\xed" in t[1]
    dec = gt.Decoder(device="cpu")
    assert np.array_equal(dec.decode(t[1]), dec.decode(data))
    src, outs = str(tmp_path / "in.jpg"), []
    with open(src, "wb") as f:
        f.write(data)
    for pkg, mod in (("jax", jref), ("port", tref)):
        dst = str(tmp_path / f"{pkg}.jpg")
        assert mod.main([src, dst]) == 0
        with open(dst, "rb") as f:
            outs.append(f.read())
    assert outs[1] == outs[0] == t[1]
    assert tref.main([src]) == jref.main([src]) == 1


CS = ["RGB", "YUV", "YCBCR_BT601", "YCBCR_BT601_256LVLS", "YCBCR_BT709",
      "NONE"]


@pytest.mark.parametrize("src", CS)
@pytest.mark.parametrize("dst", CS)
def test_color_convert(src, dst):
    """ops/color.convert on a torch tensor equals the JAX convert on every
    pair of colour spaces, (..., 3) channels of every byte value."""
    c = np.stack(np.meshgrid(np.arange(0, 256, 5), np.arange(0, 256, 7),
                             np.arange(0, 256, 11), indexing="ij"),
                 -1).reshape(-1, 4, 3).astype(np.uint8)
    want = np.asarray(jcolor.convert(c, gj.ColorSpace[src],
                                     gj.ColorSpace[dst]))
    got = tcolor.convert(torch.from_numpy(c), gt.ColorSpace[src],
                         gt.ColorSpace[dst])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_package_layout():
    """The port's io package exports the JAX package's names."""
    from gpujpeg_tpu import io as jio
    from gpujpeg_tpu_torch import io as tio

    for name in ("formats", "image", "pnm", "tst", "y4m", "calculate_size",
                 "load", "probe", "save"):
        assert hasattr(tio, name) and hasattr(jio, name)
    assert os.path.dirname(tio.__file__).endswith("gpujpeg_tpu_torch/io")
