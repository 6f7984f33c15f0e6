"""PyTorch port, host layer: tables, geometry, headers, parameter types and
package isolation, held against the JAX package."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import gpujpeg_tpu as gj
from gpujpeg_tpu.stream import writer as jwriter
from gpujpeg_tpu.utils import geometry as jgeo
from gpujpeg_tpu.utils import tables as jt

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models import encoder as tenc
from gpujpeg_tpu_torch.stream import writer as twriter
from gpujpeg_tpu_torch.utils import geometry as tgeo
from gpujpeg_tpu_torch.utils import tables as tt
from tests import torch_threads  # noqa: F401

QUALITIES = [10, 50, 75, 90, 100]


@pytest.mark.parametrize("q", QUALITIES)
def test_tables_match(q):
    for luma in (True, False):
        qt = tt.quant_table_zz(luma, q)
        assert np.array_equal(qt, jt.quant_table_zz(luma, q))
        m_t, b_t = tt.fdct_fused_matrix(qt)
        m_j, b_j = jt.fdct_fused_matrix(qt)
        assert np.array_equal(m_t, m_j) and np.array_equal(b_t, b_j)
        for cls in ("dc", "ac"):
            bt, vt = tt.huffman_spec_for(cls, luma)
            bj, vj = jt.huffman_spec_for(cls, luma)
            assert np.array_equal(bt, bj) and np.array_equal(vt, vj)
        for fam in ("tuned", "annexk"):
            bt, vt = tt.ac_spec(luma, q, fam)
            bj, vj = jt.ac_spec(luma, q, fam)
            assert np.array_equal(bt, bj) and np.array_equal(vt, vj)
            assert np.array_equal(tt.huffman_encode_lut(bt, vt, 256),
                                  jt.huffman_encode_lut(bj, vj, 256))


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("wh", [(320, 240), (311, 233), (7680, 4320)])
def test_geometry_and_auto_interval_match(q, wh):
    w, h = wh
    frame = np.zeros((h, w, 3), np.uint8)
    g_j = gj.Encoder().resolve(
        frame, gj.Parameters(quality=q, restart_interval=gj.RESTART_AUTO),
        None)
    g_t = tenc.Encoder(device="cpu").resolve(
        frame, gt.Parameters(quality=q, restart_interval=gt.RESTART_AUTO))
    assert g_t.param.restart_interval == g_j.param.restart_interval
    if q == 75:
        assert g_t.param.restart_interval == 8
    assert g_t.segment_count == g_j.segment_count
    assert np.array_equal(g_t.scan_seg_bounds, g_j.scan_seg_bounds)
    assert np.array_equal(g_t.rst_marker, g_j.rst_marker)
    for ct, cj in zip(g_t.components, g_j.components):
        assert (ct.data_width, ct.data_height, ct.mcu_count,
                ct.segment_count, ct.segment_mcu_count, ct.table_index) == \
            (cj.data_width, cj.data_height, cj.mcu_count, cj.segment_count,
             cj.segment_mcu_count, cj.table_index)
    assert twriter.write_header(g_t) == jwriter.write_header(g_j)
    for k in range(g_t.scan_count):
        assert twriter.write_scan_header(g_t, k) == \
            jwriter.write_scan_header(g_j, k)


def test_suggest_restart_interval_match():
    pi = gt.ImageParameters(width=1920, height=1080)
    pj = gj.ImageParameters(width=1920, height=1080)
    for q in range(1, 101):
        for il in (False, True):
            assert tgeo.suggest_restart_interval(pi, 3, False, il, 3, q) \
                == jgeo.suggest_restart_interval(pj, 3, False, il, 3, q)


def test_from_reference_round_trip():
    pj = gj.Parameters(
        quality=83, restart_interval=5, interleaved=True, segment_info=True,
        color_space_internal=gj.ColorSpace.YCBCR_BT709,
        header_type=gj.HeaderType.SPIFF, huffman_tables="annexk"
    ).chroma_subsampled(((2, 2), (1, 1), (1, 1)))
    pt = gt.from_reference(pj)
    assert isinstance(pt, gt.Parameters)
    assert pt.color_space_internal is gt.ColorSpace.YCBCR_BT709
    assert pt.sampling_factor[0] == gt.types.SamplingFactor(2, 2)
    back = gt.from_reference(pt)
    assert back == pt
    for f in ("quality", "restart_interval", "interleaved", "segment_info",
              "comp_count", "huffman_tables"):
        assert getattr(pt, f) == getattr(pj, f)
    assert pt.header_type.name == pj.header_type.name
    ij = gj.ImageParameters(width=64, height=48,
                            color_space=gj.ColorSpace.YCBCR_BT601,
                            pixel_format=gj.PixelFormat.P420_U8_P0P1P2)
    it = gt.from_reference(ij)
    assert it == gt.ImageParameters(
        width=64, height=48, color_space=gt.ColorSpace.YCBCR_BT601,
        pixel_format=gt.PixelFormat.P420_U8_P0P1P2)
    with pytest.raises(TypeError):
        gt.from_reference(object())


def test_package_imports_no_jax():
    code = (
        "import sys\n"
        "import gpujpeg_tpu_torch\n"
        "import gpujpeg_tpu_torch.ops.fusedpack, "
        "gpujpeg_tpu_torch.ops.prepost_kernel, "
        "gpujpeg_tpu_torch.ops._kernels, gpujpeg_tpu_torch.stream.exif\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'gpujpeg_tpu' or m.startswith('gpujpeg_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_encoder_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gt.Encoder()
    assert gt.Encoder(device="cpu").device.type == "cpu"


#: test_outside_main_path_raises' cases
OUTSIDE = ["interleaved", "subsampled", "planar_411", "channel_remap", "grey",
           "rgba", "option"]


def _outside(mod, case):
    """(frame, options, mod.Parameters) of an OUTSIDE case."""
    rng = np.random.default_rng(17)
    frame = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    samp, interleaved, opts = None, False, []
    if case == "interleaved":
        samp, interleaved = ((4, 1), (1, 1), (1, 1)), True
    elif case == "subsampled":
        samp = ((2, 2), (2, 1), (2, 1))
    elif case == "planar_411":
        samp = ((4, 1), (1, 1), (1, 1))
    elif case == "grey":
        frame = frame[..., 0].copy()
    elif case == "rgba":
        frame = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    elif case == "option":
        opts = [("enc_opt_flipped", "true")]
    elif case == "channel_remap":
        opts = [("enc_opt_channel_remap", "210")]
    p = mod.Parameters(quality=75, restart_interval=mod.RESTART_AUTO,
                       interleaved=interleaved)
    return frame, opts, p.chroma_subsampled(samp) if samp else p


def _bytes(enc, frame, opts, p):
    for key, value in opts:
        enc.set_option(key, value)
    return bytes(enc.encode(frame, p))


@pytest.fixture(scope="module")
def jax_outside():
    """The JAX package's bytes of every OUTSIDE case, from one JAX
    encoder an option set (options stay on a session)."""
    encs = {}
    out = {}
    for case in OUTSIDE:
        frame, opts, p = _outside(gj, case)
        enc = encs.get(tuple(opts))
        if enc is None:
            enc = encs[tuple(opts)] = gj.Encoder()
            for key, value in opts:
                enc.set_option(key, value)
        out[case] = _bytes(enc, frame, [], p)
    return out


@pytest.mark.parametrize("case", OUTSIDE)
def test_outside_main_path_raises(jax_outside, case):
    """Layouts and options beyond the first slices' RGB path, which the
    port refused until it took every format: each now gives the JAX
    package's bytes (interleaved 4:1:1, subsampled chroma planes, planar
    4:1:1, a channel remap, greyscale, RGBA with 4 components, a vertical
    flip)."""
    assert _bytes(gt.Encoder(device="cpu"), *_outside(gt, case)) == \
        jax_outside[case]


#: test_encode_options_match_jax's cases: Parameters keywords, enums by name
OPTION_CASES = [dict(segment_info=True),
                dict(header_type="SPIFF", quality=90, restart_interval=3),
                dict(header_type="EXIF", color_space_internal="YCBCR_BT709",
                     quality=40)]


def _option_params(mod, kw):
    k = dict(kw)
    if "header_type" in k:
        k["header_type"] = mod.HeaderType[k["header_type"]]
    if "color_space_internal" in k:
        k["color_space_internal"] = mod.ColorSpace[k["color_space_internal"]]
    k.setdefault("restart_interval", mod.RESTART_AUTO)
    return mod.Parameters(**k)


def test_encode_options_match_jax():
    """Parameters the main path honours besides the defaults, down to the
    headers: APP13 segment info, explicit header types (SPIFF, Exif), an
    explicit restart interval, other qualities and colour spaces.  One
    JAX session for the cases."""
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    jenc = gj.Encoder()
    for kw in OPTION_CASES:
        ref = jenc.encode(frame, _option_params(gj, kw))
        got = gt.Encoder(device="cpu").encode(
            frame, _option_params(gt.types, kw))
        assert got == ref, kw
