"""PyTorch port, the CUDA kernels against their plain versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q

(``--noconftest`` because tests/conftest.py sets JAX up).  The tests marked
``gpu`` decide inside a fixture whether a card exists and skip without one;
the others check, on any machine, that a wrapper never falls back quietly.
"""

import types

import numpy as np
import pytest
import torch

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models import decoder as tdec
from gpujpeg_tpu_torch.ops import _kernels, fusedpack as tfp
from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre
from gpujpeg_tpu_torch.ops import relayout as trel
from gpujpeg_tpu_torch.utils import tables as tt
from tests import scan_rows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frame(h, w, seed, amp=24):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  ((xx + yy) * 255 // (w + h))], -1)
    return np.clip(f + rng.integers(-amp, amp, f.shape), 0, 255) \
        .astype(np.uint8)


def _geo(frame, cs="YCBCR_BT601_256LVLS"):
    return gt.Encoder(device="cpu").resolve(frame, gt.Parameters(
        quality=75, restart_interval=gt.RESTART_AUTO,
        color_space_internal=gt.ColorSpace[cs]))


def _rows_equal(rows, rb, p_rows, p_rb):
    if not torch.equal(rb, p_rb):
        return False
    inside = torch.arange(rows.shape[1], device=rows.device)[None, :] \
        < rb[:, None]
    return torch.equal(rows[inside], p_rows[inside])


def test_nvcc_missing_raises(monkeypatch):
    monkeypatch.setattr(_kernels.shutil, "which", lambda _: None)
    monkeypatch.setattr(_kernels.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.nvcc()


def test_wrappers_refuse_other_devices():
    """Plain versions run only for CPU tensors: a tensor elsewhere goes to
    the kernel path, which takes CUDA tensors only."""
    frame = _frame(16, 16, 0)
    geo = _geo(frame)
    raw = torch.from_numpy(frame).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tpre.preprocess_packed(raw, geo, geo.param_image)
    tabs = tfp.class_tables(75, True, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fdct_quant(torch.empty((16, 16), dtype=torch.uint8,
                                   device="meta"), tabs, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tfp.huffman_segments(torch.empty((1, 512), dtype=torch.int16,
                                         device="meta"), 4, tabs)


def test_pre_vector_choice():
    """The preprocessor wrapper picks the vector instance only where it
    applies: luma at (1, 1), one chroma decimation in {1, 2}^2, W % 16
    == 0, the image 16-byte aligned, planes aligned to their vectors."""
    frame = _frame(32, 48, 0)
    raw = torch.from_numpy(frame)
    base = torch.empty(3 * 64 * 64 + 128, dtype=torch.uint8)
    first = (-base.data_ptr()) % 64

    def planes(geo, skew=0):
        sizes = [c.data_height * c.data_width for c in geo.components]
        start = first + skew
        out = []
        for c, n in zip(geo.components, sizes):
            out.append(base[start:start + n].view(c.data_height,
                                                  c.data_width))
            start += n
        return out

    def vec(samp, raw=raw, skew=0, il=False):
        geo = gt.Encoder(device="cpu").resolve(frame, gt.Parameters(
            quality=75, interleaved=il).chroma_subsampled(samp))
        return tpre.pre_vector(raw, planes(geo, skew),
                               tpre.pre_geometry(geo))

    assert raw.data_ptr() % 16 == 0
    for samp in ("444", "420", "422", "440"):
        assert vec(PRE_SAMPLINGS[samp])
        assert vec(PRE_SAMPLINGS[samp], il=True)
    assert not vec(PRE_SAMPLINGS["mixed"])
    assert not vec(PRE_SAMPLINGS["444"], skew=8)
    assert not vec(PRE_SAMPLINGS["444"],
                   raw=torch.from_numpy(frame[:, :40].copy()))
    off = torch.empty(frame.size + 16, dtype=torch.uint8)
    k = (-off.data_ptr()) % 16 + 1
    assert not vec(PRE_SAMPLINGS["420"],
                   raw=off[k:k + frame.size].view(frame.shape))


def test_decode_wrappers_refuse_other_devices():
    """The decode wrappers, like the encode ones, run their plain versions
    only for CPU tensors and refuse inputs they do not take."""
    meta = lambda *shape, dt=torch.int32: torch.empty(shape, dtype=dt,
                                                      device="meta")
    tab = meta(4, 290)
    rows = [meta(6) for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA"):
        thd.scan_segments(meta(6, 9), *rows, tab, 8)
    with pytest.raises(ValueError, match="CUDA"):
        thd.decode_blocks(meta(6, 9), meta(6, 9), *rows[1:], tab)
    with pytest.raises(ValueError, match="int32"):
        thd.scan_segments(meta(6, 9, dt=torch.int64), *rows, tab, 8)
    with pytest.raises(ValueError, match="tables"):
        thd.decode_blocks(meta(6, 9), meta(6, 9), *rows[1:], meta(4, 17))
    frame = _frame(16, 24, 0)
    data = gt.Encoder(device="cpu").encode(frame, gt.Parameters(quality=75))
    hf = gt.Decoder(device="cpu").prepare(data)
    geo, pi = hf.plan.geo, hf.out_pi
    L = geo.segment_count * geo.max_blocks_per_seg
    with pytest.raises(ValueError, match="CUDA"):
        tpre.decode_post(meta(64, L, dt=torch.int16),
                         meta(3, 64, dt=torch.float32), geo, pi)
    with pytest.raises(ValueError, match="int16"):
        tpre.decode_post(meta(64, L + 1, dt=torch.int16),
                         meta(3, 64, dt=torch.float32), geo, pi)


def _il_params(samp=((2, 2), (1, 1), (1, 1)), quality=75,
               rst=gt.RESTART_AUTO):
    return gt.Parameters(quality=quality, restart_interval=rst,
                         interleaved=True).chroma_subsampled(samp)


def test_interleaved_wrappers_refuse_other_devices():
    """The wrappers of the interleaved path run their plain versions only
    for CPU tensors and refuse inputs they do not take."""
    meta = lambda *shape, dt=torch.int32: torch.empty(shape, dtype=dt,
                                                      device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfp.pack_stuff_rows(meta(5, 64), meta(5, 64), meta(5), 64)
    with pytest.raises(ValueError, match="markers"):
        tfp.pack_stuff_rows(meta(5, 64), meta(5, 64), meta(4), 64)
    frame = _frame(48, 64, 0)
    enc = gt.Encoder(device="cpu")
    geo = enc.resolve(frame, _il_params())
    with pytest.raises(ValueError, match="CUDA"):
        tpre.preprocess_packed(torch.from_numpy(frame).to("meta"), geo,
                               geo.param_image)
    data = enc.encode(frame, _il_params())
    hf = gt.Decoder(device="cpu").prepare(data)
    geo, pi = hf.plan.geo, hf.out_pi
    L = geo.segment_count * geo.max_blocks_per_seg
    with pytest.raises(ValueError, match="CUDA"):
        tpre.idct_planes(meta(64, L, dt=torch.int16),
                         meta(3, 64, dt=torch.float32), geo)
    with pytest.raises(ValueError, match="int16"):
        tpre.idct_planes(meta(64, L - 1, dt=torch.int16),
                         meta(3, 64, dt=torch.float32), geo)
    with pytest.raises(ValueError, match="quant tables"):
        tpre.idct_planes(meta(64, L, dt=torch.int16),
                         meta(64, dt=torch.float32), geo)
    planes = [meta(k.data_height, k.data_width, dt=torch.uint8)
              for k in geo.components]
    with pytest.raises(ValueError, match="CUDA"):
        tpre.postprocess_packed(planes, geo, pi)
    with pytest.raises(ValueError, match="uint8 plane"):
        tpre.postprocess_packed(planes[:1] * 3, geo, pi)
    with pytest.raises(ValueError, match="slot pattern"):
        thd.scan_segments(meta(6, 9), *[meta(6) for _ in range(4)],
                          meta(4, 290), 8, (6, 64, 15))


def test_decoder_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.Decoder()


class _FailingLib:
    """Stands in for a kernel library whose launch is refused."""

    def __getattr__(self, name):
        return lambda *args: 98          # cudaErrorInvalidDeviceFunction


@pytest.mark.parametrize("name", ["huffdec_scan", "huffdec_scan_sync",
                                  "huffdec_block",
                                  "huffdec_block_direct", "dpost_rgb",
                                  "pack_stuff_rows", "pack_stuff_scan",
                                  "idct_planes", "post_rgb", "xbd_relayout",
                                  "transpose_u32", "pair_sum_rows",
                                  "pack_u8_quads"])
def test_failed_launch_raises(monkeypatch, name):
    """A launch error is raised, never swallowed, and is not counted."""
    import contextlib
    import types

    monkeypatch.setattr(_kernels, "_lib", lambda n: _FailingLib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    _kernels.reset_launches()
    x = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match=f"{name} failed to launch"):
        _kernels.launch(name, x, 1)
    assert _kernels.LAUNCHES[name] == 0


def _stream(kind, h, w, quality=75, seed=0):
    frame = (np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                  dtype=np.uint8)
             if kind == "noise" else _frame(h, w, seed))
    return frame, gt.Encoder(device="cpu").encode(
        frame, gt.Parameters(quality=quality,
                             restart_interval=gt.RESTART_AUTO))


def _device_frame(data, cuda):
    hf = gt.Decoder(device=cuda).prepare(data)
    p = hf.plan
    words = torch.from_numpy(hf.words).to(cuda)
    nbits = torch.from_numpy(hf.nbits).to(cuda)
    return hf, p, words, nbits


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gradient", "noise"])
def test_huffdec_kernels_match_plain(cuda, kind):
    _, data = _stream(kind, 1080, 1920)
    hf, p, words, nbits = _device_frame(data, cuda)
    args = (p.nblocks, p.dc_luma, p.ac_luma, p.tables)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="lut"):
        thd.scan_segments(words, nbits, *args, p.bps)
    bstart, err_a = thd.scan_segments(words, nbits, *args, p.bps,
                                      lut=p.scan_lut)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffdec_scan"] == 1
    p_bstart, p_err_a = thd.scan_segments_plain(words, nbits, *args, p.bps)
    assert torch.equal(bstart, p_bstart) and torch.equal(err_a, p_err_a)
    assert not bool(err_a.any())
    with pytest.raises(ValueError, match="lut"):
        thd.decode_blocks(words, bstart, *args)
    coefs, err_c = thd.decode_blocks(words, bstart, *args, lut=p.block_lut)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffdec_block"] == 1
    p_coefs, p_err_c = thd.decode_blocks_plain(words, bstart, *args)
    assert torch.equal(coefs, p_coefs) and torch.equal(err_c, p_err_c)
    assert not bool(err_c.any())


@pytest.mark.gpu
def test_huffdec_kernels_corrupt_segment(cuda):
    _, data = _stream("noise", 64, 80, seed=3)
    hf, p, words, nbits = _device_frame(data, cuda)
    w = words.clone()
    w[9, 1] ^= 0x5A5A5A5A                     # flip bits in segment 9
    nbits = nbits.clone()
    nbits[5] //= 2                            # cut segment 5 short
    args = (p.nblocks, p.dc_luma, p.ac_luma, p.tables)
    bstart, err_a = thd.scan_segments(w, nbits, *args, p.bps,
                                      lut=p.scan_lut)
    p_bstart, p_err_a = thd.scan_segments_plain(w, nbits, *args, p.bps)
    assert torch.equal(bstart, p_bstart) and torch.equal(err_a, p_err_a)
    coefs, err_c = thd.decode_blocks(w, bstart, *args, lut=p.block_lut)
    p_coefs, p_err_c = thd.decode_blocks_plain(w, bstart, *args)
    assert torch.equal(coefs, p_coefs) and torch.equal(err_c, p_err_c)
    assert bool(err_a[5])


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(1080, 1920), (233, 311), (64, 80),
                                (400, 1344)])
def test_dpost_kernel_matches_plain(cuda, hw):
    _, data = _stream("gradient", *hw)
    dec = gt.Decoder(device=cuda)
    hf = dec.prepare(data)
    coefs_t, _ea, _ec = dec.coefficients_t(hf)
    geo = hf.plan.geo
    _kernels.reset_launches()
    got = tpre.decode_post(coefs_t, hf.plan.qtabs, geo, hf.out_pi)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["dpost_rgb"] == 1
    assert got.shape == (*hw, 3)
    ref = tpre.decode_post_plain(coefs_t, hf.plan.qtabs, geo, hf.out_pi)
    assert torch.equal(got, ref)
    # dense random coefficients: every rounding boundary of the chain
    rnd = torch.randint(-600, 600, coefs_t.shape, dtype=torch.int16,
                        generator=torch.Generator().manual_seed(7)).to(cuda)
    assert torch.equal(
        tpre.decode_post(rnd, hf.plan.qtabs, geo, hf.out_pi),
        tpre.decode_post_plain(rnd, hf.plan.qtabs, geo, hf.out_pi))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,hw,quality", [
    ("gradient", (1080, 1920), 75), ("noise", (233, 311), 75),
    ("gradient", (64, 80), 98)])
def test_decode_on_card_matches_cpu(cuda, kind, hw, quality):
    """The card's pixels are the CPU's; at Q98 (one block a segment) the
    decode takes the direct route: phase C's direct instance, no phase A,
    no fix-up."""
    frame, data = _stream(kind, *hw, quality=quality, seed=9)
    _kernels.reset_launches()
    got = gt.Decoder(device=cuda).decode(data)
    direct = quality >= 97
    ran = (("huffdec_block_direct", "dpost_rgb") if direct else
           ("huffdec_scan", "huffdec_block", "dc_fixup", "dpost_rgb"))
    for name in ran:
        assert _kernels.LAUNCHES[name] == 1, _kernels.LAUNCHES
    if direct:
        assert _kernels.LAUNCHES["huffdec_scan"] == \
            _kernels.LAUNCHES["huffdec_block"] == \
            _kernels.LAUNCHES["dc_fixup"] == 0
    assert np.array_equal(got, gt.Decoder(device="cpu").decode(data))
    assert got.shape == frame.shape


@pytest.mark.gpu
@pytest.mark.parametrize("cs", ["YCBCR_BT601_256LVLS", "YCBCR_BT709",
                                "RGB"])
def test_pre_kernel_matches_plain(cuda, cs):
    frame = _frame(1080, 1916, 1, amp=128)
    geo = _geo(frame, cs)
    raw = torch.from_numpy(frame).to(cuda)
    _kernels.reset_launches()
    got = tpre.preprocess_packed(raw, geo, geo.param_image)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pre_rgb_to_planes"] == 1
    ref = tpre.preprocess_packed_plain(raw, geo, geo.param_image)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gradient", "noise"])
def test_fdct_kernel_matches_plain(cuda, kind):
    rng = np.random.default_rng(5)
    plane = (rng.integers(0, 256, (1080, 1920), dtype=np.uint8)
             if kind == "noise" else _frame(1080, 1920, 5)[..., 0])
    x = torch.from_numpy(np.ascontiguousarray(plane)).to(cuda)
    for luma in (True, False):
        tabs = tfp.class_tables(75, luma, cuda)
        _kernels.reset_launches()
        got = tfp.fdct_quant(x, tabs, 8)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["fdct_quant"] == 1
        assert got.shape == ((135 * 240 + 7) // 8, 512)
        assert torch.equal(got, tfp.fdct_quant_plain(x, tabs, 8))


def _plane(kind, h, w, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), dtype=np.uint8) if kind == "noise"
            else np.ascontiguousarray(_frame(h, w, seed)[..., 0]))


#: (data_h, data_w, rst): one block; a 16-byte row (two blocks a copy);
#: 8-byte rows (the padded 233x311); HD; a width of 67 blocks, no multiple
#: of the 64-block tile; a segment longer than the plane (pad blocks)
FDCT_PLANES = [(8, 8, 8), (48, 80, 1), (240, 312, 8), (1080, 1920, 8),
               (40, 536, 3), (48, 80, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gradient", "noise"])
@pytest.mark.parametrize("h,w,rst", FDCT_PLANES)
def test_fdct_kernel_tile_edges(cuda, kind, h, w, rst):
    x = torch.from_numpy(_plane(kind, h, w)).to(cuda)
    for luma in (True, False):
        tabs = tfp.class_tables(75, luma, cuda)
        _kernels.reset_launches()
        got = tfp.fdct_quant(x, tabs, rst)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["fdct_quant"] == 1
        assert got.shape == (-(-(h // 8) * (w // 8) // rst), rst * 64)
        assert torch.equal(got, tfp.fdct_quant_plain(x, tabs, rst))


@pytest.mark.gpu
def test_fdct_kernel_pad_segments_and_alignment(cuda):
    """Whole pad segments past the plane's blocks are written as 0, and a
    plane whose rows are 16-byte multiples but whose base is not takes the
    8-byte copies."""
    h, w = 48, 96
    nblocks = (h // 8) * (w // 8)
    flat = torch.from_numpy(_plane("noise", 1, 8 + h * w).reshape(-1)).to(
        cuda)
    x = flat[8:].view(h, w)                        # base 8 bytes off
    assert x.data_ptr() % 16 == 8
    tabs = tfp.class_tables(75, True, cuda)
    ref = tfp.fdct_quant_plain(x, tabs, 8).reshape(-1, 64)
    nout = nblocks + 200                           # 25 pad segments of 8
    out = torch.full((nout, 64), 7, dtype=torch.int16, device=cuda)
    _kernels.reset_launches()
    _kernels.launch("fdct_quant", x, h, w, nout, 1, 0, 1, 1, w // 8,
                    tabs.mq, tabs.bias, out)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fdct_quant"] == 1
    assert torch.equal(out[:nblocks], ref)
    assert not bool(out[nblocks:].any())
    assert torch.equal(tfp.fdct_quant(x, tabs, 8).reshape(-1, 64), ref)


@pytest.mark.gpu
def test_huffman_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    S, B = 4000, 8
    nblocks = S * B - 5
    coefs = rng.integers(-200, 200, (S, B, 64)).astype(np.int16)
    coefs = np.where(rng.random((S, B, 64)) < 0.85, 0, coefs)
    coefs[100:200] = rng.integers(-1023, 1024, (100, B, 64))  # dense rows
    coefs[300, 1, 1:] = 0
    coefs[300, 1, 40] = 3                                     # 2 ZRL
    coefs.reshape(-1, 64)[nblocks:] = 0
    x = torch.from_numpy(coefs.reshape(S, B * 64)).to(cuda)
    for luma in (True, False):
        tabs = tfp.class_tables(75, luma, cuda)
        _kernels.reset_launches()
        rows, rb, needs = tfp.huffman_segments(x, nblocks, tabs)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["huffman_segments"] == 1
        p_rows, p_rb, p_needs = tfp.huffman_segments_plain(x, nblocks, tabs)
        assert torch.equal(needs, p_needs)
        assert _rows_equal(rows, rb, p_rows, p_rb)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(1080, 1920), (233, 311)])
def test_entropy_kernels_match_plain(cuda, hw):
    frame = _frame(*hw, 3)
    geo = _geo(frame)
    planes = tpre.preprocess_packed_plain(torch.from_numpy(frame).to(cuda),
                                          geo, geo.param_image)
    for c in geo.components:
        tabs = tfp.class_tables(75, c.table_index == 0, cuda)
        rst = c.segment_mcu_count
        rows, rb, needs = tfp.entropy_fused_u8(planes[c.index], tabs, rst)
        coefs = tfp.fdct_quant_plain(planes[c.index], tabs, rst)
        p_rows, p_rb, p_needs = tfp.huffman_segments_plain(
            coefs, c.mcu_count, tabs)
        assert torch.equal(needs, p_needs)
        assert _rows_equal(rows, rb, p_rows, p_rb)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(240, 320), (233, 311), (64, 64), (48, 80)])
def test_encode_on_card_matches_cpu(cuda, hw):
    frame = _frame(*hw, 8, amp=128)
    p = gt.Parameters(quality=75, restart_interval=gt.RESTART_AUTO)
    _kernels.reset_launches()
    got = gt.Encoder(device=cuda).encode(frame, p)
    assert all(_kernels.LAUNCHES[n] > 0 for n in (
        "pre_rgb_to_planes", "fdct_quant", "huffman_segments")), \
        _kernels.LAUNCHES
    assert got == gt.Encoder(device="cpu").encode(frame, p)


def _il_stream(samp, hw, kind="gradient", quality=75, rst=gt.RESTART_AUTO,
               seed=0):
    frame = (np.random.default_rng(seed).integers(0, 256, (*hw, 3),
                                                  dtype=np.uint8)
             if kind == "noise" else _frame(*hw, seed))
    return frame, gt.Encoder(device="cpu").encode(
        frame, _il_params(samp, quality, rst))


SAMPLINGS = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
             "440": ((1, 2), (1, 1), (1, 1))}


@pytest.mark.gpu
@pytest.mark.parametrize("samp", list(SAMPLINGS))
@pytest.mark.parametrize("hw", [(1080, 1920), (233, 311)])
def test_pre_kernel_decimates_like_plain(cuda, samp, hw):
    frame = _frame(*hw, 2, amp=128)
    geo = gt.Encoder(device="cpu").resolve(frame, _il_params(SAMPLINGS[samp]))
    raw = torch.from_numpy(frame).to(cuda)
    _kernels.reset_launches()
    got = tpre.preprocess_packed(raw, geo, geo.param_image)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pre_rgb_to_planes"] == 1   # every plane
    ref = tpre.preprocess_packed_plain(raw, geo, geo.param_image)
    for c, a, b in zip(geo.components, got, ref):
        assert a.shape == (c.data_height, c.data_width)
        assert torch.equal(a, b)


def _token_rows(rng, R, T, ff_bias=False, empty=None):
    """Random token rows: about half the slots a token of 1..27 bits (all
    ones with ff_bias: runs of 0xFF bytes), row 3 empty, and rows `empty`
    (a slice) empty too; no marker after every third row."""
    lens = rng.integers(1, 28, (R, T))
    lens = np.where(rng.random((R, T)) < 0.5, 0, lens)
    bits = rng.integers(0, 1 << 27, (R, T))
    if ff_bias:
        bits = (1 << 27) - 1             # all-ones tokens: runs of 0xFF
    bits = bits & ((1 << lens) - 1)
    lens[3 % R] = 0                      # an empty row
    if empty is not None:
        lens[empty] = 0
    markers = np.where(np.arange(R) % 3 == 2, 0, 0xD0 + np.arange(R) % 8)
    return (torch.from_numpy(bits.astype(np.int32)),
            torch.from_numpy(lens.astype(np.int32)),
            torch.from_numpy(markers.astype(np.int32)))


def _pack_stride(T):
    """A worst case for a row of T tokens of 27 bits: doubled for
    stuffing, plus the marker, rounded up to 16 (as fusedpack.pack_stride)."""
    return -(-(2 * -(-T * 27 // 8) + 2) // 16) * 16


@pytest.mark.gpu
@pytest.mark.parametrize("R,T,ff_bias,empty", [
    (3000, 384, False, None), (3000, 384, True, None),
    (150_001, 4, False, None), (1001, 512, False, None),
    (97, 4096, False, None), (97, 4096, True, None),
    (2000, 384, False, slice(256, 1500))])
def test_pack_stuff_rows_matches_plain(cuda, R, T, ff_bias, empty):
    """The warp-a-row packer against the plain version: the 4:2:0 and
    planar 4:4:4 luma row widths, T = 4, rows longer than the warp's bit
    buffer (T = 4096, all-ones tokens across its flushes), more rows than
    the persistent grid has warps, and a block of empty rows."""
    rng = np.random.default_rng(11 + T)
    bits, lens, markers = _token_rows(rng, R, T, ff_bias, empty)
    stride = _pack_stride(T)
    bits, lens, markers = bits.to(cuda), lens.to(cuda), markers.to(cuda)
    _kernels.reset_launches()
    rows, rb, needs = tfp.pack_stuff_rows(bits, lens, markers, stride)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pack_stuff_rows"] == 1
    p_rows, p_rb, p_needs = tfp.pack_stuff_rows_plain(bits, lens, markers,
                                                      stride)
    assert torch.equal(needs, p_needs)
    assert _rows_equal(rows, rb, p_rows, p_rb)
    assert int(needs[0]) > 0
    if empty is not None:                # an empty row is its marker only
        assert set(rb[empty].tolist()) == {0, 2}


@pytest.mark.gpu
def test_pack_stuff_rows_64bit_offsets(cuda):
    """Rows whose byte offsets pass 2^31: the last rows equal the plain
    version of the same rows packed alone."""
    R, T, stride = 70_000_000, 4, 32
    lens = torch.zeros((R, T), dtype=torch.int32, device=cuda)
    bits = torch.zeros((R, T), dtype=torch.int32, device=cuda)
    markers = torch.full((R,), 0xD3, dtype=torch.int32, device=cuda)
    tail = slice(R - 1000, R)
    rng = np.random.default_rng(5)
    b, ln, _ = _token_rows(rng, 1000, T, ff_bias=False)
    bits[tail], lens[tail] = b.to(cuda), ln.to(cuda)
    rows, rb, needs = tfp.pack_stuff_rows(bits, lens, markers, stride)
    torch.cuda.synchronize()
    assert R * stride > 1 << 31
    p_rows, p_rb, p_needs = tfp.pack_stuff_rows_plain(
        bits[tail], lens[tail], markers[tail], stride)
    assert _rows_equal(rows[tail], rb[tail], p_rows, p_rb)
    assert torch.equal(needs, p_needs)
    assert bool((rb[:R - 1000] == 2).all())


@pytest.mark.gpu
def test_pack_stuff_rows_probe_uncounted(cuda):
    """The packer's probe stages: the full stage equals the kernel, the
    cut stages launch, and none is counted."""
    rng = np.random.default_rng(17)
    bits, lens, markers = (t.to(cuda) for t in _token_rows(rng, 777, 384))
    stride = _pack_stride(384)
    want = tfp.pack_stuff_rows(bits, lens, markers, stride)
    _kernels.reset_launches()
    for stage in _kernels.PROBE_STAGES:
        got = tfp.pack_stuff_rows_probe(bits, lens, markers, stride, stage)
        torch.cuda.synchronize()
        if stage == "full":
            assert torch.equal(got[2], want[2])
            assert _rows_equal(got[0], got[1], want[0], want[1])
    assert _kernels.LAUNCHES["pack_stuff_rows"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("samp,kind", [("420", "gradient"), ("420", "noise"),
                                       ("422", "gradient")])
def test_huffdec_kernels_pattern_mode(cuda, samp, kind):
    _, data = _il_stream(SAMPLINGS[samp], (1080, 1920), kind)
    hf, p, words, nbits = _device_frame(data, cuda)
    assert p.pattern[0] == 4 + 2 if samp == "420" else p.pattern[0] == 4
    args = (p.nblocks, p.dc_luma, p.ac_luma, p.tables)
    _kernels.reset_launches()
    bstart, err_a = thd.scan_segments(words, nbits, *args, p.bps, p.pattern,
                                      p.scan_lut)
    coefs, err_c = thd.decode_blocks(words, bstart, *args, p.pattern,
                                     p.block_lut)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffdec_scan"] == 1
    assert _kernels.LAUNCHES["huffdec_block"] == 1
    p_bstart, p_err_a = thd.scan_segments_plain(words, nbits, *args, p.bps,
                                                p.pattern)
    p_coefs, p_err_c = thd.decode_blocks_plain(words, bstart, *args,
                                               p.pattern)
    assert torch.equal(bstart, p_bstart) and torch.equal(err_a, p_err_a)
    assert torch.equal(coefs, p_coefs) and torch.equal(err_c, p_err_c)
    assert not bool(err_a.any()) and not bool(err_c.any())
    w = words.clone()
    w[w.shape[0] // 2, 1] ^= 0x5A5A5A5A        # damage one segment
    bstart, err_a = thd.scan_segments(w, nbits, *args, p.bps, p.pattern,
                                      p.scan_lut)
    p_bstart, p_err_a = thd.scan_segments_plain(w, nbits, *args, p.bps,
                                                p.pattern)
    assert torch.equal(bstart, p_bstart) and torch.equal(err_a, p_err_a)
    coefs, err_c = thd.decode_blocks(w, bstart, *args, p.pattern,
                                     p.block_lut)
    p_coefs, p_err_c = thd.decode_blocks_plain(w, bstart, *args, p.pattern)
    assert torch.equal(coefs, p_coefs) and torch.equal(err_c, p_err_c)


def _scan_both(cuda, rows_args, tab, bps, pattern=thd.NO_PATTERN,
               offset=0, instance=None):
    """The scan kernel and the plain scan on the same rows (words, nbits,
    nblocks, dc_luma, ac_luma as numpy arrays): equal bstart and err,
    which are returned.  offset puts the card's word matrix that many
    words past a 16-byte boundary; the kernel's instance is the one
    scan_instance picks, or `instance`."""
    words, nbits, nb, dcl, acl = (torch.from_numpy(np.ascontiguousarray(
        a, np.int32)) for a in rows_args)
    buf = torch.zeros(words.numel() + 4, dtype=torch.int32, device=cuda)
    w_dev = buf[offset:offset + words.numel()].view(words.shape)
    w_dev.copy_(words)
    assert w_dev.data_ptr() % 16 == 4 * offset
    args = [a.to(cuda) for a in (nbits, nb, dcl, acl)]
    _kernels.reset_launches()
    lut = torch.from_numpy(thd.scan_lut(tab.numpy())).to(cuda)
    got = thd.scan_segments(w_dev, *args, tab.to(cuda), bps, pattern, lut,
                            instance)
    torch.cuda.synchronize()
    inst = instance or thd.scan_instance(*words.shape)
    assert _kernels.INSTANCES == {f"huffdec_scan/{inst}": 1}
    assert _kernels.LAUNCHES["huffdec_scan" if inst == "serial"
                             else "huffdec_scan_sync"] == 1
    want = thd.scan_segments_plain(words, nbits, nb, dcl, acl, tab, bps,
                                   pattern)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    return want


def _scan_tabs(seed):
    """Table set 0 with codes of 2-16 bits (most AC codes of 10 or more, so
    the lookahead table sends them to the canonical decode), set 1
    Annex-K chroma."""
    return [scan_rows.long_code_tables(seed),
            (tt.huffman_spec_for("dc", False),
             tt.huffman_spec_for("ac", False))]


@pytest.mark.gpu
@pytest.mark.parametrize("bps,W", [(1, 5), (2, 37), (8, 130), (40, 301),
                                   (100, None)])
def test_scan_kernel_coded_rows(cuda, bps, W):
    """Rows longer than the bit window and its prefetch (W up to a few
    hundred words, W % 4 != 0, so rows start at every word of a 16-byte
    quad), rows of bstart from 2 to 101 words, nblocks from 0 to bps, long
    codes: bit for bit the plain scan, no error."""
    rng = np.random.default_rng(bps)
    tabs = _scan_tabs(bps)
    nseg = 300
    nblocks = rng.integers(0, bps + 1, nseg)
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, bps, tabs, flags=(rng.integers(0, 2, nseg),
                                     rng.integers(0, 2, nseg)),
        nblocks=nblocks, long_share=0.4)
    W = max(max(-(-len(r) // 4) for r in rows), W or 0)
    words, nbits = scan_rows.word_matrix(rows, W + (W % 4 == 0))
    _, err = _scan_both(cuda, (words, nbits, nb, dcl, acl),
                        scan_rows.decode_tables(tabs), bps)
    assert not bool(err.any())


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 2, 3, 5, 7, 64])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_scan_kernel_random_words(cuda, W, offset):
    """Random rows (mostly bad tokens: invalid codes, runs past 63, bits
    past nbits), random bit counts including 0, nblocks from 0 to bps, a
    random slot pattern, the word matrix off 16-byte alignment: bit for
    bit the plain scan."""
    rng = np.random.default_rng(100 * W + offset)
    nseg, bps = 777, 6
    bpm = int(rng.integers(1, 11))
    pattern = (bpm, int(rng.integers(0, 1 << bpm)),
               int(rng.integers(0, 1 << bpm)))
    words = rng.integers(-(1 << 31), 1 << 31, (nseg, W))
    nbits = rng.integers(0, 32 * W + 1, nseg)
    nbits[::7] = 0
    _scan_both(cuda, (words, nbits, rng.integers(0, bps + 1, nseg),
                      rng.integers(0, 2, nseg), rng.integers(0, 2, nseg)),
               scan_rows.decode_tables(_scan_tabs(W)), bps, pattern,
               offset)


@pytest.mark.gpu
def test_scan_kernel_error_kinds(cuda):
    """Each error kind on coded rows: an invalid code, a token ending past
    nbits, a run past coefficient 63, a segment short of its blocks; and
    empty segments, expected empty or not."""
    rng = np.random.default_rng(7)
    tabs = _scan_tabs(7)
    nseg, bps = 10, 4
    rows, nb, dcl, acl = scan_rows.segment_rows(rng, nseg, bps, tabs,
                                                bad_run=(3,))
    words, nbits = scan_rows.word_matrix(
        rows, max(len(r) for r in rows) // 4 + 3)
    words[1, 0] = -1                    # 32 one bits: no valid code
    nbits[2] -= 9                       # the last token ends past nbits
    nb[4] = bps + 1                     # one block more than coded
    words[5], nbits[5], nb[5] = 0, 0, 0
    nbits[6], nb[6] = 0, 1
    _, err = _scan_both(cuda, (words, nbits, nb, dcl, acl),
                        scan_rows.decode_tables(tabs), bps + 1)
    assert err.tolist() == [False, True, True, True, True, False, True,
                            False, False, False]


@pytest.mark.gpu
@pytest.mark.parametrize("bpm", list(range(1, 11)))
def test_scan_kernel_slot_patterns(cuda, bpm):
    """Slot patterns of 1-10 slots with random masks and segment flags,
    rows of whole and partial MCUs: bit for bit the plain scan, no
    error."""
    rng = np.random.default_rng(bpm)
    tabs = _scan_tabs(bpm + 20)
    nseg, bps = 200, 3 * bpm
    pattern = (bpm, int(rng.integers(0, 1 << bpm)),
               int(rng.integers(0, 1 << bpm)))
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern,
        (rng.integers(0, 2, nseg), rng.integers(0, 2, nseg)),
        rng.integers(0, bps + 1, nseg))
    words, nbits = scan_rows.word_matrix(rows)
    _, err = _scan_both(cuda, (words, nbits, nb, dcl, acl),
                        scan_rows.decode_tables(tabs), bps, pattern)
    assert not bool(err.any())


def _block_both(cuda, words, bstart, nb, dcl, acl, tab,
                pattern=thd.NO_PATTERN, offset=0):
    """The block kernel and the plain block decode on the same rows (numpy
    words, bstart, nblocks, dc_luma, ac_luma): equal coefficients and err,
    which are returned.  offset puts the card's word matrix that many
    words past a 16-byte boundary."""
    words = torch.from_numpy(np.ascontiguousarray(words, np.int32))
    buf = torch.zeros(words.numel() + 4, dtype=torch.int32, device=cuda)
    w_dev = buf[offset:offset + words.numel()].view(words.shape)
    w_dev.copy_(words)
    rows = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (bstart, nb, dcl, acl)]
    lut = torch.from_numpy(thd.block_lut(tab.numpy())).to(cuda)
    _kernels.reset_launches()
    got = thd.decode_blocks(w_dev, *[r.to(cuda) for r in rows],
                            tab.to(cuda), pattern, lut)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffdec_block"] == 1
    want = thd.decode_blocks_plain(words, *rows, tab, pattern)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    return want


def _coded_blocks(seed, nseg, bps, pattern, long_share=0.4):
    """Coded rows with long codes, random segment flags and ragged block
    counts, and phase A's bstart of them (the plain scan): (words, bstart,
    nblocks, dc_luma, ac_luma, tables)."""
    rng = np.random.default_rng(seed)
    tabs = _scan_tabs(seed)
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern,
        (rng.integers(0, 2, nseg), rng.integers(0, 2, nseg)),
        rng.integers(0, bps + 1, nseg), long_share=long_share)
    words, nbits = scan_rows.word_matrix(rows)
    tab = scan_rows.decode_tables(tabs)
    bstart, err = thd.scan_segments_plain(
        *(torch.from_numpy(np.asarray(a, np.int32))
          for a in (words, nbits, nb, dcl, acl)), tab, bps, pattern)
    assert not bool(err.any())
    return words, bstart.numpy(), nb, dcl, acl, tab


@pytest.mark.gpu
@pytest.mark.parametrize("bps,nseg,bpm", [(1, 300, 1), (6, 211, 6),
                                          (8, 300, 4), (10, 97, 10),
                                          (40, 50, 4), (7, 3, 7)])
def test_block_kernel_coded_rows(cuda, bps, nseg, bpm):
    """Coded rows with long codes (the canonical decode and values from
    the window), slot patterns, ragged nblocks; segments that cross a
    warp's 32-block tile (bps 6, 10, 40), block counts L that are not a
    multiple of 8 (the 2-byte store path) or below one tile: bit for bit
    the plain decode, no error."""
    rng = np.random.default_rng(bps)
    pattern = (bpm, int(rng.integers(0, 1 << bpm)),
               int(rng.integers(0, 1 << bpm)))
    words, bstart, nb, dcl, acl, tab = _coded_blocks(bps + 50, nseg, bps,
                                                     pattern)
    coefs, err = _block_both(cuda, words, bstart, nb, dcl, acl, tab,
                             pattern)
    assert not bool(err.any()) and bool(coefs.any())


@pytest.mark.gpu
def test_block_kernel_error_kinds(cuda):
    """Each error kind (scan_rows.block_error_rows): an invalid code at a
    DC and after a good DC, a DC symbol above 15, a token past the block's
    end at DC and at AC, a run past coefficient 63; a block ending right
    after its DC and slots past nblocks: bit for bit the plain decode."""
    words, bstart, nb, tab, want = scan_rows.block_error_rows()
    ones = np.ones(len(nb), np.int32)
    _, err = _block_both(cuda, words, bstart, nb, ones, ones, tab)
    assert err.view(len(nb), 3).tolist() == want


@pytest.mark.gpu
def test_block_kernel_shifted_starts(cuda):
    """Blocks started a few bits off phase A's boundaries (garbage:
    invalid codes, overruns, runs past 63 at every bit phase): bit for bit
    the plain decode."""
    pattern = (6, 0b001111, 0b001111)
    words, bstart, nb, dcl, acl, tab = _coded_blocks(9, 400, 12, pattern)
    rng = np.random.default_rng(9)
    bstart[:, :-1] += rng.integers(-3, 4, bstart[:, :-1].shape)
    bstart = np.clip(bstart, 0, 32 * words.shape[1])
    _, err = _block_both(cuda, words, bstart, nb, dcl, acl, tab, pattern)
    assert bool(err.any()) and not bool(err.all())


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 3, 64])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_block_kernel_random_words(cuda, W, offset):
    """Random rows and random ascending block boundaries in [0, 32 W]
    (mostly bad tokens), nblocks from 0 to bps, a random slot pattern, the
    word matrix off 16-byte alignment: bit for bit the plain decode."""
    rng = np.random.default_rng(10 * W + offset)
    nseg, bps = 333, 5
    bpm = int(rng.integers(1, 11))
    pattern = (bpm, int(rng.integers(0, 1 << bpm)),
               int(rng.integers(0, 1 << bpm)))
    words = rng.integers(-(1 << 31), 1 << 31, (nseg, W))
    bstart = np.sort(rng.integers(0, 32 * W + 1, (nseg, bps + 1)), axis=1)
    _block_both(cuda, words, bstart, rng.integers(0, bps + 1, nseg),
                rng.integers(0, 2, nseg), rng.integers(0, 2, nseg),
                scan_rows.decode_tables(_scan_tabs(W)), pattern, offset)


PRE_SAMPLINGS = {"444": ((1, 1), (1, 1), (1, 1)),
                 "420": ((2, 2), (1, 1), (1, 1)),
                 "422": ((2, 1), (1, 1), (1, 1)),
                 "440": ((1, 2), (1, 1), (1, 1)),
                 "mixed": ((2, 2), (2, 1), (1, 1))}


def _pre_both(cuda, frame, geo, raw=None):
    """One preprocessor launch on the card against the plain version;
    returns whether the vector instance ran."""
    raw = torch.from_numpy(frame).to(cuda) if raw is None else raw
    _kernels.reset_launches()
    got = tpre.preprocess_packed(raw, geo, geo.param_image)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pre_rgb_to_planes"] == 1
    ref = tpre.preprocess_packed_plain(raw, geo, geo.param_image)
    for c, a, b in zip(geo.components, got, ref):
        assert a.shape == (c.data_height, c.data_width)
        assert torch.equal(a, b)
    return tpre.pre_vector(raw, got, tpre.pre_geometry(geo))


@pytest.mark.gpu
@pytest.mark.parametrize("samp", list(PRE_SAMPLINGS))
@pytest.mark.parametrize("hw", [(233, 311), (240, 320), (64, 72)])
@pytest.mark.parametrize("interleaved", [False, True])
def test_pre_kernel_one_launch(cuda, samp, hw, interleaved):
    """Every plane of a frame in one launch at each (dx, dy) in {1, 2}^2
    and at mixed chroma decimations, planar and interleaved padding,
    widths that are and are not a multiple of 16: bit for bit the plain
    version; the vector instance runs exactly where W % 16 == 0 and the
    chroma planes share one decimation."""
    frame = _frame(*hw, 4, amp=128)
    geo = gt.Encoder(device="cpu").resolve(frame, gt.Parameters(
        quality=75, restart_interval=gt.RESTART_AUTO,
        interleaved=interleaved).chroma_subsampled(PRE_SAMPLINGS[samp]))
    vec = _pre_both(cuda, frame, geo)
    assert vec == (hw[1] % 16 == 0 and samp != "mixed")


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["444", "420"])
def test_pre_kernel_misaligned_raw(cuda, samp):
    """An image that is a view 1 byte past a 16-byte boundary takes the
    generic instance: bit for bit the plain version."""
    frame = _frame(240, 320, 6, amp=128)
    geo = gt.Encoder(device="cpu").resolve(frame, gt.Parameters(
        quality=75, restart_interval=gt.RESTART_AUTO).chroma_subsampled(
        PRE_SAMPLINGS[samp]))
    buf = torch.zeros(frame.size + 16, dtype=torch.uint8, device=cuda)
    raw = buf[1:1 + frame.size].view(frame.shape)
    raw.copy_(torch.from_numpy(frame))
    assert raw.data_ptr() % 16 == 1
    assert not _pre_both(cuda, frame, geo, raw)


def _il_geo(samp, hw):
    """The geometry of an interleaved scan at these samplings (4:4:4
    included, which only the JAX package writes)."""
    return gt.Encoder(device="cpu").resolve(
        np.zeros((*hw, 3), np.uint8),
        _il_params(SAMPLINGS.get(samp, ((1, 1),) * 3)))


def _idct_inputs(geo, cuda, seed=7):
    """Dense and sparse random coefficients of geo's (64, L) layout, and
    the components' quant tables, on the card."""
    from gpujpeg_tpu_torch.utils import tables as tt

    L = geo.segment_count * geo.max_blocks_per_seg
    g = torch.Generator().manual_seed(seed)
    dense = torch.randint(-600, 600, (64, L), dtype=torch.int16, generator=g)
    sparse = torch.where(torch.rand((64, L), generator=g) < 0.8, 0,
                         dense // 8)
    q = torch.from_numpy(np.stack([tt.quant_table_zz(c.index == 0, 75)
                                   for c in geo.components]).astype(
        np.float32)).to(cuda)
    return [dense.to(cuda), sparse.to(cuda)], q


def _check_idct_planes(co, q, geo):
    _kernels.reset_launches()
    got = tpre.idct_planes(co, q, geo)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["idct_planes"] == 1
    assert len(got) == geo.comp_count
    for c, plane in zip(geo.components, got):
        assert plane.shape == (c.data_height, c.data_width)
        assert torch.equal(plane,
                           tpre.idct_planes_plain(co, q[c.index], geo, c))


@pytest.mark.parametrize("samp", ["420", "422", "440", "444", "planar420"])
def test_idct_planes_cpu_returns_every_plane(samp):
    """On the CPU the one-call wrapper returns each component's plain
    plane, at its (data_h, data_w), for every layout the kernel takes."""
    geo = (_planar_geo(samp[-3:], (40, 56)) if samp.startswith("planar")
           else _il_geo(samp, (40, 56)))
    cos, q = _idct_inputs(geo, "cpu")
    planes = tpre.idct_planes(cos[0], q, geo)
    assert len(planes) == geo.comp_count
    for c, plane in zip(geo.components, planes):
        assert plane.dtype == torch.uint8
        assert plane.shape == (c.data_height, c.data_width)
        assert torch.equal(plane, tpre.idct_planes_plain(cos[0], q[c.index],
                                                         geo, c))


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["420", "422", "440", "444", "planar420"])
@pytest.mark.parametrize("hw", [(1080, 1920), (233, 311)])
def test_idct_planes_matches_plain(cuda, samp, hw):
    """One launch a frame, every component's plane equal to the plain
    version: interleaved scans at each sampling, and the non-interleaved
    frame that dpost does not tile."""
    geo = (_planar_geo(samp[-3:], hw) if samp.startswith("planar")
           else _il_geo(samp, hw))
    cos, q = _idct_inputs(geo, cuda)
    for co in cos:
        _check_idct_planes(co, q, geo)


@pytest.mark.gpu
def test_idct_planes_unaligned_layouts(cuda):
    """A layout whose L is not a multiple of 8 (2-byte loads), and
    coefficients whose base is 2 bytes off 16."""
    geo = gt.Encoder(device="cpu").resolve(
        np.zeros((233, 311, 3), np.uint8),
        _il_params(((1, 1),) * 3, rst=1))
    L = geo.segment_count * geo.max_blocks_per_seg
    assert L % 8
    cos, q = _idct_inputs(geo, cuda, seed=9)
    for co in cos:
        _check_idct_planes(co, q, geo)
        flat = torch.zeros(64 * L + 1, dtype=torch.int16, device=cuda)
        moved = flat[1:].view(64, L)
        moved.copy_(co)
        assert moved.data_ptr() % 16 == 2
        _check_idct_planes(moved, q, geo)


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["420", "422", "440", "444"])
@pytest.mark.parametrize("hw", [(1080, 1920), (233, 311)])
def test_post_kernel_matches_plain(cuda, samp, hw):
    geo = _il_geo(samp, hw)
    pi = gt.ImageParameters(width=hw[1], height=hw[0],
                            color_space=gt.ColorSpace.RGB,
                            pixel_format=gt.PixelFormat.P444_U8_P012)
    g = torch.Generator().manual_seed(3)
    planes = [torch.randint(0, 256, (c.data_height, c.data_width),
                            dtype=torch.uint8, generator=g).to(cuda)
              for c in geo.components]
    _kernels.reset_launches()
    got = tpre.postprocess_packed(planes, geo, pi)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["post_rgb"] == 1
    assert got.shape == (*hw, 3)
    assert torch.equal(got, tpre.postprocess_packed_plain(planes, geo, pi))


def _post_inputs(samp, hw, cuda, cs="RGB", seed=3):
    geo = _il_geo(samp, hw)
    pi = gt.ImageParameters(width=hw[1], height=hw[0],
                            color_space=gt.ColorSpace[cs],
                            pixel_format=gt.PixelFormat.P444_U8_P012)
    g = torch.Generator().manual_seed(seed)
    planes = [torch.randint(0, 256, (c.data_height, c.data_width),
                            dtype=torch.uint8, generator=g).to(cuda)
              for c in geo.components]
    return planes, geo, pi


def _check_post(planes, geo, pi):
    _kernels.reset_launches()
    got = tpre.postprocess_packed(planes, geo, pi)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["post_rgb"] == 1
    assert got.shape == (pi.height, pi.width, 3)
    assert torch.equal(got, tpre.postprocess_packed_plain(planes, geo, pi))


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["420", "422", "440", "444"])
@pytest.mark.parametrize("W", [1, 2, 7, 8, 15, 16, 17, 24, 31, 33])
def test_post_kernel_any_width(cuda, samp, W):
    """Widths 1 to 33 (W % 16 != 0 stores bytes, partial groups) and odd
    heights at each chroma (fy, fx) in {1, 2}^2."""
    for H in (1, 5, 17):
        _check_post(*_post_inputs(samp, (H, W), cuda, seed=W + H))


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["420", "444"])
@pytest.mark.parametrize("hw", [(48, 64), (37, 45)])
def test_post_kernel_generic_factors(cuda, monkeypatch, samp, hw):
    """Chroma factors outside {1, 2} (3 x 3 here) and planes off 8-byte
    alignment take the generic instance: bit for bit the plain version."""
    planes, geo, pi = _post_inputs(samp, hw, cuda)
    real = tpre.sample.upsample_factors
    monkeypatch.setattr(tpre.sample, "upsample_factors",
                        lambda g, p: [(1, 1)] + [(3, 3)] * 2)
    _check_post(planes, geo, pi)
    monkeypatch.setattr(tpre.sample, "upsample_factors", real)
    shifted = []
    for p in planes:
        buf = torch.empty(p.numel() + 1, dtype=torch.uint8, device=cuda)
        v = buf[1:].view(p.shape)
        v.copy_(p)
        shifted.append(v)
    assert shifted[0].data_ptr() % 8 == 1
    _check_post(shifted, geo, pi)


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["444", "420"])
@pytest.mark.parametrize("cs", ["YCBCR_BT709", "YCBCR_BT601_256LVLS"])
def test_post_kernel_colour_transforms(cuda, samp, cs):
    """post_rgb to an output space other than RGB (a "to" step after the
    "from" step, or none), at 8K width and an odd one."""
    for hw in ((16, 7680), (9, 61)):
        _check_post(*_post_inputs(samp, hw, cuda, cs))


@pytest.mark.gpu
@pytest.mark.parametrize("samp,hw,kind,quality,rst", [
    ("420", (1080, 1920), "gradient", 75, gt.RESTART_AUTO),
    ("420", (233, 311), "gradient", 90, 2),
    ("422", (240, 320), "gradient", 75, gt.RESTART_AUTO),
    ("440", (64, 64), "noise", 75, gt.RESTART_AUTO)])
def test_interleaved_on_card_matches_cpu(cuda, samp, hw, kind, quality,
                                         rst):
    frame = (np.random.default_rng(4).integers(0, 256, (*hw, 3),
                                               dtype=np.uint8)
             if kind == "noise" else _frame(*hw, 4, amp=64))
    p = _il_params(SAMPLINGS[samp], quality, rst)
    _kernels.reset_launches()
    data = gt.Encoder(device=cuda).encode(frame, p)
    for name in ("pre_rgb_to_planes", "fdct_quant", "huffman_segments"):
        assert _kernels.LAUNCHES[name] > 0, _kernels.LAUNCHES
    assert _kernels.LAUNCHES["pack_stuff_rows"] == 0
    assert data == gt.Encoder(device="cpu").encode(frame, p)
    _kernels.reset_launches()
    got = gt.Decoder(device=cuda).decode(data)
    for name in ("huffdec_scan", "huffdec_block", "idct_planes", "post_rgb"):
        assert _kernels.LAUNCHES[name] > 0, _kernels.LAUNCHES
    assert _kernels.LAUNCHES["dpost_rgb"] == 0
    assert np.array_equal(got, gt.Decoder(device="cpu").decode(data))


def _slot_rows(samp, hw, kind, cuda):
    """An interleaved scan's MCU-ordered coefficient rows on the card, and
    its geometry and slot tables."""
    frame = (np.random.default_rng(12).integers(0, 256, (*hw, 3),
                                                dtype=np.uint8)
             if kind == "noise" else _frame(*hw, 12, amp=64))
    enc = gt.Encoder(device=cuda)
    geo = enc.resolve(frame, _il_params(SAMPLINGS.get(samp, ((1, 1),) * 3)))
    planes = tpre.preprocess_packed(torch.from_numpy(frame).to(cuda), geo,
                                    geo.param_image)
    classes = enc.classes(75)
    return (tfp.interleaved_rows(planes, geo, classes), geo,
            tfp.interleaved_slots(geo, classes))


@pytest.mark.gpu
@pytest.mark.parametrize("samp,kind", [("444", "gradient"), ("444", "noise"),
                                       ("420", "gradient"), ("420", "noise"),
                                       ("422", "gradient")])
def test_huffman_kernel_pattern_mode(cuda, samp, kind):
    """Interleaved rows, a class and a DC predictor per MCU slot."""
    rows_in, geo, st = _slot_rows(samp, (1080, 1920), kind, cuda)
    nblocks = geo.mcu_count * geo.blocks_per_mcu
    markers = tfp.segment_markers(geo.segment_count, cuda)
    _kernels.reset_launches()
    rows, rb, needs = tfp.huffman_segments(rows_in, nblocks, st, markers)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffman_segments"] == 1
    assert rows.shape[1] == st.stride(rows_in.shape[1] // 64)
    p_rows, p_rb, p_needs = tfp.huffman_segments_plain(rows_in, nblocks, st,
                                                       markers)
    assert torch.equal(needs, p_needs)
    assert _rows_equal(rows, rb, p_rows, p_rb)


@pytest.mark.gpu
def test_huffman_kernel_coefs_mode(cuda):
    """Coefficient input: per-row class flags, a per-block valid mask with
    interior holes, caller markers with zeros mid-scan."""
    rng = np.random.default_rng(13)
    S, B = 5000, 8
    coefs = rng.integers(-200, 200, (S, B, 64)).astype(np.int16)
    coefs = np.where(rng.random((S, B, 64)) < 0.85, 0, coefs)
    coefs[100:150] = rng.integers(-1023, 1024, (50, B, 64))   # dense rows
    valid = rng.random((S, B)) < 0.9
    valid[7, 3] = False                           # one interior hole
    luma = (rng.random(S) < 0.5).astype(np.int32)
    markers = np.where(rng.random(S) < 0.1, 0, 0xD0 + np.arange(S) % 8)
    args = [torch.from_numpy(a).to(cuda) for a in (
        coefs.reshape(S, B * 64), valid, luma, markers.astype(np.int32))]
    classes = (tfp.class_tables(75, True, cuda),
               tfp.class_tables(75, False, cuda))
    _kernels.reset_launches()
    rows, rb, needs = tfp.entropy_fused(*args, classes)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffman_segments"] == 1
    st = tfp.SlotTables(classes, (0,), (0,))
    p_rows, p_rb, p_needs = tfp.huffman_segments_plain(
        args[0], None, st, args[3], args[1], args[2])
    assert torch.equal(needs, p_needs)
    assert _rows_equal(rows, rb, p_rows, p_rb)


@pytest.mark.gpu
def test_huffman_one_slot_is_the_segment_contract(cuda):
    """The one-slot call (one class, prefix validity, markers of one scan)
    equals the general call given those explicitly, and the plain
    version."""
    rng = np.random.default_rng(14)
    S, B = 3000, 8
    nblocks = S * B - 3
    coefs = rng.integers(-300, 300, (S, B, 64)).astype(np.int16)
    coefs = np.where(rng.random((S, B, 64)) < 0.8, 0, coefs)
    x = torch.from_numpy(coefs.reshape(S, B * 64)).to(cuda)
    tabs = tfp.class_tables(75, False, cuda)
    valid = (torch.arange(S * B, device=cuda) < nblocks).reshape(S, B)
    out = tfp.huffman_segments(x, nblocks, tabs)
    general = tfp.huffman_segments(x, None, tfp.one_slot(tabs),
                                   tfp.segment_markers(S, cuda), valid)
    plain = tfp.huffman_segments_plain(x, nblocks, tabs)
    for other in (general, plain):
        assert torch.equal(out[2], other[2])
        assert _rows_equal(out[0], out[1], other[0], other[1])


def _edge_blocks(rng, n):
    """n blocks of the Huffman coder's edge cases, cycling through: zero
    runs of 15, 16, 17, 31, 32, 48 before one nonzero, runs that end at
    coefficient 63 (EOB only), a last nonzero at 63 after a long run,
    all-ones value bits (0xFF bytes anywhere in a word), every AC slot at
    size 10 (a block's longest coding), and DC steps of size 11."""
    out = np.zeros((n, 64), np.int16)
    for i in range(n):
        kind = i % 9
        if kind < 6:                     # a run of r zeros, then 1 nonzero
            r = (15, 16, 17, 31, 32, 48)[kind]
            out[i, 1 + r] = rng.choice([1, -1, 511, -1023])
        elif kind == 6:                  # runs of 16, 32, 48 to the end
            out[i, 63 - 16 * (1 + i % 3)] = 7
            out[i, 63] = 3 * (i % 2)
        elif kind == 7:                  # value bits all ones
            k = rng.integers(1, 11, 64)
            sign = rng.choice([1, -1], 64)
            v = np.where(sign > 0, (1 << k) - 1, -((1 << k) - 1))
            out[i] = np.where(rng.random(64) < 0.6, v, 0)
        else:                            # longest coding: size 10 everywhere
            out[i] = rng.choice([1023, -1023, 512, -512], 64)
        out[i, 0] = rng.choice([-1024, 1023, 0, 5])    # DC steps of size 11
    return out


def _unstuffed(row, marker):
    """A stuffed row's scan bytes without the 0x00 after each 0xFF and
    without its marker."""
    data = row[:len(row) - (2 if marker else 0)]
    keep = np.ones(len(data), bool)
    keep[1:] = ~((data[:-1] == 0xFF) & (data[1:] == 0))
    return data[keep]


def _ff_coverage(rows, rb, markers):
    """Where the rows' 0xFF bytes fall: the byte positions in a 32-bit
    word, whether one is the last byte (pad included) and the byte before
    it."""
    seen = set()
    rows, rb, markers = rows.cpu().numpy(), rb.cpu().numpy(), \
        markers.cpu().numpy()
    for r in range(rows.shape[0]):
        u = _unstuffed(rows[r, :rb[r]], markers[r])
        ff = np.flatnonzero(u == 0xFF)
        seen.update(f"word byte {p % 4}" for p in ff)
        if len(u) and u[-1] == 0xFF:
            seen.add("last")
        if len(u) > 1 and u[-2] == 0xFF:
            seen.add("before last")
    return seen


#: (bpm, slot classes, slot components): one slot, and the interleaved
#: patterns of 4:4:4, 4:2:2, 4:2:0 and a 16-slot MCU
HUFF_PATTERNS = {1: ((0,), (0,)), 3: ((0, 1, 1), (0, 1, 2)),
                 4: ((0, 0, 1, 1), (0, 0, 1, 2)),
                 6: ((0, 0, 0, 0, 1, 1), (0, 0, 0, 0, 1, 2)),
                 16: ((0,) * 8 + (1,) * 8, (0,) * 4 + (1,) * 4 + (2,) * 4
                      + (3,) * 4)}


@pytest.mark.gpu
@pytest.mark.parametrize("bpm", list(HUFF_PATTERNS))
@pytest.mark.parametrize("masked", [False, True])
def test_huffman_kernel_edge_rows(cuda, bpm, masked):
    """A warp a row against the plain coder on rows of edge blocks: 0xFF at
    every byte of a word and before the pad and the marker, ZRL runs, DC
    steps of size 11, rows at their longest coding; every slot pattern with
    per-row class flags; a valid mask with holes, or a prefix of blocks
    that is not a multiple of B."""
    rng = np.random.default_rng(20 + bpm)
    B = bpm * max(1, 8 // bpm)
    S = 1500
    coefs = _edge_blocks(rng, S * B).reshape(S, B * 64)
    x = torch.from_numpy(coefs).to(cuda)
    classes = (tfp.class_tables(75, True, cuda),
               tfp.class_tables(75, False, cuda))
    st = tfp.SlotTables(classes, *HUFF_PATTERNS[bpm])
    markers = torch.from_numpy(np.where(
        rng.random(S) < 0.2, 0, 0xD0 + np.arange(S) % 8).astype(
        np.int32)).to(cuda)
    luma = torch.from_numpy((rng.random(S) < 0.5).astype(np.int32)).to(cuda)
    if masked:
        args = (None, st, markers, torch.from_numpy(
            rng.random((S, B)) < 0.85).to(cuda), luma)
    else:
        args = (S * B - B // 2 - 1, st, markers, None, luma)
    _kernels.reset_launches()
    rows, rb, needs = tfp.huffman_segments(x, *args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffman_segments"] == 1
    p_rows, p_rb, p_needs = tfp.huffman_segments_plain(x, *args)
    assert torch.equal(needs, p_needs)
    assert _rows_equal(rows, rb, p_rows, p_rb)
    assert int(needs[1]) <= rows.shape[1]
    assert _ff_coverage(p_rows, p_rb, markers) == {
        "word byte 0", "word byte 1", "word byte 2", "word byte 3", "last",
        "before last"}


@pytest.mark.gpu
def test_huffman_probe_uncounted(cuda):
    """The Huffman coder's probe stages: the full stage equals the kernel,
    the cut stages launch, and none is counted."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(_edge_blocks(rng, 400 * 8).reshape(400, 512)).to(
        cuda)
    tabs = tfp.class_tables(75, True, cuda)
    want = tfp.huffman_segments(x, 400 * 8 - 3, tabs)
    _kernels.reset_launches()
    for stage in _kernels.PROBE_STAGES:
        got = tfp.huffman_segments_probe(x, 400 * 8 - 3, tabs, stage)
        torch.cuda.synchronize()
        if stage == "full":
            assert torch.equal(got[2], want[2])
            assert _rows_equal(got[0], got[1], want[0], want[1])
    assert _kernels.LAUNCHES["huffman_segments"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("B", [256, 1024])
def test_huffman_kernel_long_rows(cuda, B):
    """Rows longer than a warp's bit buffer (restart interval 0 codes one
    row of a whole plane): the buffer is emptied mid-row, with no byte
    lost or stuffed twice."""
    rng = np.random.default_rng(B)
    S = 24
    coefs = _edge_blocks(rng, S * B)
    coefs = np.where(rng.random(coefs.shape) < 0.3, 0, coefs)
    x = torch.from_numpy(coefs.reshape(S, B * 64)).to(cuda)
    tabs = tfp.class_tables(75, True, cuda)
    nblocks = S * B - 7
    rows, rb, needs = tfp.huffman_segments(x, nblocks, tabs)
    p_rows, p_rb, p_needs = tfp.huffman_segments_plain(x, nblocks, tabs)
    assert torch.equal(needs, p_needs)
    assert _rows_equal(rows, rb, p_rows, p_rb)
    assert int(needs[1]) > 8 * 512


def _planar_geo(samp, hw):
    frame = np.zeros((*hw, 3), np.uint8)
    return gt.Encoder(device="cpu").resolve(frame, gt.Parameters(
        quality=75, restart_interval=gt.RESTART_AUTO).chroma_subsampled(
        SAMPLINGS.get(samp, ((1, 1),) * 3)))


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["420", "422", "440", "444"])
@pytest.mark.parametrize("hw", [(1088, 1920), (64, 80), (400, 1344),
                                (250, 382)])
def test_dpost_kernel_subsampled_matches_plain(cuda, samp, hw):
    """dpost at dx, dy in {1, 2} on random coefficients (every rounding
    boundary of the chains) and on a sparse set.  1088 rows, since at
    1080 the chroma planes of 4:2:0 and 4:4:0 pad to 68 block rows, not
    half of luma's 135.  A block row of 1344 or 382 pixels is no multiple
    of the 32-block tile (1344: 2-byte loads at 4:2:0 and 4:2:2, 16-byte
    copies at 4:4:0 and 4:4:4; 382: 16-byte copies, and rows and columns
    cropped with byte stores, W % 16 != 0); at 64x80 and 400x1344 the
    chroma components end on a ragged segment (20 and 2100 blocks, 8 a
    segment)."""
    from gpujpeg_tpu_torch.utils import tables as tt

    geo = _planar_geo(samp, hw)
    pi = gt.ImageParameters(width=hw[1], height=hw[0],
                            color_space=gt.ColorSpace.RGB,
                            pixel_format=gt.PixelFormat.P444_U8_P012)
    assert tpre.decode_post_supported(geo, pi)
    cols = tpre.component_columns(geo)
    L = cols[-1][0] + geo.components[-1].segment_count * \
        geo.max_blocks_per_seg
    q = torch.from_numpy(np.stack([tt.quant_table_zz(c.index == 0, 75)
                                   for c in geo.components]).astype(
        np.float32)).to(cuda)
    g = torch.Generator().manual_seed(5)
    dense = torch.randint(-600, 600, (64, L), dtype=torch.int16, generator=g)
    sparse = torch.where(torch.rand((64, L), generator=g) < 0.8, 0,
                         dense // 8)
    for co in (dense.to(cuda), sparse.to(cuda)):
        _kernels.reset_launches()
        got = tpre.decode_post(co, q, geo, pi)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["dpost_rgb"] == 1
        assert got.shape == (*hw, 3)
        assert torch.equal(got, tpre.decode_post_plain(co, q, geo, pi))


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["444", "420"])
@pytest.mark.parametrize("cs", ["YCBCR_BT709", "YCBCR_BT601_256LVLS"])
def test_dpost_kernel_colour_transforms(cuda, samp, cs):
    """dpost to an output space other than RGB: a transform with a "to"
    step (or none) takes the kernel's general colour path."""
    from gpujpeg_tpu_torch.utils import tables as tt

    hw = (400, 1344)
    geo = _planar_geo(samp, hw)
    pi = gt.ImageParameters(width=hw[1], height=hw[0],
                            color_space=gt.ColorSpace[cs],
                            pixel_format=gt.PixelFormat.P444_U8_P012)
    assert tpre.decode_post_supported(geo, pi)
    cols = tpre.component_columns(geo)
    L = cols[-1][0] + geo.components[-1].segment_count * \
        geo.max_blocks_per_seg
    q = torch.from_numpy(np.stack([tt.quant_table_zz(c.index == 0, 75)
                                   for c in geo.components]).astype(
        np.float32)).to(cuda)
    co = torch.randint(-600, 600, (64, L), dtype=torch.int16,
                       generator=torch.Generator().manual_seed(4)).to(cuda)
    _kernels.reset_launches()
    got = tpre.decode_post(co, q, geo, pi)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["dpost_rgb"] == 1
    assert torch.equal(got, tpre.decode_post_plain(co, q, geo, pi))


@pytest.mark.gpu
@pytest.mark.parametrize("layout,hw", [
    ("il444", (1080, 1920)), ("il444", (233, 311)),
    ("planar420", (1080, 1920)), ("planar420", (1088, 1920)),
    ("planar420", (233, 311)), ("planar422", (64, 80))])
def test_new_layouts_on_card_match_cpu(cuda, layout, hw):
    """Interleaved 4:4:4 and planar subsampled encode and decode: the
    card's bytes and pixels equal the CPU's, through the kernels of each
    path (dpost only where decode_post_supported holds)."""
    frame = _frame(*hw, 6, amp=64)
    p = gt.Parameters(quality=75, restart_interval=gt.RESTART_AUTO)
    if layout == "il444":
        p = p.with_(interleaved=True)
    else:
        p = p.chroma_subsampled(SAMPLINGS[layout[-3:]])
    _kernels.reset_launches()
    data = gt.Encoder(device=cuda).encode(frame, p)
    for name in ("pre_rgb_to_planes", "fdct_quant", "huffman_segments"):
        assert _kernels.LAUNCHES[name] > 0, _kernels.LAUNCHES
    assert data == gt.Encoder(device="cpu").encode(frame, p)
    _kernels.reset_launches()
    dec = gt.Decoder(device=cuda)
    got = dec.decode(data)
    hf = dec.prepare(data)
    fused = tpre.decode_post_supported(hf.plan.geo, hf.out_pi)
    assert fused == (layout != "il444" and hw[0] != 1080 and hw[1] != 311)
    assert _kernels.LAUNCHES["dpost_rgb"] == int(fused)
    assert _kernels.LAUNCHES["idct_planes"] == 1 - int(fused)
    assert np.array_equal(got, gt.Decoder(device="cpu").decode(data))


@pytest.mark.gpu
def test_probe_stages_launch_uncounted(cuda):
    """The decomposition probe's cut kernels (chip_smoke.py): the full
    stage equals the kernel, the others launch, and none is counted."""
    from gpujpeg_tpu_torch.utils import tables as tt

    x = torch.from_numpy(_plane("gradient", 240, 320)).to(cuda)
    tabs = tfp.class_tables(75, True, cuda)
    geo = _planar_geo("420", (256, 320))
    pi = gt.ImageParameters(width=320, height=256,
                            color_space=gt.ColorSpace.RGB,
                            pixel_format=gt.PixelFormat.P444_U8_P012)
    cols = tpre.component_columns(geo)
    L = cols[-1][0] + geo.components[-1].segment_count * \
        geo.max_blocks_per_seg
    q = torch.from_numpy(np.stack([tt.quant_table_zz(c.index == 0, 75)
                                   for c in geo.components]).astype(
        np.float32)).to(cuda)
    co = torch.randint(-600, 600, (64, L), dtype=torch.int16,
                       generator=torch.Generator().manual_seed(9)).to(cuda)
    _kernels.reset_launches()
    for stage in _kernels.PROBE_STAGES:
        f = tfp.fdct_quant_probe(x, tabs, 8, stage)
        d = tpre.decode_post_probe(co, q, geo, pi, stage)
        torch.cuda.synchronize()
        if stage == "full":
            assert torch.equal(f, tfp.fdct_quant_plain(x, tabs, 8))
            assert torch.equal(d, tpre.decode_post_plain(co, q, geo, pi))
    assert _kernels.LAUNCHES["fdct_quant"] == 0
    assert _kernels.LAUNCHES["dpost_rgb"] == 0


def test_probes_take_cuda_tensors_only():
    """The probe entry points have no plain version: a tensor off the
    card is refused, and a stage must be one of PROBE_STAGES."""
    tabs = tfp.class_tables(75, True, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fdct_quant_probe(torch.zeros((16, 16), dtype=torch.uint8), tabs,
                             8, "full")
    geo = _planar_geo("420", (64, 80))
    pi = gt.ImageParameters(width=80, height=64,
                            color_space=gt.ColorSpace.RGB,
                            pixel_format=gt.PixelFormat.P444_U8_P012)
    cols = tpre.component_columns(geo)
    L = cols[-1][0] + geo.components[-1].segment_count * \
        geo.max_blocks_per_seg
    with pytest.raises(ValueError, match="int16 coefficients"):
        tpre.decode_post_probe(torch.zeros((64, 8), dtype=torch.int16),
                               torch.zeros((3, 64)), geo, pi, "no_store")
    with pytest.raises(ValueError, match="CUDA"):
        tpre.decode_post_probe(torch.zeros((64, L), dtype=torch.int16),
                               torch.zeros((3, 64)), geo, pi, "no_store")
    assert set(_kernels.PROBE_STAGES) == {"full", "load_store", "no_store"}
    with pytest.raises(ValueError, match="CUDA"):
        tfp.huffman_segments_probe(torch.zeros((4, 512), dtype=torch.int16),
                                   30, tabs, "load_store")
    tab = torch.zeros((4, 290), dtype=torch.int32)
    rows = [torch.zeros(6, dtype=torch.int32) for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA"):
        thd.decode_blocks_probe(torch.zeros((6, 9), dtype=torch.int32),
                                torch.zeros((6, 9), dtype=torch.int32),
                                *rows, tab, thd.NO_PATTERN,
                                torch.zeros((4, 512), dtype=torch.int32),
                                "no_store")
    z = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tfp.pack_stuff_rows_probe(z, z, torch.zeros(4, dtype=torch.int32),
                                  64, "load_store")
    with pytest.raises(ValueError, match="CUDA"):
        tdec.dc_fixup_probe(torch.zeros((64, 16), dtype=torch.int16),
                            fixup_plan(8, (0,)), "load_store")
    assert set(_kernels.PROBES) == {"fdct_quant", "dpost_rgb",
                                    "huffman_segments", "huffdec_block",
                                    "huffdec_block_direct",
                                    "pack_stuff_rows", "dc_fixup"}


@pytest.mark.gpu
def test_block_probe_stages_uncounted(cuda):
    """The block decoder's probe stages: the full stage equals the plain
    decode, the others launch, and none is counted."""
    pattern = (4, 0b0101, 0b0011)
    words, bstart, nb, dcl, acl, tab = _coded_blocks(33, 150, 8, pattern)
    rows = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda)
            for a in (words, bstart, nb, dcl, acl)]
    lut = torch.from_numpy(thd.block_lut(tab.numpy())).to(cuda)
    want = thd.decode_blocks_plain(*[r.cpu() for r in rows], tab, pattern)
    _kernels.reset_launches()
    for stage in _kernels.PROBE_STAGES:
        coefs, err = thd.decode_blocks_probe(*rows, tab.to(cuda), pattern,
                                             lut, stage)
        torch.cuda.synchronize()
        if stage == "full":
            assert torch.equal(coefs.cpu(), want[0])
            assert torch.equal(err.cpu(), want[1])
    assert _kernels.LAUNCHES["huffdec_block"] == 0


# -- MCU-order store of fdct_quant (the interleaved feed relayout) ----------

#: (hw, restart interval): HD; ragged planes; intervals that leave pad
#: MCUs past the image in the last segment
MCU_CASES = [((1080, 1920), gt.RESTART_AUTO), ((233, 311), 7),
             ((64, 80), 3), ((40, 536), 5)]


def _il_planes(samp, hw, rst, cuda, seed=14):
    frame = _frame(*hw, seed, amp=96)
    enc = gt.Encoder(device="cpu")
    geo = enc.resolve(frame, _il_params(SAMPLINGS.get(samp, ((1, 1),) * 3),
                                        rst=rst))
    planes = tpre.preprocess_packed_plain(torch.from_numpy(frame).to(cuda),
                                          geo, geo.param_image)
    classes = (tfp.class_tables(75, True, cuda),
               tfp.class_tables(75, False, cuda))
    return planes, geo, classes


def _dirty_cache(cuda, numel):
    """Leave a freed block of non-zero int16s in the caching allocator, so
    that a torch.empty of that size is not zero by chance."""
    junk = torch.full((numel,), 0x5A5A, dtype=torch.int16, device=cuda)
    torch.cuda.synchronize()
    del junk


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["444", "420", "422", "440"])
@pytest.mark.parametrize("hw,rst", MCU_CASES)
def test_fdct_mcu_order_matches_plain(cuda, samp, hw, rst):
    """interleaved_rows on the card (fdct_quant storing MCU order, the pad
    MCUs zeroed) equals its plain version (raster order, then a copy)."""
    planes, geo, classes = _il_planes(samp, hw, rst, cuda)
    S, r_, bpm = geo.segment_count, geo.segment_mcu_count, geo.blocks_per_mcu
    _dirty_cache(cuda, S * r_ * bpm * 64)
    _kernels.reset_launches()
    got = tfp.interleaved_rows(planes, geo, classes)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fdct_quant"] == 3
    assert got.shape == (S, r_ * bpm * 64)
    assert torch.equal(got, tfp.interleaved_rows_plain(planes, geo, classes))


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["444", "420"])
def test_fdct_mcu_order_misaligned_planes(cuda, samp):
    """Planes whose base is 8 bytes off a 16-byte boundary take the 8-byte
    copies in MCU order too."""
    planes, geo, classes = _il_planes(samp, (64, 96), 3, cuda)
    moved = []
    for p in planes:
        flat = torch.empty(8 + p.numel(), dtype=torch.uint8, device=cuda)
        x = flat[8:].view(p.shape)
        x.copy_(p)
        assert x.data_ptr() % 16 == 8
        moved.append(x)
    got = tfp.interleaved_rows(moved, geo, classes)
    assert torch.equal(got, tfp.interleaved_rows_plain(planes, geo, classes))


@pytest.mark.gpu
def test_fdct_refuses_bad_maps(cuda):
    """fdct_quant's C entry point refuses maps that do not fit the plane or
    the buffer, and the cut probe stages in MCU order."""
    x = torch.zeros((16, 32), dtype=torch.uint8, device=cuda)
    tabs = tfp.class_tables(75, True, cuda)
    out = torch.empty((64, 64), dtype=torch.int16, device=cuda)
    bad = [(64, 1, 0, 2, 1, 2),     # bpm 1 with a 2x1 component
           (64, 6, 0, 2, 2, 3),     # mcux * sh != blocks a row
           (64, 6, 5, 2, 2, 2),     # off + sh * sv > bpm
           (64, 3, 0, 1, 1, 4),     # nblocks_out not a multiple of bpm
           (6, 6, 0, 2, 2, 2),      # no room for the plane's MCUs
           (64, 6, 0, 3, 1, 2)]     # sh not a power of two
    for n, bpm, off, sh, sv, mcux in bad:
        with pytest.raises(RuntimeError, match="fdct_quant failed"):
            _kernels.launch("fdct_quant", x, 16, 32, n, bpm, off, sh, sv,
                            mcux, tabs.mq, tabs.bias, out)
    with pytest.raises(RuntimeError, match="fdct_quant_probe failed"):
        _kernels.probe("fdct_quant", "no_store", x, 16, 32, 60, 6, 0, 2, 2,
                       2, tabs.mq, tabs.bias, out)


# -- relayout and primitive kernels (csrc/relayout.cu) -----------------------

def _words(rng, shape, cuda, low=0, high=1 << 32):
    a = rng.integers(low, high, shape, dtype=np.int64)
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("nbh,nsr,rst,skew,vector", [
    (3, 45, 8, 0, False), (1, 1, 1, 0, False), (5, 33, 3, 0, False),
    (2, 70, 23, 0, False), (3, 120, 8, 0, True), (540, 120, 8, 0, True),
    (3, 120, 8, 1, False), (2, 68, 23, 0, True), (4, 132, 3, 0, True),
    (2, 4, 1, 0, True)])
def test_xbd_relayout_matches_plain(cuda, nbh, nsr, rst, skew, vector):
    """The xbd relayout against its plain version, in the instance the
    wrapper's rule (xbd_vector) picks: 16-byte vectors where nsr % 4 == 0
    and the input is aligned (the tools' rst 8 at their 8K shape, odd rst
    with vectors across segments, segments past a CTA's 64), one word an
    access otherwise (nsr % 4 != 0, an input 4 bytes off)."""
    shape = (nbh * 8, nsr * 2 * rst)
    flat = _words(np.random.default_rng(nbh * nsr + skew),
                  (shape[0] * shape[1] + skew,), cuda)
    p32 = flat[skew:].view(shape)
    assert trel.xbd_vector(p32, rst) == vector
    _kernels.reset_launches()
    got = trel.xbd_relayout(p32, rst)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["xbd_relayout"] == 1
    assert torch.equal(got, trel.xbd_relayout_plain(p32, rst))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(33, 47), (1, 5), (129, 1), (64, 96),
                                   (4224, 1920)])
def test_transpose_u32_matches_plain(cuda, shape):
    x = _words(np.random.default_rng(shape[0]), shape, cuda)
    _kernels.reset_launches()
    got = trel.transpose_u32(x)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["transpose_u32"] == 1
    assert torch.equal(got, trel.transpose_u32_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,skew", [
    ((6, 7), 0), ((10, 128), 0), ((10, 128), 1), ((2, 4), 0),
    ((23040, 128), 0), ((92160, 128), 0), ((74, 12), 0), ((400, 4), 0),
    ((6, 2052), 0), ((10, 516), 0), ((4, 1024), 0), ((46080, 132), 1),
    ((4, 2052), 3)])
def test_row_kernels_match_plain(cuda, shape, skew):
    """pair_sum_rows (with wraparound) and pack_u8_quads (low bytes of any
    int32), shape[0] / 2 output rows of shape[1] words: the vector instance
    (16-byte accesses, 4 chunks a thread in flight) at the tools' 8K shape
    and at four times it (several rounds of kUnroll chunks a thread),
    bands with ragged tails, C = 4 and 12 (a thread's chunks across rows),
    rows of more chunks than a CTA has threads (C = 2052, 1024, 516); the
    generic instance (a word an access) on odd widths and misaligned
    bases."""
    rng = np.random.default_rng(shape[1] + skew)
    for rows_mult, fn, plain, name in (
            (2, trel.pair_sum_rows, trel.pair_sum_rows_plain,
             "pair_sum_rows"),
            (4, trel.pack_u8_quads, trel.pack_u8_quads_plain,
             "pack_u8_quads")):
        R = shape[0] * rows_mult // 2
        flat = _words(rng, (R * shape[1] + skew,), cuda)
        x = flat[skew:].view(R, shape[1])
        assert trel.row_vector(x) == (shape[1] % 4 == 0 and skew % 4 == 0)
        _kernels.reset_launches()
        got = fn(x)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES[name] == 1
        assert torch.equal(got, plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,skew", [((23040, 128), 0), ((10, 7), 1)])
def test_row_kernels_empty_launch(cuda, shape, skew):
    """The empty kernel launched as each row kernel would be runs on both
    instances' launches and counts nothing."""
    flat = _words(np.random.default_rng(3), (2 * shape[0] * shape[1] + skew,),
                  cuda)
    for fold, name in ((2, "pair_sum_rows"), (4, "pack_u8_quads")):
        x = flat[skew:skew + fold * shape[0] // 2 * shape[1]].view(
            -1, shape[1])
        _kernels.reset_launches()
        trel.empty_launch(name, x)
        torch.cuda.synchronize()
        assert sum(_kernels.LAUNCHES.values()) == 0


def test_relayout_wrappers_refuse_other_devices():
    """The relayout wrappers run their plain versions only for CPU tensors
    and refuse shapes their kernels do not take."""
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                      device="meta")
    for fn, x in ((lambda v: trel.xbd_relayout(v, 8), meta(16, 32)),
                  (trel.transpose_u32, meta(4, 8)),
                  (trel.pair_sum_rows, meta(4, 8)),
                  (trel.pack_u8_quads, meta(4, 8))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x)
    with pytest.raises(ValueError, match="multiple of 8"):
        trel.xbd_relayout(meta(12, 32), 8)
    with pytest.raises(ValueError, match="2 rst"):
        trel.xbd_relayout(meta(16, 24), 8)
    with pytest.raises(ValueError, match="multiple of 2"):
        trel.pair_sum_rows(meta(3, 8))
    with pytest.raises(ValueError, match="multiple of 4"):
        trel.pack_u8_quads(meta(6, 8))
    with pytest.raises(ValueError, match="int32"):
        trel.transpose_u32(torch.zeros((4, 4), dtype=torch.int16))


# -- the decoder's reused pinned buffer ---------------------------------------

@pytest.mark.gpu
def test_pinned_decode_over_two_stream_sizes(cuda):
    """A CUDA session reuses one pinned segment buffer across streams of
    two sizes (grown once), uploads from it without blocking, and decodes
    the CPU's pixels, also when decode_to_device calls follow each other
    without a download between them."""
    small = _il_stream(SAMPLINGS["420"], (64, 80))[1]
    large = _stream("noise", 240, 320)[1]
    dec, cpu = gt.Decoder(device=cuda), gt.Decoder(device="cpu")
    want = {d: cpu.decode(d) for d in (small, large)}
    bufs = []
    for data in (small, large, small, large):
        assert np.array_equal(dec.decode(data), want[data])
        bufs.append(dec._prep_buf)
    assert bufs[1] is bufs[2] is bufs[3]
    assert torch.from_numpy(bufs[1]).is_pinned()
    outs = [dec.decode_to_device(d) for d in (large, small, large)]
    for d, o in zip((large, small, large), outs):
        assert np.array_equal(o.cpu().numpy(), want[d])


# -- the streams other encoders write: four table sets, restart interval 0,
# Annex-K tables ---------------------------------------------------------------

def _four_set_rows(seed, nsets, nseg, bps, bpm, how, long_share=0.4):
    """Coded rows of nsets table sets (long codes and Annex K), each
    block's set picked by its segment's index ("selector"), by the slot
    pattern's 2-bit fields ("pattern") or by both: (words, nbits, nblocks,
    dc_sel, ac_sel, tables (8, 290), pattern)."""
    rng = np.random.default_rng(seed)
    ak = scan_rows.annexk_tables()
    tabs = [scan_rows.long_code_tables(seed), ak[1], ak[0],
            scan_rows.long_code_tables(seed + 1)][:nsets]
    fields = [rng.integers(0, nsets, bpm) for _ in range(2)]
    pattern = (bpm,) + (tuple(int(sum(int(f) << 2 * j
                                      for j, f in enumerate(fs)))
                              for fs in fields)
                        if how != "selector" else (0, 0))
    sel = ((np.zeros(nseg, np.int32),) * 2 if how == "pattern" else
           (rng.integers(0, 4, nseg), rng.integers(0, 4, nseg)))
    rows, nb, dsel, asel = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern, sel, rng.integers(0, bps + 1, nseg),
        long_share=long_share)
    words, nbits = scan_rows.word_matrix(rows)
    return (words, nbits, nb, dsel, asel, scan_rows.decode_tables(tabs),
            pattern)


FOUR_SET_CASES = [(3, 1, "selector"), (4, 1, "selector"), (3, 6, "pattern"),
                  (4, 4, "both"), (4, 10, "pattern")]


@pytest.mark.gpu
@pytest.mark.parametrize("nsets,bpm,how", FOUR_SET_CASES)
def test_scan_kernel_four_sets(cuda, nsets, bpm, how):
    """The four-set instance of phase A on coded rows of three or four
    sets with long codes, picked by selectors, 2-bit slot fields or both:
    bit for bit the plain scan, no error."""
    words, nbits, nb, dsel, asel, tab, pattern = _four_set_rows(
        60 + 10 * nsets + bpm, nsets, 240, 3 * bpm, bpm, how)
    _, err = _scan_both(cuda, (words, nbits, nb, dsel, asel), tab,
                        3 * bpm, pattern, offset=1)
    assert not bool(err.any())


@pytest.mark.gpu
@pytest.mark.parametrize("nsets,bpm,how", FOUR_SET_CASES)
def test_block_kernel_four_sets(cuda, nsets, bpm, how):
    """The four-set instance of phase C (CTAs of 8 warps, the tables of
    four sets in dynamic shared memory) on the same kind of rows, from
    the plain scan's boundaries, and on shifted boundaries (garbage): bit
    for bit the plain decode."""
    words, nbits, nb, dsel, asel, tab, pattern = _four_set_rows(
        70 + 10 * nsets + bpm, nsets, 150, 4 * bpm, bpm, how)
    bstart, err = thd.scan_segments_plain(
        *(torch.from_numpy(np.asarray(a, np.int32))
          for a in (words, nbits, nb, dsel, asel)), tab, 4 * bpm, pattern)
    assert not bool(err.any())
    coefs, err = _block_both(cuda, words, bstart.numpy(), nb, dsel, asel,
                             tab, pattern)
    assert not bool(err.any()) and bool(coefs.any())
    rng = np.random.default_rng(bpm)
    shifted = bstart.numpy().copy()
    shifted[:, :-1] += rng.integers(-3, 4, shifted[:, :-1].shape)
    _block_both(cuda, words, np.clip(shifted, 0, 32 * words.shape[1]), nb,
                dsel, asel, tab, pattern, offset=3)


@pytest.mark.gpu
def test_four_set_kernels_random_words(cuda):
    """Random rows and boundaries (mostly bad tokens) with random set
    indices and 2-bit fields, selector plus field wrapping past 3: bit
    for bit the plain versions."""
    rng = np.random.default_rng(5)
    nseg, bps, bpm, W = 500, 6, 3, 7
    tab = _four_set_rows(5, 4, 2, 3, 3, "both")[5]
    pattern = (bpm, int(rng.integers(0, 1 << 2 * bpm)),
               int(rng.integers(0, 1 << 2 * bpm)))
    words = rng.integers(-(1 << 31), 1 << 31, (nseg, W))
    sel = (rng.integers(0, 4, nseg), rng.integers(0, 4, nseg))
    _scan_both(cuda, (words, rng.integers(0, 32 * W + 1, nseg),
                      rng.integers(0, bps + 1, nseg), *sel), tab, bps,
               pattern, offset=2)
    bstart = np.sort(rng.integers(0, 32 * W + 1, (nseg, bps + 1)), axis=1)
    _block_both(cuda, words, bstart, rng.integers(0, bps + 1, nseg), *sel,
                tab, pattern, offset=1)


FOREIGN_LAYOUTS = {"planar_444": (False, None),
                   "planar_420": (False, SAMPLINGS["420"]),
                   "il_444": (True, ((1, 1), (1, 1), (1, 1))),
                   "il_420": (True, SAMPLINGS["420"])}


def _foreign_params(layout, tables="annexk", rst=0, quality=75):
    il, samp = FOREIGN_LAYOUTS[layout]
    p = gt.Parameters(quality=quality, restart_interval=rst, interleaved=il,
                      huffman_tables=tables)
    return p.chroma_subsampled(samp) if samp else p


@pytest.mark.gpu
@pytest.mark.parametrize("layout,tables", [
    (layout, "annexk") for layout in FOREIGN_LAYOUTS] + [
    ("il_420", "tuned")])
def test_restart0_kernels_match_plain(cuda, layout, tables):
    """A 128x96 stream at restart interval 0 (a scan one segment, a
    thread walking it in phase A; rows of unequal block counts in planar
    4:2:0): phases A and C bit for bit their plain versions (the plain
    scan steps a token of the longest segment at a time), and the card's
    decode the CPU's pixels."""
    frame = _frame(96, 128, 4)
    data = gt.Encoder(device="cpu").encode(frame,
                                           _foreign_params(layout, tables))
    hf, p, words, nbits = _device_frame(data, cuda)
    assert words.shape[0] == p.geo.scan_count
    args = (p.nblocks, p.dc_luma, p.ac_luma, p.tables)
    bstart, err_a = thd.scan_segments(words, nbits, *args, p.bps, p.pattern,
                                      p.scan_lut)
    p_bstart, p_err_a = thd.scan_segments_plain(words, nbits, *args, p.bps,
                                                p.pattern)
    assert torch.equal(bstart, p_bstart) and torch.equal(err_a, p_err_a)
    coefs, err_c = thd.decode_blocks(words, bstart, *args, p.pattern,
                                     p.block_lut)
    p_coefs, p_err_c = thd.decode_blocks_plain(words, bstart, *args,
                                               p.pattern)
    assert torch.equal(coefs, p_coefs) and torch.equal(err_c, p_err_c)
    assert not bool(err_a.any()) and not bool(err_c.any())
    assert np.array_equal(gt.Decoder(device=cuda).decode(data),
                          gt.Decoder(device="cpu").decode(data))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(FOREIGN_LAYOUTS))
@pytest.mark.parametrize("tables,rst", [("annexk", gt.RESTART_AUTO),
                                        ("annexk", 0), ("tuned", 0)])
def test_foreign_encode_on_card_matches_cpu(cuda, layout, tables, rst):
    """Annex-K encodes (tokens, then pack_stuff_rows) and restart-0
    encodes (scan tokens, host packer) on the card write the CPU's bytes,
    and the card decodes them to the CPU's pixels; the Annex-K route with
    restart markers launches the packer and not the Huffman kernel."""
    frame = _frame(93, 121, 6)
    params = _foreign_params(layout, tables, rst)
    _kernels.reset_launches()
    got = gt.Encoder(device=cuda).encode(frame, params)
    torch.cuda.synchronize()
    if rst != 0:
        assert _kernels.LAUNCHES["pack_stuff_rows"] >= 1
        assert _kernels.LAUNCHES["huffman_segments"] == 0
    assert got == gt.Encoder(device="cpu").encode(frame, params)
    assert np.array_equal(gt.Decoder(device=cuda).decode(got),
                          gt.Decoder(device="cpu").decode(got))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["planar_444", "il_420"])
@pytest.mark.parametrize("rst", [gt.RESTART_AUTO, 0])
def test_three_table_sets_on_card(cuda, layout, rst):
    """A stream of three AC table sets decodes on the card through the
    four-set kernel instances to the CPU's pixels and to the unmodified
    stream's."""
    frame = _frame(96, 128, 8)
    base = gt.Encoder(device="cpu").encode(
        frame, _foreign_params(layout, "tuned", rst, 85))
    data = scan_rows.three_sets(base)
    dec = gt.Decoder(device=cuda)
    assert tuple(dec.prepare(data).plan.tables.shape) == (8, 290)
    _kernels.reset_launches()
    got = dec.decode(data)
    # one phase A launch, the instance scan_instance picks for the rows
    # (at restart 0 the scan's row may be long enough for the sync one)
    inst = thd.scan_instance(*dec.prepare(data).words.shape)
    assert _kernels.INSTANCES[f"huffdec_scan/{inst}"] == 1
    assert _kernels.LAUNCHES["huffdec_scan"] + \
        _kernels.LAUNCHES["huffdec_scan_sync"] == 1
    assert _kernels.LAUNCHES["huffdec_block"] == 1
    assert np.array_equal(got, gt.Decoder(device="cpu").decode(data))
    assert np.array_equal(got, dec.decode(base))


@pytest.mark.gpu
def test_decode_kernels_refuse_int32_cursor_overflow(cuda):
    """Rows of 2^26 words hold 2^31 bits, past the kernels' int32 bit
    cursors: both wrappers raise instead of wrapping."""
    words = torch.empty((1, 1 << 26), dtype=torch.int32, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    tab = scan_rows.decode_tables(scan_rows.annexk_tables()).to(cuda)
    lut = torch.from_numpy(thd.scan_lut(tab.cpu().numpy())).to(cuda)
    with pytest.raises(ValueError, match="int32"):
        thd.scan_segments(words, one, one, one, one, tab, 1, lut=lut)
    blut = torch.from_numpy(thd.block_lut(tab.cpu().numpy())).to(cuda)
    bstart = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        thd.decode_blocks(words, bstart, one, one, one, tab, lut=blut)


# -- the DC fix-up (csrc/dc_fixup.cu) -----------------------------------------

#: (rows, slots a row, the component of each slot of an MCU): the tuned
#: paths' short rows (planar, interleaved 4:2:0, interleaved 4:4:4 of two
#: MCUs), rows that tile whole (64 slots; 65, 3 rows a tile), and restart
#: 0's long rows of one tile and more, chained tiles (planar, interleaved
#: with a pattern)
FIXUP_CASES = [(5000, 8, (0,)), (3000, 6, (0, 0, 0, 0, 1, 2)),
               (3000, 6, (0, 1, 2)), (9, 64, (0, 1)), (7, 65, (0,)),
               (3, 20000, (0,)), (1, 8193, (0,)),
               (1, 30000, (0, 0, 0, 0, 1, 2)), (2, 24576, (0, 1, 2))]


def fixup_plan(bps, ent, device="cpu"):
    """The fields of a decoder Plan that dc_fixup reads, for rows of bps
    slots whose MCU's slots belong to components ent, as _make_plan sets
    them, and the plan's cache of the fix-up's look-back records."""
    bpm = len(ent)
    slot_comp = np.tile(np.asarray(ent), bps // bpm)
    slots = None if bpm == 1 else tuple(
        torch.from_numpy(np.flatnonzero(slot_comp == c)).to(device)
        for c in sorted(set(ent)))
    return types.SimpleNamespace(
        bps=bps, comp_slots=slots,
        comp_pattern=(bpm, sum(e << 2 * j for j, e in enumerate(ent)),
                      len(set(ent))), fixup_scratch={})


def dc_coefs(seed, nseg, bps, amp=2047):
    """(64, nseg * bps) int16 coefficients, seeded, in [-amp, amp]: row 0
    the differential DCs."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-amp, amp + 1, (64, nseg * bps))
                            .astype(np.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("nseg,bps,ent", FIXUP_CASES)
def test_dc_fixup_kernel_matches_plain(cuda, nseg, bps, ent):
    """The fix-up kernel equals its plain version _dc_fixup_t bit for bit
    in place, sums past int16 wrapping as the torch cumsum's do, rows 1-63
    untouched, in one counted launch."""
    want = tdec._dc_fixup_t(dc_coefs(nseg + bps, nseg, bps), nseg, bps,
                            fixup_plan(bps, ent).comp_slots)
    x = dc_coefs(nseg + bps, nseg, bps).to(cuda)
    _kernels.reset_launches()
    out = tdec.dc_fixup(x, fixup_plan(bps, ent, cuda))
    assert out is x and _kernels.LAUNCHES["dc_fixup"] == 1
    assert torch.equal(out.cpu(), want)


@pytest.mark.gpu
def test_dc_fixup_kernel_refuses(cuda):
    """The wrapper raises on what the kernel does not take, and never
    takes the plain version for a CUDA tensor."""
    plan = fixup_plan(8, (0,), cuda)
    with pytest.raises(ValueError, match="int16"):
        tdec.dc_fixup(torch.zeros((64, 16), dtype=torch.int32,
                                  device=cuda), plan)
    with pytest.raises(ValueError, match="contiguous"):
        tdec.dc_fixup(torch.zeros((16, 64), dtype=torch.int16,
                                  device=cuda).T, plan)


# -- the session surface on the card ------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["planar_444", "il_420"])
def test_pipelined_sessions_on_card(cuda, layout):
    """encode_pipelined and decode_pipelined on the card: every stream the
    CPU's bytes, every yielded array (all kept to the end) the CPU's
    pixels; the device-only decode and a warmed session agree; the stats
    of a frame are filled from its events."""
    p = _foreign_params(layout, "tuned", gt.RESTART_AUTO, 75)
    frames = [_frame(96, 128, 40 + i) for i in range(3)] \
        + [_frame(96, 128, 43, amp=127)]
    cpu_enc, cpu_dec = gt.Encoder(device="cpu"), gt.Decoder(device="cpu")
    want = [cpu_enc.encode(f, p) for f in frames]
    enc = gt.Encoder(device=cuda)
    enc.perf_stats = True
    assert list(enc.encode_pipelined(frames, p)) == want
    st = enc.get_stats()
    assert st.duration_in_gpu > 0 and st.duration_memory_to > 0
    assert st.duration_huffman_coder > 0 and st.duration_memory_from > 0
    dec = gt.Decoder(device=cuda)
    dec.perf_stats = True
    kept = list(dec.decode_pipelined(want + want[:2]))
    for data, got in zip(want + want[:2], kept):
        assert np.array_equal(got, cpu_dec.decode(data))
    assert len({g.ctypes.data for g in kept}) == len(kept)
    fn, words, nbits = dec.compile_stream_pipeline(want[1])
    assert np.array_equal(fn(words, nbits).cpu().numpy(), kept[1])
    warm = gt.Decoder(device=cuda)
    warm.warmup(want[0])
    assert np.array_equal(warm.decode(want[2]), kept[2])
    assert dec.get_stats().duration_in_gpu > 0


@pytest.mark.gpu
def test_encoder_memory_estimate_on_card(cuda):
    """estimate_memory is not below the peak device bytes of one encode
    at HD in planar 4:4:4 and interleaved 4:2:0."""
    frame = _frame(1080, 1920, 50)
    enc = gt.Encoder(device=cuda)
    for layout in ("planar_444", "il_420"):
        p = _foreign_params(layout, "tuned", gt.RESTART_AUTO, 75)
        enc.encode(frame, p)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        enc.encode(frame, p)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        assert gt.Encoder.estimate_memory(
            p, enc.resolve(frame, p).param_image) >= peak


# -- every pixel format, component count and sampling -----------------------

from gpujpeg_tpu_torch.utils.geometry import get_geometry  # noqa: E402

from tests import format_cases as fc  # noqa: E402

S411 = ((4, 1), (1, 1), (1, 1))

#: (input kind, sampling or None for the format's own, interleaved)
PRE_FORMAT_CASES = [
    ("u8", None, False), ("u8_flat", None, False),
    ("u8", ((1, 1),) * 3, False), ("rgb", ((1, 1),), False),
    ("rgb_pad", None, False), ("rgba", None, False),
    ("rgba", None, True), ("rgba", SAMPLINGS["420"], False),
    ("rgba_pad", None, False), ("uyvy", None, False),
    ("uyvy_pad", None, True), ("p444", None, False), ("p422", None, True),
    ("p420", None, False), ("p420", ((1, 1),) * 3, False),
    ("rgb", S411, True), ("rgb", ((2, 2), (2, 1), (2, 1)), True),
    ("rgb_pad", ((2, 2), (1, 1), (1, 1)), False)]


def _format_geo(raw, pf, pad, hw, samp=None, il=False):
    pi = fc.image_params(gt, pf, *hw, pad)
    return gt.Encoder(device="cpu").resolve(raw, fc.params(gt, samp, il),
                                            pi)


#: image sizes of the format tests: W % 16 == 6, 0 and 15 (an odd width:
#: no UYVY)
FORMAT_HW = [(233, 310), (1080, 1920), (61, 1103)]


def _instance_run(name, fn, monkeypatch, pick):
    """fn() on the card with the instance the wrapper picks, then with the
    generic one (the chooser patched to 0); returns (result, the picked
    instance's name, the generic result).  One launch each, of the
    instance named."""
    _kernels.reset_launches()
    got = fn()
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[name] == 1
    (key, n), = _kernels.INSTANCES.items()
    assert n == 1 and key.startswith(f"{name}/")
    inst = key.split("/", 1)[1]
    assert inst == pick(got)
    monkeypatch.setattr(tpre, "pre_instance" if name == "pre_rgb_to_planes"
                        else "post_instance", lambda *a: 0)
    _kernels.reset_launches()
    gen = fn()
    torch.cuda.synchronize()
    assert _kernels.INSTANCES == {f"{name}/generic": 1}
    monkeypatch.undo()
    return got, inst, gen


@pytest.mark.gpu
@pytest.mark.parametrize("kind,samp,il,hw", [
    c + (hw,) for hw in FORMAT_HW for c in PRE_FORMAT_CASES
    if not (hw[1] % 2 and c[0].startswith("uyvy"))])
def test_pre_kernel_every_format(cuda, kind, samp, il, hw, monkeypatch):
    """The preprocessor on every input kind (2-D, 3-D and flat, padded
    rows, UYVY, the planar formats) at 1 to 4 components and 4:1:1 and
    subsampled-chroma layouts: one launch of the instance pre_instance
    picks (a vector instance exactly where every row starts on a 16-byte
    boundary: at W = 1920 unless the rows are padded off it, and UYVY
    padded to 624 bytes at W = 310; the generic one otherwise), bit for
    bit the plain version, and so is the generic instance on the same
    input."""
    raw, pf, pad = fc.raw_input(kind, *hw, seed=len(kind) + hw[0])
    geo = _format_geo(raw, pf, pad, hw, samp, il)
    x = torch.from_numpy(raw).to(cuda)
    pi = geo.param_image
    pick = lambda got: tpre.INSTANCES[tpre.pre_instance(
        x, got, tpre.pre_geometry(geo), tpre.pre_source(x, geo, pi))]
    got, inst, gen = _instance_run(
        "pre_rgb_to_planes", lambda: tpre.preprocess_packed(x, geo, pi),
        monkeypatch, pick)
    src = tpre.pre_source(x, geo, pi)
    rows16 = (hw[1] if src[0] == 2 else int(src[2])) % 16 == 0
    assert (inst == "generic") != rows16
    ref = tpre.preprocess_packed_plain(x, geo, pi)
    assert len(got) == len(ref) == geo.comp_count
    for c, a, g, b in zip(geo.components, got, gen, ref):
        assert a.shape == (c.data_height, c.data_width)
        assert torch.equal(a, b), c.index
        assert torch.equal(g, b), c.index


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["u8_flat", "rgb_pad", "rgba_pad",
                                  "uyvy_pad"])
@pytest.mark.parametrize("hw", [(233, 310), (61, 1103), (40, 1096)])
def test_pre_kernel_padded_tail(cuda, kind, hw, monkeypatch):
    """Flat rows padded to a pitch that is a multiple of 16 at W % 16 in
    {6, 15, 8}: the vector instance takes them and loads the ragged last
    group of each row a byte at a time; bit for bit the plain version and
    the generic instance."""
    if kind == "uyvy_pad" and hw[1] % 2:
        hw = (hw[0], hw[1] - 1)
    raw, pf, _ = fc.raw_input(kind, *hw, seed=hw[1])
    unit = fc.UNIT[pf]
    rows = raw.reshape(hw[0], -1)[:, :hw[1] * unit]
    pitch = -(-rows.shape[1] // 16) * 16 + 16
    raw = np.concatenate([rows, np.full((hw[0], pitch - rows.shape[1]), 9,
                                        np.uint8)], 1).reshape(-1)
    geo = _format_geo(raw, pf, pitch - rows.shape[1], hw)
    x = torch.from_numpy(raw).to(cuda)
    pi = geo.param_image
    pick = lambda got: tpre.INSTANCES[tpre.pre_instance(
        x, got, tpre.pre_geometry(geo), tpre.pre_source(x, geo, pi))]
    got, inst, gen = _instance_run(
        "pre_rgb_to_planes", lambda: tpre.preprocess_packed(x, geo, pi),
        monkeypatch, pick)
    assert inst != "generic"
    for a, g, b in zip(got, gen, tpre.preprocess_packed_plain(x, geo, pi)):
        assert torch.equal(a, b) and torch.equal(g, b)


@pytest.mark.gpu
@pytest.mark.parametrize("nin", [1, 2, 4, 5])
def test_pre_kernel_any_channel_count(cuda, nin):
    """An (H, W, C) image of any channel count (a channel remap's result)
    encoded as 3 components: missing channels are 128, extra ones are
    not read."""
    hw = (61, 83)
    raw = fc.gradient(*hw, nin, seed=nin)
    geo = _format_geo(raw, "P444_U8_P012", 0, hw)
    x = torch.from_numpy(raw).to(cuda)
    got = tpre.preprocess_packed(x, geo, geo.param_image)
    ref = tpre.preprocess_packed_plain(x, geo, geo.param_image)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


#: (components' sampling) of the postprocessor's format cases
POST_SAMPLINGS = {"grey": ((1, 1),), "444": ((1, 1),) * 3,
                  "420": SAMPLINGS["420"], "422": SAMPLINGS["422"],
                  "411": S411, "four": ((1, 1),) * 4,
                  "four_420": ((2, 2), (1, 1), (1, 1), (2, 2))}


@pytest.mark.gpu
@pytest.mark.parametrize("pf,samp,hw", [
    (pf, samp, hw) for hw in FORMAT_HW + [(37, 1096)] for pf in fc.OUTPUTS
    for samp in POST_SAMPLINGS
    if not (hw[1] % 2 and pf == "P422_U8_P1020")])
def test_post_kernel_every_format(cuda, pf, samp, hw, monkeypatch):
    """The postprocessor to every output format from 1, 3 and 4 planes at
    several samplings (RGBA alpha 255 or the raw 4th plane, UYVY, the
    planar formats): one launch of the instance post_instance picks (a
    vector instance at W = 1920; at W = 1096 RGBA and UYVY store their
    ragged last group a byte or a word at a time), the plain version's
    shape and bytes, and so does the generic instance."""
    pi = fc.image_params(gt, pf, *hw)
    geo = get_geometry(fc.params(gt, POST_SAMPLINGS[samp], rst=8), pi)
    g = torch.Generator().manual_seed(hw[0] + len(samp))
    planes = [torch.randint(0, 256, (c.data_height, c.data_width),
                            dtype=torch.uint8, generator=g).to(cuda)
              for c in geo.components]
    _, gi, dst = tpre.post_target(geo, pi)
    pick = lambda got: tpre.INSTANCES[tpre.post_instance(
        planes, gi, dst, got, hw[1])]
    got, inst, gen = _instance_run(
        "post_rgb", lambda: tpre.postprocess_packed(planes, geo, pi),
        monkeypatch, pick)
    if hw[1] == 1920:
        assert inst != "generic"
    ref = tpre.postprocess_packed_plain(planes, geo, pi)
    assert got.shape == ref.shape == gen.shape
    assert torch.equal(got, ref)
    assert torch.equal(gen, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("samp", ["444", "420"])
@pytest.mark.parametrize("hw", [(1088, 1920), (240, 320), (64, 80)])
def test_dpost_kernel_rgba(cuda, samp, hw):
    """dpost's 4-byte store (P4444_U8_P0123, alpha 255) at dx = dy = 1 and
    2: one launch, bit for bit the plain version, on the stream's
    coefficients and on dense random ones."""
    frame = _frame(*hw, 12)
    data = gt.Encoder(device="cpu").encode(frame, gt.Parameters(
        quality=75, restart_interval=gt.RESTART_AUTO).chroma_subsampled(
        SAMPLINGS.get(samp, ((1, 1),) * 3)))
    dec = gt.Decoder(device=cuda)
    hf = dec.prepare(data, gt.ImageParameters(
        color_space=gt.ColorSpace.RGB,
        pixel_format=gt.PixelFormat.P4444_U8_P0123))
    coefs_t, _ea, _ec = dec.coefficients_t(hf)
    geo, pi = hf.plan.geo, hf.out_pi
    assert tpre.decode_post_supported(geo, pi)
    _kernels.reset_launches()
    got = tpre.decode_post(coefs_t, hf.plan.qtabs, geo, pi)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["dpost_rgb"] == 1
    assert got.shape == (*hw, 4)
    assert torch.equal(got, tpre.decode_post_plain(coefs_t, hf.plan.qtabs,
                                                   geo, pi))
    assert bool((got[..., 3] == 255).all())
    rnd = torch.randint(-600, 600, coefs_t.shape, dtype=torch.int16,
                        generator=torch.Generator().manual_seed(5)).to(cuda)
    assert torch.equal(tpre.decode_post(rnd, hf.plan.qtabs, geo, pi),
                       tpre.decode_post_plain(rnd, hf.plan.qtabs, geo, pi))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,samp,il", PRE_FORMAT_CASES[::2])
def test_formats_encode_on_card_matches_cpu(cuda, kind, samp, il):
    """Whole encodes of the input kinds on the card give the CPU session's
    bytes, through the preprocessor kernel and no plain version."""
    hw = (240, 320)
    raw, pf, pad = fc.raw_input(kind, *hw, seed=3)
    p = fc.params(gt, samp, il)
    pi = fc.image_params(gt, pf, *hw, pad)
    _kernels.reset_launches()
    got = gt.Encoder(device=cuda).encode(raw, p, pi)
    assert _kernels.LAUNCHES["pre_rgb_to_planes"] == 1
    assert got == gt.Encoder(device="cpu").encode(raw, p, pi)


#: (input kind, sampling, interleaved) of the streams the decode format
#: tests decode to every output
DECODE_FORMAT_STREAMS = [("u8", None, False), ("rgb", None, False),
                         ("rgb", SAMPLINGS["420"], False),
                         ("rgb", SAMPLINGS["422"], True),
                         ("rgba", None, False), ("rgb", S411, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("stream", range(len(DECODE_FORMAT_STREAMS)))
def test_formats_decode_on_card_matches_cpu(cuda, stream):
    """Every output format and pseudo request of greyscale, 3- and
    4-component streams on the card gives the CPU session's array, with
    and without the output options, through dpost or the postprocessor
    kernel."""
    kind, samp, il = DECODE_FORMAT_STREAMS[stream]
    hw = (120, 176)
    raw, pf, pad = fc.raw_input(kind, *hw, seed=stream)
    data = gt.Encoder(device="cpu").encode(raw, fc.params(gt, samp, il))
    reqs = [gt.PixelFormat[pf] for pf in fc.OUTPUTS] + list(
        gt.types.PixelFormatRequest)
    for opts in ((), (("dec_opt_flipped", "true"),
                      ("dec_opt_channel_remap", "2F0Z"),
                      ("dec_opt_alignment_bytes", "64"))):
        card, cpu = gt.Decoder(device=cuda), gt.Decoder(device="cpu")
        for k, v in opts:
            card.set_option(k, v)
            cpu.set_option(k, v)
        for req in reqs:
            pi = gt.ImageParameters(color_space=gt.ColorSpace.RGB,
                                    pixel_format=req)
            _kernels.reset_launches()
            got = card.decode(data, pi)
            assert (_kernels.LAUNCHES["post_rgb"]
                    + _kernels.LAUNCHES["dpost_rgb"]) == 1, req
            want = cpu.decode(data, pi)
            assert got.shape == want.shape and np.array_equal(got, want), \
                (req, opts)


def _direct_both(cuda, words, nbits, nb, dcl, acl, tab,
                 pattern=thd.NO_PATTERN, offset=0):
    """Phase C's direct instance and its plain version on the same rows
    (numpy words, nbits, nblocks, dc_luma, ac_luma), the plain version
    also against decode_blocks_plain with bstart = (0, nbits): equal
    coefficients and err, which are returned.  offset puts the card's
    word matrix that many words past a 16-byte boundary."""
    words = torch.from_numpy(np.ascontiguousarray(words, np.int32))
    buf = torch.zeros(words.numel() + 4, dtype=torch.int32, device=cuda)
    w_dev = buf[offset:offset + words.numel()].view(words.shape)
    w_dev.copy_(words)
    rows = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (nbits, nb, dcl, acl)]
    lut = torch.from_numpy(thd.direct_lut(tab.numpy())).to(cuda)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="lut"):
        thd.decode_blocks_direct(w_dev, *[r.to(cuda) for r in rows],
                                 tab.to(cuda), pattern)
    got = thd.decode_blocks_direct(w_dev, *[r.to(cuda) for r in rows],
                                   tab.to(cuda), pattern, lut)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffdec_block_direct"] == 1
    assert _kernels.LAUNCHES["huffdec_block"] == 0
    want = thd.decode_blocks_direct_plain(words, *rows, tab, pattern)
    bstart = torch.stack([torch.zeros_like(rows[0]), rows[0]], 1)
    seg = thd.decode_blocks_plain(words, bstart, *rows[1:], tab, pattern)
    assert torch.equal(want[0], seg[0]) and torch.equal(want[1], seg[1])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gradient", "noise"])
def test_block_direct_matches_plain(cuda, kind):
    """The direct instance on a Q100 stream at the auto interval (one
    block a segment) against its plain version, and the session's decode
    through it: no phase A, no fix-up, the CPU session's pixels."""
    _, data = _stream(kind, 480, 640, quality=100)
    hf, p, words, nbits = _device_frame(data, cuda)
    assert p.direct
    _direct_both(cuda, hf.words, hf.nbits, p.nblocks.cpu(),
                 p.dc_luma.cpu(), p.ac_luma.cpu(), p.tables.cpu())
    dec = gt.Decoder(device=cuda)
    _kernels.reset_launches()
    got = dec.decode(data)
    counts = dict(_kernels.LAUNCHES)
    assert counts["huffdec_block_direct"] == 1
    assert counts["huffdec_scan"] == counts["dc_fixup"] == \
        counts["huffdec_block"] == 0
    assert np.array_equal(got, gt.Decoder(device="cpu").decode(data))
    _kernels.reset_launches()
    coefs = dec.decode_coefficients(data)      # keeps phases A and C
    assert _kernels.LAUNCHES["huffdec_scan"] == 1
    want = gt.Decoder(device="cpu").decode_coefficients(data)
    assert all(np.array_equal(a, b) for a, b in zip(coefs, want))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(scan_rows.RESTART_LONG))
def test_restart_long_on_card_matches_cpu(cuda, name):
    """Streams whose restart interval exceeds a scan's MCU count (ROADMAP
    Q13, scan_rows.RESTART_LONG), so that every segment's nblocks is
    below the interval's blocks: decode_coefficients through phases A
    and C and the DC fix-up, and decode through the same or, at one block
    a segment, the direct instance, give the CPU session's coefficients
    and pixels exactly (tests/test_torch_restart_long.py holds the CPU
    session against the JAX package)."""
    frame, p = scan_rows.restart_long(gt, name)
    data = gt.Encoder(device="cpu").encode(frame, p)
    dec, cpu = gt.Decoder(device=cuda), gt.Decoder(device="cpu")
    plan = dec.prepare(data).plan
    bpm = plan.pattern[0] if plan.geo.interleaved else 1
    assert (plan.nblocks.cpu() < scan_rows.RESTART_LONG[name][1] * bpm).all()
    _kernels.reset_launches()
    coefs = dec.decode_coefficients(data)
    for k in ("huffdec_scan", "huffdec_block", "dc_fixup"):
        assert _kernels.LAUNCHES[k] == 1, _kernels.LAUNCHES
    want = cpu.decode_coefficients(data)
    assert len(coefs) == len(want) == 3
    for a, b in zip(coefs, want):
        assert a.shape == b.shape and np.array_equal(a, b)
    _kernels.reset_launches()
    got = dec.decode(data)
    ran = (("huffdec_block_direct",) if plan.direct else
           ("huffdec_scan", "huffdec_block", "dc_fixup"))
    for k in ran:
        assert _kernels.LAUNCHES[k] == 1, _kernels.LAUNCHES
    want = cpu.decode(data)
    assert got.shape == want.shape == frame.shape
    assert np.array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("sets", [2, 4])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_block_direct_coded_rows(cuda, sets, offset):
    """Coded rows of one block (long codes, two or four table sets, the
    segments' selectors at random, some segments empty), the word matrix
    off 16-byte alignment: bit for bit the plain decode, no error but in
    the empty segments."""
    rng = np.random.default_rng(sets + offset)
    tabs = _scan_tabs(sets)[:2] if sets == 2 else \
        [_scan_tabs(s)[0] for s in range(4)]
    nseg = 700
    nb = (rng.random(nseg) > 0.05).astype(np.int32)
    flags = (rng.integers(0, sets if sets == 4 else 2, nseg),
             rng.integers(0, sets if sets == 4 else 2, nseg))
    pattern = thd.NO_PATTERN if sets == 2 else thd.NO_PATTERN_WIDE
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, 1, tabs, pattern, flags, nb, long_share=0.5)
    words, nbits = scan_rows.word_matrix(rows)
    coefs, err = _direct_both(cuda, words, nbits, nb, dcl, acl,
                              scan_rows.decode_tables(tabs), pattern, offset)
    assert not bool(err.any()) and bool(coefs.any())


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 3, 64])
def test_block_direct_random_words(cuda, W):
    """Random rows (mostly bad tokens) with random bit counts in [0, 32 W]
    and nblocks 0 or 1: bit for bit the plain decode."""
    rng = np.random.default_rng(W)
    nseg = 1000
    words = rng.integers(-(1 << 31), 1 << 31, (nseg, W))
    _, err = _direct_both(cuda, words, rng.integers(0, 32 * W + 1, nseg),
                          rng.integers(0, 2, nseg), rng.integers(0, 2, nseg),
                          rng.integers(0, 2, nseg),
                          scan_rows.decode_tables(_scan_tabs(W)))
    assert bool(err.any())


@pytest.mark.gpu
def test_block_direct_error_kinds(cuda):
    """Each error kind of scan_rows.block_error_rows with every block in a
    row of its own (its bits from its first on, bounded by its length):
    the segment-row mode's errors, bit for bit the plain decode."""
    words, bstart, nblocks, tab, want = scan_rows.block_error_rows()
    rows, bits, keep = [], [], []
    for s in range(len(nblocks)):
        row = np.unpackbits(words[s].view(np.uint8))
        for j in range(int(nblocks[s])):
            lo, hi = int(bstart[s, j]), int(bstart[s, j + 1])
            rows.append(np.packbits(row[lo:]).tobytes())
            bits.append(hi - lo)
            keep.append(want[s][j])
    w, _ = scan_rows.word_matrix(rows)
    ones = np.ones(len(rows), np.int32)
    _, err = _direct_both(cuda, w, np.asarray(bits), ones, ones, ones, tab)
    assert err.tolist() == keep


@pytest.mark.gpu
def test_cli_on_card(cuda, tmp_path):
    """The tool with -D 0 writes the bytes of an in-process Encoder on the
    card and decodes to the pixels of a Decoder on the card, Q75 and the
    direct route at Q100."""
    from gpujpeg_tpu_torch import cli
    from gpujpeg_tpu_torch.io import image as tio, pnm

    frame = _frame(240, 320, 5)
    src = tmp_path / "in.ppm"
    src.write_bytes(pnm.save_pnm(gt.ImageParameters(width=320, height=240),
                                 frame))
    for q in (75, 100):
        jpg, back = tmp_path / f"q{q}.jpg", tmp_path / f"q{q}.ppm"
        assert cli.main(["-D", str(cuda.index or 0), "-q", str(q), str(src),
                         str(jpg)]) == 0
        want = gt.Encoder(device=cuda).encode(frame, gt.Parameters(
            quality=q, restart_interval=gt.RESTART_AUTO))
        assert jpg.read_bytes() == want
        _kernels.reset_launches()
        assert cli.main(["-D", str(cuda.index or 0), str(jpg),
                         str(back)]) == 0
        assert _kernels.LAUNCHES["huffdec_block_direct"] == (q == 100)
        arr, _pi = tio.load(str(back))
        assert np.array_equal(arr, gt.Decoder(device=cuda).decode(want))



PARALLEL_LAYOUTS = {
    "planar_444": dict(),
    "il_420": dict(interleaved=True),
    "annexk": dict(huffman_tables="annexk"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(PARALLEL_LAYOUTS))
def test_parallel_on_card_matches_cpu(cuda, layout):
    """BatchEncoder over 2 frames x 2 stripes, every place cuda:0, writes
    the CPU Encoder's bytes; ShardedDecoder and BatchDecoder on the card
    give the CPU Decoder's arrays."""
    from gpujpeg_tpu_torch.parallel import batch as pb, mesh as pm

    frames = np.stack([_frame(128, 192, 60 + i) for i in range(2)])
    p = gt.Parameters(quality=80, restart_interval=4,
                      **PARALLEL_LAYOUTS[layout])
    if layout == "il_420":
        p = p.chroma_subsampled(((2, 2), (1, 1), (1, 1)))
    pi = gt.ImageParameters(width=192, height=128)
    be = pb.BatchEncoder(pm.make_mesh(4, data=2, seg=2, device=cuda), p, pi)
    enc = gt.Encoder(device="cpu")
    want = [enc.encode(f, p, pi) for f in frames]
    assert be.encode_batch(frames) == want
    dec = gt.Decoder(device="cpu")
    ref = [dec.decode(s) for s in want]
    bd = pb.BatchDecoder(pm.make_mesh(2, data=2, seg=1, device=cuda),
                         want[0], batch_size=2)
    assert all(np.array_equal(a, b) for a, b in zip(bd.decode_batch(want),
                                                    ref))
    if layout != "il_420":
        sd = pb.ShardedDecoder(pm.make_mesh(4, data=1, seg=4, device=cuda),
                               want[0])
        for s, r in zip(want, ref):
            assert np.array_equal(sd.decode(s), r)


@pytest.mark.gpu
@pytest.mark.parametrize("il", [False, True])
def test_restart0_device_rows_on_card(cuda, il):
    """encode_to_device at restart interval 0 on the card: a row a scan
    through the token-row packer, assembled to the CPU encode's bytes."""
    frame = _frame(96, 128, 70)
    p = gt.Parameters(quality=75, restart_interval=0, interleaved=il)
    enc = gt.Encoder(device=cuda)
    geo, res, meta = enc.encode_to_device(frame, p)
    assert [r.shape[0] for r in res["rows"]] == [1] * geo.scan_count
    assert enc.assemble(geo, res, meta) == \
        gt.Encoder(device="cpu").encode(frame, p)


@pytest.mark.gpu
@pytest.mark.parametrize("il", [False, True])
def test_batch_encode_restart0_on_card(cuda, il):
    """BatchEncoder at restart interval 0 on a (2, 1) mesh of cuda:0: each
    frame's scan tokens come back and are packed on the host, the CPU
    encode's bytes."""
    from gpujpeg_tpu_torch.parallel import batch as pb, mesh as pm

    frames = np.stack([_frame(96, 128, 72 + i) for i in range(2)])
    p = gt.Parameters(quality=75, restart_interval=0, interleaved=il)
    pi = gt.ImageParameters(width=128, height=96)
    be = pb.BatchEncoder(pm.make_mesh(2, data=2, seg=1, device=cuda), p, pi)
    enc = gt.Encoder(device="cpu")
    assert be.encode_batch(frames) == [enc.encode(f, p, pi) for f in frames]


@pytest.mark.gpu
def test_scan_rows_refuses_past_int32(cuda):
    """A scan whose worst-case row passes 2^31 bytes (15360x8640
    interleaved 4:4:4: 6,220,800 blocks) packs on the card through the
    packer's scan instance (64-bit offsets), and encode_to_device's rows
    assemble to encode()'s bytes."""
    frame = _frame(8640, 15360, 90)
    p = gt.Parameters(quality=75, restart_interval=0, interleaved=True)
    enc = gt.Encoder(device=cuda)
    tabs = tfp.class_tables(75, True, "cpu")
    assert tfp.SlotTables((tabs, tabs), (0, 1, 1), (0, 1, 2)).stride(
        3 * 2073600) > (1 << 31) - 1
    _kernels.reset_launches()
    geo, res, meta = enc.encode_to_device(frame, p)
    got = enc.assemble(geo, res, meta)
    assert {k: v for k, v in _kernels.INSTANCES.items()
            if k.startswith("pack_stuff_rows/")} == {"pack_stuff_rows/scan": 1}
    assert res["rows"][0].shape[1] > (1 << 31) - 1
    assert got == enc.encode(frame, p)


def _sync_rows(seed, nsets, bpm, nseg=3, bps=900, long_share=0.3):
    """Long coded rows (900 blocks, rows of unequal length) of two table
    sets (long codes, Annex K) or four (three long-code sets and Annex
    K), with a slot pattern of bpm slots: (words, nbits, nblocks, dc_sel,
    ac_sel), tables, pattern."""
    rng = np.random.default_rng(seed)
    if nsets == 2:
        tabs = _scan_tabs(seed)
        pattern = (bpm, int(rng.integers(1, 1 << bpm)),
                   int(rng.integers(1, 1 << bpm)))
        flags = (rng.integers(0, 2, nseg), rng.integers(0, 2, nseg))
    else:
        tabs = [scan_rows.long_code_tables(seed + i) for i in range(3)] + \
            [scan_rows.annexk_tables()[1]]
        pattern = (bpm, int(rng.integers(0, 1 << 2 * bpm)),
                   int(rng.integers(0, 1 << 2 * bpm)))
        flags = (rng.integers(0, 4, nseg), rng.integers(0, 4, nseg))
    nblocks = np.asarray([bps, bps // 3, bps - 7][:nseg])
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern, flags, nblocks,
        long_share=long_share)
    words, nbits = scan_rows.word_matrix(rows)
    return (words, nbits, nb, dcl, acl), scan_rows.decode_tables(tabs), \
        pattern


@pytest.mark.gpu
@pytest.mark.parametrize("nsets,bpm,seed", [(2, 1, 0), (2, 3, 1), (2, 6, 2),
                                            (4, 1, 3), (4, 3, 4)])
def test_scan_sync_matches_serial_and_plain(cuda, nsets, bpm, seed):
    """Phase A's sync instance on long rows (hundreds of subsequences, a
    few chunks), two and four table sets, slot patterns of 1-6 slots: bit
    for bit the serial instance and the plain version, no error."""
    args, tab, pattern = _sync_rows(seed, nsets, bpm)
    want = _scan_both(cuda, args, tab, 900, pattern, instance="sync")
    _scan_both(cuda, args, tab, 900, pattern, instance="serial")
    assert not bool(want[1].any())


@pytest.mark.gpu
def test_scan_sync_corrupt_and_truncated(cuda):
    """Rows with 32 one bits mid-row, a bit count ending mid-block and a
    row a block short: err and bstart as the serial instance and the
    plain version."""
    (words, nbits, nb, dcl, acl), tab, pattern = _sync_rows(5, 2, 3)
    words[0, words.shape[1] // 2] = -1
    nbits = nbits.copy()
    nbits[1] = nbits[1] // 2 + 5
    nb = nb.copy()
    nb[2] += 1
    args = (words, nbits, nb, dcl, acl)
    want = _scan_both(cuda, args, tab, 901, pattern, instance="sync")
    _scan_both(cuda, args, tab, 901, pattern, instance="serial")
    assert want[1].tolist() == [True, True, True]


@pytest.mark.gpu
@pytest.mark.parametrize("nblocks", [5000, 300_000])
def test_scan_sync_never_resynchronises(cuda, nblocks):
    """A row that never resynchronises (tests/test_torch_scan_sync.py's
    _unsyncable: every block 4 zero bits after a 7-bit first block, so
    every guess stays out of phase): the chain of chunks resolves one
    after another, equal to the plain version (5,000 blocks) and to the
    serial instance (300,000 blocks, ten chunks; the plain version would
    step 600,000 tokens)."""
    dc = scan_rows._dht([2, 3, 3, 3, 3, 4, 4, 5, 5, 6, 6, 7],
                        list(range(12)))
    ac = scan_rows._dht([2] + [4] * 4 + [6] * 10,
                        [0x00, 0x01, 0x02, 0x11, 0xF0, 0x03, 0x04, 0x05,
                         0x12, 0x21, 0x31, 0x41, 0x13, 0x51, 0x61])
    bits = "01111" + "00" + "0000" * (nblocks - 1)
    bits += "1" * (-len(bits) % 8)
    data = int(bits, 2).to_bytes(len(bits) // 8, "big")
    words, nbits = scan_rows.word_matrix([data])
    tab = scan_rows.decode_tables([(dc, ac), (dc, ac)])
    one = np.ones(1, np.int32)
    args = (words, nbits, one * nblocks, one, one)
    if nblocks <= 5000:
        want = _scan_both(cuda, args, tab, nblocks, instance="sync")
        assert not bool(want[1].any())
        return
    w_dev = torch.from_numpy(words).to(cuda)
    rows = [torch.from_numpy(np.asarray(a, np.int32)).to(cuda)
            for a in args[1:]]
    lut = torch.from_numpy(thd.scan_lut(tab.numpy())).to(cuda)
    stats = {}
    got = thd.scan_segments(w_dev, *rows, tab.to(cuda), nblocks,
                            thd.NO_PATTERN, lut, "sync", stats)
    want = thd.scan_segments(w_dev, *rows, tab.to(cuda), nblocks,
                             thd.NO_PATTERN, lut, "serial")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool(got[1].any())
    assert stats["chunks"] >= 9 and stats["redo"] == stats["chunks"] - 1


@pytest.mark.gpu
@pytest.mark.parametrize("rst,inst", [(0, "sync"), (gt.RESTART_AUTO,
                                                    "serial")])
def test_scan_instance_on_decode(cuda, rst, inst):
    """A 1920x1080 decode launches the sync instance at restart interval
    0 and the serial one at restart auto (_kernels.INSTANCES): restart
    0's pixels equal restart auto's, and those the CPU's (the CPU's plain
    phase A would walk a restart-0 scan for minutes)."""
    frame = _frame(1080, 1920, 91)
    data = gt.Encoder(device="cpu").encode(frame, gt.Parameters(
        quality=75, restart_interval=rst))
    auto = gt.Encoder(device="cpu").encode(frame, gt.Parameters(
        quality=75, restart_interval=gt.RESTART_AUTO))
    _kernels.reset_launches()
    got = gt.Decoder(device=cuda).decode(data)
    assert {k: v for k, v in _kernels.INSTANCES.items()
            if k.startswith("huffdec_scan/")} == {f"huffdec_scan/{inst}": 1}
    hf = gt.Decoder(device="cpu").prepare(data)
    assert thd.scan_instance(*hf.words.shape) == inst
    assert np.array_equal(got, gt.Decoder(device="cpu").decode(auto))


@pytest.mark.gpu
@pytest.mark.parametrize("n,ff_bias,marker", [
    (0, False, 0xD1), (1, False, 0), (4095, False, 0xD2), (4096, True, 0),
    (4097, False, 0xD3), (1_000_003, False, 0), (1_000_003, True, 0xD4),
    (9_000_000, False, 0)])
def test_pack_stuff_scan_matches_plain(cuda, n, ff_bias, marker):
    """The packer's scan instance on one long row of n tokens (chunks of
    4096 tokens a CTA; all-ones tokens for runs of 0xFF across chunk
    edges): equal to the plain version (the tokens as one row) and to the
    host packer."""
    from gpujpeg_tpu_torch import native

    rng = np.random.default_rng(n + ff_bias)
    lens = rng.integers(1, 28, n).astype(np.int32)
    bits = rng.integers(0, 1 << 27, n)
    if ff_bias:
        bits = np.where(rng.random(n) < 0.8, (1 << 27) - 1, bits)
    bits = (bits & ((1 << lens) - 1)).astype(np.int32)
    stride = _pack_stride(max(n, 1))
    b, ln = torch.from_numpy(bits).to(cuda), torch.from_numpy(lens).to(cuda)
    _kernels.reset_launches()
    rows, rb, needs = tfp.pack_stuff_scan(b, ln, marker, stride)
    torch.cuda.synchronize()
    assert _kernels.INSTANCES == {"pack_stuff_rows/scan": 1}
    p_rows, p_rb, p_needs = tfp.pack_stuff_scan_plain(b, ln, marker, stride)
    assert torch.equal(needs, p_needs)
    assert _rows_equal(rows, rb, p_rows, p_rb)
    if n <= 1_000_003:
        host = native.pack_tokens(bits.view(np.uint32), lens)
        nbytes = int(rb[0]) - (2 if marker else 0)
        assert bytes(rows[0, :nbytes].cpu().numpy()) == host
