"""PyTorch port, the CUDA kernels against their plain versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q

(``--noconftest`` because tests/conftest.py sets JAX up).  The tests marked
``gpu`` decide inside a fixture whether a card exists and skip without one;
the others check, on any machine, that a wrapper never falls back quietly.
"""

import numpy as np
import pytest
import torch

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models import decoder as tdec
from gpujpeg_tpu_torch.ops import _kernels, fusedpack as tfp
from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre


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


def test_decoder_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.Decoder()


class _FailingLib:
    """Stands in for a kernel library whose launch is refused."""

    def __getattr__(self, name):
        return lambda *args: 98          # cudaErrorInvalidDeviceFunction


@pytest.mark.parametrize("name", ["huffdec_scan", "huffdec_block",
                                  "dpost_rgb"])
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
    bstart, err_a = thd.scan_segments(words, nbits, *args, p.bps)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffdec_scan"] == 1
    p_bstart, p_err_a = thd.scan_segments_plain(words, nbits, *args, p.bps)
    assert torch.equal(bstart, p_bstart) and torch.equal(err_a, p_err_a)
    assert not bool(err_a.any())
    coefs, err_c = thd.decode_blocks(words, bstart, *args)
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
    bstart, err_a = thd.scan_segments(w, nbits, *args, p.bps)
    p_bstart, p_err_a = thd.scan_segments_plain(w, nbits, *args, p.bps)
    assert torch.equal(bstart, p_bstart) and torch.equal(err_a, p_err_a)
    coefs, err_c = thd.decode_blocks(w, bstart, *args)
    p_coefs, p_err_c = thd.decode_blocks_plain(w, bstart, *args)
    assert torch.equal(coefs, p_coefs) and torch.equal(err_c, p_err_c)
    assert bool(err_a[5])


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(1080, 1920), (233, 311)])
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
    frame, data = _stream(kind, *hw, quality=quality, seed=9)
    _kernels.reset_launches()
    got = gt.Decoder(device=cuda).decode(data)
    for name in ("huffdec_scan", "huffdec_block", "dpost_rgb"):
        assert _kernels.LAUNCHES[name] == 1, _kernels.LAUNCHES
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
