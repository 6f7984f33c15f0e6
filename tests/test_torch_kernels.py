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
from gpujpeg_tpu_torch.ops import _kernels, fusedpack as tfp
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
    assert all(n > 0 for n in _kernels.LAUNCHES.values()), _kernels.LAUNCHES
    assert got == gt.Encoder(device="cpu").encode(frame, p)
