"""PyTorch port, entropy stage (DCT + Huffman coding of segment rows): the
plain versions against the JAX package's DCT-fused entropy megakernel and
its coefficient-input mode in interpret mode (the CUDA kernels are held
against the plain versions in test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpujpeg_tpu as gj
from gpujpeg_tpu.models import encoder as jenc
from gpujpeg_tpu.ops import dct as jdct
from gpujpeg_tpu.ops import fusedpack as jfp
from gpujpeg_tpu.utils import tables as jt

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import fusedpack as tfp
from gpujpeg_tpu_torch.ops import sample as tsample

from .test_torch_kernels import _edge_blocks


def _frame(h, w, seed, amp=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  ((xx + yy) * 255 // (w + h))], -1)
    return np.clip(f + rng.integers(-amp, amp, f.shape), 0, 255) \
        .astype(np.uint8)


def _rows_bytes(rows_u32):
    r = np.asarray(rows_u32)
    return np.ascontiguousarray(r.astype(">u4")).view(np.uint8) \
        .reshape(r.shape[0], -1)


def _assert_rows_equal(rows, rb, ref_rows, ref_rb):
    assert np.array_equal(rb, ref_rb)
    for s in range(len(rb)):
        n = int(rb[s])
        assert np.array_equal(rows[s, :n], ref_rows[s, :n]), s


# 64x128 engages the JAX feed's xq layout (segments tile block rows with
# 128 packed words), 120x160 its general block-diagonal layout
@pytest.mark.parametrize("hw", [(64, 128), (120, 160)])
def test_entropy_plain_matches_megakernel_interpret(monkeypatch, hw):
    monkeypatch.setenv("GPUJPEG_TPU_FUSED", "interpret")
    h, w = hw
    frame = _frame(h, w, seed=h)
    geo = gj.Encoder().resolve(
        frame, gj.Parameters(quality=75, restart_interval=gj.RESTART_AUTO),
        None)
    xbd_fn, infos = jenc.make_rows_xbd_impl(geo)
    xbds = xbd_fn(jnp.asarray(frame))
    consts = jt.entropy_kernel_consts(75)
    tgeo = gt.Encoder(device="cpu").resolve(
        frame, gt.Parameters(quality=75, restart_interval=gt.RESTART_AUTO))
    planes = tsample.preprocess(torch.from_numpy(frame), tgeo,
                                tgeo.param_image)
    for c, xbd, info in zip(geo.components, xbds, infos):
        S = info["S"]
        luma_t = np.full((1, S), int(info["luma"]), np.int32)
        r, ob, needs = jfp.entropy_fused_u8(
            xbd, jnp.asarray(info["valid"]), jnp.asarray(luma_t),
            info["rst"], z_cap=64, w_out=1024, consts=consts,
            dct_key=info["dct_key"], interpret=True, compact_after=(),
            xq=info["xq"])
        tabs = tfp.class_tables(75, c.table_index == 0, "cpu")
        rows, rb, t_needs = tfp.entropy_fused_u8(planes[c.index], tabs,
                                                 c.segment_mcu_count)
        _assert_rows_equal(rows.numpy(), rb.numpy(), _rows_bytes(r),
                           np.asarray(ob))
        assert np.array_equal(t_needs.numpy(), np.asarray(needs)[-2:])


def _synthetic_coefs(rng, S, B):
    coefs = rng.integers(-200, 200, (S, B, 64)).astype(np.int16)
    coefs = np.where(rng.random((S, B, 64)) < 0.85, 0, coefs)
    coefs[3, 2] = 0                                  # all-zero block
    coefs[5, 7] = rng.integers(-1000, 1000, 64)      # dense block
    coefs[6, 1, 1:] = 0
    coefs[6, 1, 40] = 3                              # run of 38: 2 ZRL
    coefs[7, 0, 1:] = 0
    coefs[7, 0, 63] = -1                             # nonzero in slot 63
    return coefs


def _jax_dct_coefs(luma, S, B, nblocks):
    """The JAX package's own quantized coefficients of a 24x248 plane (3
    block rows of 31 blocks), in segments of B blocks, zero-padded."""
    plane = _frame(24, 248, seed=9)[..., 0]
    assert (24 // 8) * (248 // 8) == nblocks
    blocks = np.asarray(jdct.fdct_quantize(jnp.asarray(plane),
                                           jt.quant_table_zz(luma, 75)))
    coefs = np.zeros((S * B, 64), np.int16)
    coefs[:nblocks] = blocks
    return coefs.reshape(S, B, 64)


@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("source", ["synthetic", "jax_dct", "edge"])
def test_huffman_plain_matches_coefficient_megakernel(rng, source, luma):
    S, B, nblocks = 12, 8, 12 * 8 - 3               # short last segment
    if source == "jax_dct":
        coefs = _jax_dct_coefs(luma, S, B, nblocks)
    else:
        # edge: the card tests' edge blocks (ZRL runs of 15 to 48, runs
        # that end at 63, DC steps of size 11, all-ones value bits, rows
        # at their longest coding)
        coefs = (_edge_blocks(rng, S * B).reshape(S, B, 64)
                 if source == "edge" else _synthetic_coefs(rng, S, B))
        coefs.reshape(-1, 64)[nblocks:] = 0
    valid = (np.arange(S * B).reshape(S, B) < nblocks).astype(np.int32)
    rstm = np.asarray([0xD0 + (s % 8) for s in range(S - 1)] + [0],
                      np.uint32)
    r, ob, needs = jfp.entropy_fused(
        jnp.asarray(coefs.reshape(S, B * 64).T), jnp.asarray(valid.T),
        jnp.asarray(np.full((1, S), int(luma), np.int32)), rstm,
        128 if source == "edge" else 64, 1024, jt.entropy_kernel_consts(75),
        interpret=True)
    tabs = tfp.class_tables(75, luma, "cpu")
    rows, rb, t_needs = tfp.huffman_segments(
        torch.from_numpy(coefs.reshape(S, B * 64)), nblocks, tabs)
    assert rows.shape == (S, tfp.row_stride(B, tabs))
    _assert_rows_equal(rows.numpy(), rb.numpy(), _rows_bytes(r),
                       np.asarray(ob))
    assert np.array_equal(t_needs.numpy(), np.asarray(needs)[-2:])


def _pack_reference(bits, lens, marker):
    """Sequential bit writer (the restart_interval == 0 packer of
    gpujpeg_tpu.native.pack_tokens, plus the marker)."""
    acc, nb, out = 0, 0, bytearray()
    for b, n in zip(bits, lens):
        if n <= 0:
            continue
        acc = (acc << n) | (b & ((1 << n) - 1))
        nb += n
        while nb >= 8:
            byte = (acc >> (nb - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nb -= 8
        acc &= (1 << nb) - 1
    if nb:
        byte = ((acc << (8 - nb)) | ((1 << (8 - nb)) - 1)) & 0xFF
        out.append(byte)
        if byte == 0xFF:
            out.append(0)
    if marker:
        out += bytes((0xFF, marker))
    return bytes(out)


def test_pack_rows_matches_sequential_writer(rng):
    R, T = 9, 300
    lens = rng.integers(1, 28, (R, T))
    lens = np.where(rng.random((R, T)) < 0.5, 0, lens)
    lens[2] = 0                                      # empty row
    bits = rng.integers(0, 1 << 27, (R, T)) & ((1 << lens) - 1)
    bits[4, :40] = (1 << lens[4, :40]) - 1           # runs of 1-bits: 0xFF
    markers = np.asarray([0xD0 + i for i in range(R - 1)] + [0])
    rows, rb, nff = tfp.pack_rows(torch.from_numpy(bits),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(markers), 2048)
    for r in range(R):
        ref = _pack_reference(bits[r].tolist(), lens[r].tolist(),
                              int(markers[r]))
        assert rb[r] == len(ref)
        assert rows[r, :len(ref)].numpy().tobytes() == ref
        assert not rows[r, len(ref):].any()
    assert nff[4] > 0
