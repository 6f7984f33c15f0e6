"""PyTorch port, token-row packer (pack_stuff_rows): the plain version
against the JAX package's Pallas deep-stuff kernel in interpret mode,
through both of its entry points (pack_stuff_fused on raw tokens,
pack_stuff_fused_pre on the tokenizer's pre-merged pairs).  The CUDA kernel
is held against the plain version in test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpujpeg_tpu.ops import fusedpack as jfp

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import fusedpack as tfp
from tests import torch_threads  # noqa: F401


def _tokens(rng, R, T, max_len=27, density=0.5, ff_bias=False):
    """Random token rows (template: tests/test_fusedpack.py): right-aligned
    bits, lengths 0..max_len; ff_bias makes all-ones tokens, which pack
    into runs of 0xFF bytes."""
    lens = rng.integers(0, max_len + 1, size=(R, T)).astype(np.int32)
    lens = np.where(rng.random((R, T)) < density, lens, 0)
    if ff_bias:
        bits = ((1 << lens) - 1).astype(np.uint32)
    else:
        bits = (rng.integers(0, 1 << 31, size=(R, T))
                & ((1 << lens) - 1)).astype(np.uint32)
    return bits, lens


def _markers(R, every=3):
    """RST markers after most rows, none after every third."""
    r = np.arange(R)
    return np.where(r % every != every - 1, 0xD0 + r % 8, 0).astype(np.int32)


def _jax_bytes(rows_u32, nbytes):
    by = np.ascontiguousarray(np.asarray(rows_u32).astype(">u4")).view(
        np.uint8).reshape(rows_u32.shape[0], -1)
    return [by[i, :int(nbytes[i])].tobytes() for i in range(len(nbytes))]


def _port(bits, lens, markers, stride=None):
    stride = stride or -(-(2 * lens.sum(axis=1).max() // 8 + 8) // 16) * 16
    rows, rb, needs = tfp.pack_stuff_rows(
        torch.from_numpy(bits.view(np.int32)), torch.from_numpy(lens),
        torch.from_numpy(markers), int(stride))
    rows, rb = rows.numpy(), rb.numpy()
    return [rows[i, :rb[i]].tobytes() for i in range(len(rb))], rb, needs


@pytest.mark.parametrize("T,density,max_len,ff_bias", [
    (64, 0.5, 27, False), (128, 0.3, 14, False), (384, 0.4, 20, False),
    (64, 0.8, 20, True)])
def test_pack_plain_matches_deep_stuff_kernel(rng, T, density, max_len,
                                              ff_bias):
    R = 9
    bits, lens = _tokens(rng, R, T, max_len, density, ff_bias)
    markers = _markers(R)
    got, rb, needs = _port(bits, lens, markers)
    w_out = int(rb.max()) // 4 + 4
    r, ob, jneeds = jfp.pack_stuff_fused(
        jnp.asarray(bits), jnp.asarray(lens), markers.astype(np.uint32),
        l0=0, z_cap=128, w_out=w_out, interpret=True)
    ob, jneeds = np.asarray(ob), np.asarray(jneeds)
    assert jfp.needs_ok(jneeds, 0, 128, w_out)
    assert np.array_equal(rb, ob)
    assert got == _jax_bytes(r, ob)
    # needs keeps the last two entries of the JAX vector
    assert np.array_equal(needs.numpy(), jneeds[-2:])
    if ff_bias:
        assert int(needs[0]) > 10


@pytest.mark.parametrize("T,density,max_len", [(64, 0.4, 12),
                                                (96, 0.25, 10)])
def test_pack_plain_matches_deep_stuff_kernel_premerged(rng, T, density,
                                                        max_len):
    """pack_stuff_fused_pre takes the tokenizer's level-1 pairs (pairs
    mode, dropped by the port: it is a TPU pre-merge that changes no
    byte); the port packs the same tokens unmerged to the same bytes."""
    R = 9
    bits, lens = _tokens(rng, R, T, max_len, density)
    markers = _markers(R, every=2)
    l32 = lens.astype(np.int64)
    x = np.where(l32 > 0, (bits.astype(np.uint64)
                           << (32 - np.clip(l32, 1, 31)).astype(np.uint64))
                 & np.uint64(0xFFFFFFFF), 0).astype(np.uint32)
    merged = x[:, 0::2] | (x[:, 1::2] >> np.clip(
        l32[:, 0::2], 0, 31).astype(np.uint32))
    mlen = (lens[:, 0::2] + lens[:, 1::2]).astype(np.int32)
    assert mlen.max() <= 32, "test content must fit level-1 pairs"
    got, rb, needs = _port(bits, lens, markers)
    w_out = int(rb.max()) // 4 + 4
    r, ob, jneeds = jfp.pack_stuff_fused_pre(
        jnp.asarray(merged), jnp.asarray(mlen), markers.astype(np.uint32),
        z_cap=64, w_out=w_out, interpret=True)
    assert np.array_equal(rb, np.asarray(ob))
    assert got == _jax_bytes(r, np.asarray(ob))
    assert np.array_equal(needs.numpy(), np.asarray(jneeds)[-2:])


def test_pack_ignores_bits_above_length(rng):
    """Bits above a token's length are ignored, as the kernel masks them."""
    bits, lens = _tokens(rng, 6, 64)
    markers = _markers(6)
    noisy = bits | (rng.integers(0, 1 << 31, bits.shape).astype(np.uint32)
                    << np.minimum(lens, 31).astype(np.uint32)) * (lens < 31)
    assert _port(bits, lens, markers)[0] == _port(noisy, lens, markers)[0]


@pytest.mark.parametrize("samp", [((2, 2), (1, 1), (1, 1)),
                                  ((2, 1), (1, 1), (1, 1))])
@pytest.mark.parametrize("quality,rst", [(75, gt.RESTART_AUTO), (100, 4)])
def test_interleaved_stride_is_a_worst_case(samp, quality, rst):
    """The stride of an interleaved row takes each block slot's class: a
    noise frame's rows fit it, and it lies between the strides of rows of
    one class."""
    enc = gt.Encoder(device="cpu")
    frame = np.random.default_rng(8).integers(0, 256, (64, 96, 3),
                                              dtype=np.uint8)
    p = gt.Parameters(quality=quality, restart_interval=rst,
                      interleaved=True).chroma_subsampled(samp)
    geo = enc.resolve(frame, p)
    bpm, rstm = geo.blocks_per_mcu, geo.segment_mcu_count
    stride = tfp.interleaved_slots(geo, enc.classes(quality)).stride(
        bpm * rstm)
    _, res, _meta = enc.encode_to_device(frame, p)
    assert res["rows"][0].shape[1] == stride
    assert int(res["row_bytes"][0].max()) <= stride
    luma = enc.class_tables(quality, True)
    chroma = enc.class_tables(quality, False)
    assert stride == tfp.pack_stride(([luma] * (bpm - 2) + [chroma] * 2)
                                     * rstm)
    one = sorted(tfp.row_stride(bpm * rstm, t) for t in (luma, chroma))
    assert one[0] <= stride <= one[1]
    assert tfp.row_stride(8, luma) == tfp.pack_stride([luma] * 8)
