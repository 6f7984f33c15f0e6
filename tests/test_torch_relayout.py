"""PyTorch port, the relayout kernels' plain versions against the JAX
package's TPU probes and their checks, and the interleaved feed order.

- ops/relayout.xbd_relayout_plain against tools/proto_xbdkernel.py's
  Pallas relayout (make_fn, interpret mode) and its XLA chain
  (xla_relayout); the script is loaded by path, as tools/ is no package;
- transpose_u32, pair_sum_rows and pack_u8_quads against the numpy
  references that tools/profile_transpose.py and tools/profile_prims.py
  check their kernels with (the kernels are closures of those scripts'
  main());
- fusedpack.interleaved_rows_plain (the plain version of the MCU-order
  DCT store) against the JAX package's interleaved feeds: the xbd feed of
  its interleaved megakernel at 4:4:4 (make_rows_xbd_il_impl) and its
  token rows at 4:2:0 (make_rows_tokens_impl).

The CUDA kernels are held against these plain versions on the card
(test_torch_kernels.py).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gpujpeg_tpu as gj
from gpujpeg_tpu.models import encoder as jenc

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import dct as tdct
from gpujpeg_tpu_torch.ops import fusedpack as tfp
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre
from gpujpeg_tpu_torch.ops import relayout as trel

from .test_torch_encode import _gradient
from tests import torch_threads  # noqa: F401

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _u32(rng, shape, high=1 << 32):
    return rng.integers(0, high, shape, dtype=np.int64).astype(np.uint32)


def _t(a):
    """A u32 (or int32) numpy array as the int32 tensor the port takes."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(x):
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("nbh", [16, 20])
def test_xbd_relayout_matches_tpu_probe(nbh):
    """The probe's own geometry (8K rows of W/4 = 1920 words, rst 8, 120
    segments a block row), nbh block rows; 20 pads the Pallas grid to 32
    block rows, whose extra lanes are cut off as the script does."""
    tool = _tool("proto_xbdkernel")
    gbr = 128 // int(np.gcd(tool.NSR, 128))            # 16
    nbh_pad = -(-nbh // gbr) * gbr
    p32 = _u32(np.random.default_rng(nbh), (nbh * 8, tool.W // 4))
    padded = np.zeros((nbh_pad * 8, tool.W // 4), np.uint32)
    padded[:nbh * 8] = p32
    pallas = np.asarray(jax.jit(tool.make_fn(gbr, nbh_pad, interpret=True))(
        jnp.asarray(padded)))[:, :nbh * tool.NSR]
    xla = np.asarray(tool.xla_relayout(jnp.asarray(p32), nbh))
    got = trel.xbd_relayout(_t(p32), tool.RSTN)
    assert got.shape == (tool.RSTN * 16, nbh * tool.NSR)
    assert np.array_equal(_np(got), xla)
    assert np.array_equal(_np(got), pallas)


@pytest.mark.parametrize("shape", [(256, 128), (33, 47), (128, 7680)])
def test_transpose_matches_probe_reference(shape):
    """tools/profile_transpose.py:108 and tools/profile_prims.py:89 hold
    their transposes to numpy's .T."""
    a = _u32(np.random.default_rng(shape[1]), shape)
    assert np.array_equal(_np(trel.transpose_u32(_t(a))), a.T)


@pytest.mark.parametrize("shape", [(7680, 128), (6, 5)])
def test_pair_sum_matches_probe_reference(shape):
    """tools/profile_prims.py:119-120: a[0::2] + a[1::2] in u32, here with
    words over the whole range (wraparound)."""
    a = _u32(np.random.default_rng(shape[0]), shape)
    assert np.array_equal(_np(trel.pair_sum_rows(_t(a))), a[0::2] + a[1::2])


@pytest.mark.parametrize("shape", [(7680, 128), (8, 3)])
def test_pack_u8_quads_matches_probe_reference(shape):
    """tools/profile_prims.py:151-154 on int32 values 0..255, and the low
    bytes of any int32."""
    for high in (256, 1 << 32):
        x = _u32(np.random.default_rng(shape[1]), shape, high)
        a = x.astype(np.uint8)
        ref = (a[0::4].astype(np.uint32) | (a[1::4].astype(np.uint32) << 8)
               | (a[2::4].astype(np.uint32) << 16)
               | (a[3::4].astype(np.uint32) << 24))
        assert np.array_equal(_np(trel.pack_u8_quads(_t(x))), ref)


def _port_rows(frame, params):
    enc = gt.Encoder(device="cpu")
    geo = enc.resolve(frame, params)
    planes = tpre.preprocess_packed(torch.from_numpy(frame), geo,
                                    geo.param_image)
    classes = enc.classes(params.quality)
    return tfp.interleaved_rows_plain(planes, geo, classes), geo, classes


def test_mcu_order_matches_jax_xbd_feed_444(monkeypatch):
    """At 4:4:4 the JAX package feeds its interleaved megakernel the xbd
    layout of make_rows_xbd_il_impl: word h of pixel row r of MCU m's slot
    s at sublane (m * bpm + s) * 16 + r * 2 + h, one lane a segment.  The
    blocks in that order, through the port's DCT, are interleaved_rows_plain
    block for block."""
    monkeypatch.setenv("GPUJPEG_TPU_FUSED", "interpret")
    frame = _gradient(40, 48, 16)
    params = dict(quality=75, restart_interval=2, interleaved=True)
    geo = gj.Encoder().resolve(frame, gj.Parameters(**params), None)
    assert jenc.mega_il_supported(geo)
    xbd_fn, _info = jenc.make_rows_xbd_il_impl(geo)
    xbd = np.asarray(xbd_fn(jnp.asarray(frame)))
    rst, bpm, S = geo.segment_mcu_count, geo.blocks_per_mcu, \
        geo.segment_count
    samples = np.ascontiguousarray(xbd).view(np.uint8).reshape(
        rst, bpm, 8, 2, S, 4).transpose(4, 0, 1, 2, 3, 5).reshape(-1, 64)
    rows, tgeo, classes = _port_rows(frame, gt.Parameters(**params))
    got = rows.reshape(-1, bpm, 64)
    # the blocks side by side as one 8-row plane, raster order = feed order
    plane = torch.from_numpy(samples.reshape(-1, 8, 8).transpose(
        1, 0, 2).reshape(8, -1).copy())
    for slot, c in enumerate(tgeo.components):
        want = tdct.fdct_quantize(plane, classes[c.table_index].qtab)
        assert torch.equal(got[:, slot], want.reshape(-1, bpm, 64)[:, slot])


def test_mcu_order_matches_jax_token_feed_420():
    """At 4:2:0 the JAX package's interleaved feed is its token rows
    (make_rows_tokens_impl: each component's blocks transposed to (MCU,
    v, h), padded past the image, interleaved MCU by MCU).  The port's
    tokens of interleaved_rows_plain's rows are those token rows, pad MCUs
    included."""
    frame = _gradient(48, 64, 17)
    params = dict(quality=75, restart_interval=5,
                  interleaved=True)
    samp = ((2, 2), (1, 1), (1, 1))
    geo = gj.Encoder().resolve(
        frame, gj.Parameters(**params).chroma_subsampled(samp), None)
    assert geo.segment_count * geo.segment_mcu_count > geo.mcu_count
    jbits, jlens = jax.jit(jenc.make_rows_tokens_impl(geo))(
        jnp.asarray(frame))
    rows, tgeo, classes = _port_rows(
        frame, gt.Parameters(**params).chroma_subsampled(samp))
    st = tfp.interleaved_slots(tgeo, classes)
    R, B = rows.shape[0], rows.shape[1] // 64
    mcu = torch.arange(R * B).reshape(R, B) // st.bpm
    valid = mcu < tgeo.mcu_count
    cls = torch.tensor(st.slot_class).repeat(B // st.bpm).expand(R, B)
    bits, lens = tfp.segment_tokens(rows, st, valid, cls)
    assert np.array_equal(lens.numpy().astype(np.int64),
                          np.asarray(jlens).astype(np.int64))
    on = np.asarray(jlens) > 0
    assert np.array_equal(bits.numpy().astype(np.int64)[on],
                          np.asarray(jbits).astype(np.int64)[on])
