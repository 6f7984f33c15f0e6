"""PyTorch port, decode of interleaved scans: Decoder(device="cpu") returns
the JAX package's pixels and coefficients on interleaved 4:2:0, 4:2:2 and
4:4:0 streams (written by the port's encoder, which writes the JAX
package's bytes: test_torch_interleaved_encode*.py); the plain Huffman
phases in slot-pattern mode equal the JAX package's Pallas kernels in
interpret mode; a corrupt segment is contained.  Interleaved 4:4:4
streams written by the JAX encoder and the refusals are in
test_torch_interleaved_decode_jax.py (on the card:
test_torch_kernels.py)."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpujpeg_tpu as gj
from gpujpeg_tpu.models import decoder as jdec
from gpujpeg_tpu.ops import huffdec2
from gpujpeg_tpu.stream import reader as jreader
from gpujpeg_tpu.utils.geometry import get_geometry as jget_geometry

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models import decoder as tdec
from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

from .test_torch_encode import _gradient
from tests import torch_threads  # noqa: F401

SAMP = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
        "440": ((1, 2), (1, 1), (1, 1)), "444": ((1, 1), (1, 1), (1, 1))}


def _params(mod, samp, quality=75, rst=-1):
    return mod.Parameters(quality=quality, restart_interval=rst,
                          interleaved=True).chroma_subsampled(SAMP[samp])


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _port(frame, samp, quality=75, rst=-1):
    return gt.Encoder(device="cpu").encode(frame, _params(gt, samp, quality,
                                                          rst))


STREAMS = {
    "420_320x240": lambda: _port(_gradient(240, 320, 0), "420"),
    # Q90, 2 MCUs a segment
    "420_311x233_q90_rst2": lambda: _port(_gradient(233, 311, 1), "420", 90,
                                          2),
    "422_noise_64x64": lambda: _port(_noise(64, 64, 2), "422"),
    # 27 MCUs in segments of 2: a ragged last segment
    "440_67x41_q90_rst2": lambda: _port(_gradient(41, 67, 3), "440", 90, 2),
}

#: one JAX session for the module, as a server would keep one
_JDEC = gj.Decoder()


def check_decode(data):
    """Pixels and quantized coefficients equal the JAX package's."""
    assert jreader.parse(data).interleaved
    ref = np.asarray(_JDEC.decode(data))
    dec = gt.Decoder(device="cpu")
    got = dec.decode(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    ref_c = _JDEC.decode_coefficients(data)
    got_c = dec.decode_coefficients(data)
    assert len(got_c) == len(ref_c) == 3
    for a, b in zip(got_c, ref_c):
        assert a.dtype == np.int16 and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(STREAMS))
def test_interleaved_decode_matches_jax(name):
    check_decode(STREAMS[name]())


class _Both:
    """One small interleaved 4:2:0 stream prepared by both packages from
    the same word matrix: 4 x 6 MCUs in 12 segments of 2 MCUs (12 block
    slots: Y Y Y Y Cb Cr Y Y Y Y Cb Cr)."""

    def __init__(self, data):
        self.hf = gt.Decoder(device="cpu").prepare(data)
        p = self.p = self.hf.plan
        self.words = torch.from_numpy(self.hf.words)
        self.nbits = torch.from_numpy(self.hf.nbits)
        self.targs = (p.nblocks, p.dc_luma, p.ac_luma, p.tables)
        ps = jreader.parse(data)
        self.geo = jget_geometry(jreader.parsed_to_parameters(ps),
                                 jdec.resolve_output(ps, None, 0)
                                 .with_(width_padding=0))
        self.jdec = gj.Decoder()
        self.jplan = self.jdec._plan_for(self.geo, ps)
        assert self.jplan.kernel_consts is not None
        dc_pat, ac_pat, bpm = self.jplan.luma_patterns
        assert p.pattern == (bpm, sum(int(b) << j for j, b in
                                      enumerate(dc_pat)),
                             sum(int(b) << j for j, b in enumerate(ac_pat)))
        assert p.bps == self.jplan.bps
        self.jwords = jnp.asarray(self.hf.words.view(np.uint32).byteswap())
        self.jrows = (jnp.asarray(self.hf.nbits),
                      jnp.asarray(p.nblocks.numpy()),
                      jnp.asarray(self.jplan.dc_luma_row.astype(np.int32)),
                      jnp.asarray(self.jplan.ac_luma_row.astype(np.int32)))
        assert np.array_equal(
            self.jplan.blk_valid.reshape(-1, p.bps).sum(axis=1),
            p.nblocks.numpy())

    def scan(self):
        return thd.scan_segments(self.words, self.nbits, *self.targs,
                                 self.p.bps, self.p.pattern)

    def blocks(self, bstart):
        return thd.decode_blocks(self.words, bstart, *self.targs,
                                 self.p.pattern)


def _small():
    """Rows narrow enough for the JAX kernels' word windows (W <= 72)."""
    return _port(_gradient(64, 96, 6), "420", 75, 2)


def _corrupt(data):
    """The stream with one byte of its middle segment damaged such that
    phase A flags it (template: tests/test_torch_huffdec.py)."""
    segs = jreader.parse(data).scans[0].segments
    start, end = (int(x) for x in segs[len(segs) // 2])
    for pos in range(start + 1, end):
        bad = bytearray(data)
        if 0xFF in (bad[pos - 1], bad[pos], bad[pos] ^ 0x5A):
            continue
        bad[pos] ^= 0x5A
        if _Both(bytes(bad)).scan()[1].any():
            return bytes(bad)
    raise AssertionError("no detectable single-byte damage")


def test_pattern_phases_match_jax_kernels():
    """Phase A in pattern mode equals the JAX scan kernel with luma
    patterns (interpret); phase C equals its segment-row block kernel with
    per-block class rows, and, after the per-component DC integration,
    its interleaved split path (_il_block_tail: one class-specialized
    block kernel call per component, _dc_fixup_t_flat)."""
    b = _Both(_small())
    bstart, err_a = b.scan()
    W = b.words.shape[1]
    kfn = b.jplan.kernel_scan_fn(W, b.words.shape[0], True)
    jb, je = kfn(b.jwords, *b.jrows)
    assert np.array_equal(bstart.numpy(), np.asarray(jb))
    assert np.array_equal(err_a.numpy(), np.asarray(je))
    assert not err_a.any()
    coefs, err_c = b.blocks(bstart)
    nseg, bps = b.words.shape[0], b.p.bps
    L = nseg * bps
    fn = b.jplan.kernel_segrow_fn(W, True)
    bufs_t = jnp.broadcast_to(b.jwords[:, None, :], (nseg, bps, W)) \
        .reshape(L, W).T
    jbs = jnp.asarray(bstart.numpy())
    rows = [jnp.asarray(a.astype(np.int32))[None, :] for a in (
        b.jplan.blk_dc_luma, b.jplan.blk_ac_luma, b.jplan.blk_valid)]
    jc, jerr = fn(bufs_t, jbs[:, 1:].reshape(1, L),
                  jbs[:, :-1].reshape(1, L), *rows)
    assert np.array_equal(coefs.numpy(), np.asarray(jc))
    assert np.array_equal(err_c.numpy(), np.asarray(jerr).reshape(-1))
    # the split path, per component, DC integrated
    caps = tuple(int(n) + 1 for n in np.asarray(huffdec2.split_needs(
        jbs, bps)))
    bufs = b.jdec._split_fn(bps, caps)(b.jwords, jbs).reshape(L, -1)
    blen = (jbs[:, 1:] - jbs[:, :-1]).reshape(L)
    cts, _errs = jdec._il_block_tail(b.jplan, b.geo, bufs, blen, "interpret")
    fixed = tdec._dc_fixup_t(coefs.clone(), nseg, bps, b.p.comp_slots)
    rst, bpm = b.geo.segment_mcu_count, b.geo.blocks_per_mcu
    by_slot = fixed.reshape(64, nseg, rst, bpm)
    for (off, n), ct in zip(jdec._il_comp_slots(b.geo), cts):
        mine = by_slot[:, :, :, off:off + n].reshape(64, -1)
        assert np.array_equal(mine.numpy(), np.asarray(ct))


def test_chroma_dc_integrates_per_component():
    """Each component's DC sums over its own slots of the row: in a
    segment of 2 MCUs the second MCU's Cb DC is the first's plus its
    difference, untouched by the Y and Cr slots between them."""
    dc = torch.tensor([[1, 2, 3, 4, 50, 70, 1, 1, 1, 1, -5, 6]],
                      dtype=torch.int16)
    coefs = torch.zeros((64, 12), dtype=torch.int16)
    coefs[0] = dc[0]
    slots = torch.tensor([0, 0, 0, 0, 1, 2] * 2)
    comp = tuple(torch.nonzero(slots == c).flatten() for c in range(3))
    out = tdec._dc_fixup_t(coefs, 1, 12, comp)[0].tolist()
    assert out == [1, 3, 6, 10, 50, 70, 11, 12, 13, 14, 45, 76]
    # two segments of one MCU: each row starts its own sums
    coefs = torch.zeros((64, 12), dtype=torch.int16)
    coefs[0] = dc[0]
    halves = tuple(torch.nonzero(slots[:6] == c).flatten() for c in range(3))
    out = tdec._dc_fixup_t(coefs, 2, 6, halves)[0].tolist()
    assert out == [1, 3, 6, 10, 50, 70, 1, 2, 3, 4, -5, 6]


def test_corrupt_segment_is_contained(caplog):
    """A damaged middle segment logs the warning; blocks of the segments
    phase A and C do not flag decode as before, the flags equal the JAX
    scan kernel's, and the pixels equal the JAX package's decode."""
    good_data = _small()
    bad_data = _corrupt(good_data)
    good, bad = _Both(good_data), _Both(bad_data)
    gb, _ = good.scan()
    bb, be = bad.scan()
    kfn = bad.jplan.kernel_scan_fn(bad.words.shape[1], bad.words.shape[0],
                                   True)
    _jb, je = kfn(bad.jwords, *bad.jrows)
    assert np.array_equal(be.numpy(), np.asarray(je))
    gc, _ = good.blocks(gb)
    bc, bce = bad.blocks(bb)
    seg_bad = be.numpy() | (bce.numpy().reshape(-1, bad.p.bps) != 0).any(1)
    diff = (gc.numpy() != bc.numpy()).any(0).reshape(-1, bad.p.bps).any(1)
    assert seg_bad.any() and not (diff & ~seg_bad).any()
    with caplog.at_level(logging.WARNING, logger="gpujpeg_tpu_torch"):
        out = gt.Decoder(device="cpu").decode(bad_data)
    assert any("corrupt segment" in r.message for r in caplog.records)
    assert np.array_equal(out, np.asarray(_JDEC.decode(bad_data)))
