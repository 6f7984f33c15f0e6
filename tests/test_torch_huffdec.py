"""PyTorch port, Huffman decode phases A and C: the plain versions against
the JAX package's Pallas kernels in interpret mode and its XLA phase A
(the CUDA kernels are held against the plain versions in
test_torch_kernels.py).  Both sides decode the same unstuffed word matrix;
bstart, coefficients and error flags must be identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpujpeg_tpu as gj
from gpujpeg_tpu.models import decoder as jdec
from gpujpeg_tpu.ops import huffdec_kernel as jhk
from gpujpeg_tpu.stream import reader as jreader
from gpujpeg_tpu.utils import tables as jt
from gpujpeg_tpu.utils.geometry import get_geometry as jget_geometry

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from gpujpeg_tpu_torch.utils import tables as tt


def _gradient(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  ((xx + yy) * 255 // (w + h))], -1)
    return np.clip(f + rng.integers(-12, 12, f.shape), 0, 255) \
        .astype(np.uint8)


def _encode(frame, quality, rst):
    """The port's encoder writes the JAX package's bytes
    (test_torch_encode.py) and builds no XLA programs."""
    return gt.Encoder(device="cpu").encode(frame, gt.Parameters(
        quality=quality, restart_interval=rst))


STREAMS = {
    # dense coefficients, 4 blocks a segment
    "noise_q75_rst4": lambda: _encode(np.random.default_rng(3).integers(
        0, 256, (64, 80, 3), dtype=np.uint8), 75, 4),
    # auto interval (8 blocks a segment), ragged last segments
    "gradient_48x64_auto": lambda: _encode(_gradient(48, 64, 4), 75, -1),
    # auto interval at Q98 picks one block a segment
    "gradient_q98_bps1": lambda: _encode(_gradient(40, 48, 5), 98, -1),
}


def _corrupt(data):
    """The stream with one byte of its middle segment damaged (template:
    tests/test_dec_kernel.py): the first byte, counted from the segment's
    second, whose damage phase A detects (many flips only change value
    bits, or resynchronise).  Bytes next to 0xFF are skipped so that the
    damage stays inside the segment."""
    segs = jreader.parse(data).scans[0].segments
    start, end = (int(x) for x in segs[len(segs) // 2])
    for pos in range(start + 1, end):
        bad = bytearray(data)
        if 0xFF in (bad[pos - 1], bad[pos], bad[pos] ^ 0x5A):
            continue
        bad[pos] ^= 0x5A
        hf = gt.Decoder(device="cpu").prepare(bytes(bad))
        p = hf.plan
        _bs, err = thd.scan_segments(
            torch.from_numpy(hf.words), torch.from_numpy(hf.nbits),
            p.nblocks, p.dc_luma, p.ac_luma, p.tables, p.bps)
        if err.any():
            return bytes(bad)
    raise AssertionError("no detectable single-byte damage")


class _Both:
    """One stream prepared by both packages from the same word matrix."""

    def __init__(self, data):
        self.hf = gt.Decoder(device="cpu").prepare(data)
        p = self.hf.plan
        self.bps = p.bps
        self.words = torch.from_numpy(self.hf.words)
        self.nbits = torch.from_numpy(self.hf.nbits)
        self.targs = (p.nblocks, p.dc_luma, p.ac_luma, p.tables)
        ps = jreader.parse(data)
        geo = jget_geometry(jreader.parsed_to_parameters(ps),
                            jdec.resolve_output(ps, None, 0)
                            .with_(width_padding=0))
        self.jdec = gj.Decoder()
        self.jplan = self.jdec._plan_for(geo, ps)
        assert self.jplan.kernel_consts is not None
        assert self.jplan.bps == self.bps
        # the JAX kernels take big-endian words
        self.jwords = jnp.asarray(self.hf.words.view(np.uint32).byteswap())
        nseg = self.words.shape[0]
        self.jrows = (
            jnp.asarray(self.hf.nbits),
            jnp.asarray(p.nblocks.numpy()),
            jnp.asarray(self.jplan.dc_luma_row.astype(np.int32)),
            jnp.asarray(self.jplan.ac_luma_row.astype(np.int32)))
        assert np.array_equal(self.jplan.blk_valid.reshape(nseg, self.bps)
                              .sum(axis=1), p.nblocks.numpy())
        assert np.array_equal(self.jplan.dc_luma_row,
                              p.dc_luma.numpy() != 0)
        assert np.array_equal(self.jplan.ac_luma_row,
                              p.ac_luma.numpy() != 0)

    def port_scan(self):
        return thd.scan_segments(self.words, self.nbits, *self.targs,
                                 self.bps)

    def block_rows(self):
        bi = lambda a: jnp.asarray(a.astype(np.int32))[None, :]
        return (bi(self.jplan.blk_dc_luma), bi(self.jplan.blk_ac_luma),
                bi(self.jplan.blk_valid))


_CACHE = {}


def _both(name, corrupt=False):
    key = (name, corrupt)
    if key not in _CACHE:
        data = STREAMS[name]()
        _CACHE[key] = _Both(_corrupt(data) if corrupt else data)
    return _CACHE[key]


@pytest.mark.parametrize("quality", [75, 90, 100])
def test_token_decode_matches_affine(quality):
    """The kernels' canonical-table decode gives the JAX package's
    arithmetic (clen, sym) on every 16-bit peek of the tuned tables, and
    clen 0 on exactly the same invalid codes."""
    peek = np.arange(1 << 16, dtype=np.int64)
    for luma in (True, False):
        bits, vals = tt.ac_spec(luma, quality)
        acl = jt.affine_ac_decode_runtime(*jt.match_affine_ac(bits, vals))
        jclen, jsym = jhk.affine_ac_decode(jnp.asarray(peek, jnp.int32),
                                           luma, acl, acl)
        dbits, dvals = tt.huffman_spec_for("dc", luma)
        mono, roff = jhk.dc_decode_runtime(dbits, dvals)
        dclen, dsym = jhk.dc_identity_decode(
            jnp.asarray(peek, jnp.int32), luma, mono, mono, roff, roff)
        tab = torch.from_numpy(thd.decode_tables(
            (dbits, dvals), (dbits, dvals), (bits, vals), (bits, vals))
        ).to(torch.int64)
        p = torch.from_numpy(peek)
        for t, jc, js in ((2, jclen, jsym), (0, dclen, dsym)):
            clen, sym = thd._decode_token(
                tab, torch.full_like(p, t), p)
            jc, js = np.asarray(jc), np.asarray(js)
            assert np.array_equal(clen.numpy(), jc)
            ok = jc > 0
            assert np.array_equal(sym.numpy()[ok], js[ok])


@pytest.mark.parametrize("name", list(STREAMS))
def test_scan_plain_matches_jax(name):
    """Phase A: bstart and err equal the Pallas kernel (interpret) and
    the XLA scan (huffdec2.make_scan_fn, whose step cap must not bind)."""
    b = _both(name)
    bstart, err = b.port_scan()
    W = b.words.shape[1]
    kfn = b.jplan.kernel_scan_fn(W, b.words.shape[0], True)
    jb, je = kfn(b.jwords, *b.jrows)
    assert np.array_equal(bstart.numpy(), np.asarray(jb))
    assert np.array_equal(err.numpy(), np.asarray(je))
    xb, xe = b.jplan.scan_fn(b.jwords, b.jrows[0], b.jrows[1],
                             jnp.asarray(b.jplan.dc_luma_row),
                             jnp.asarray(b.jplan.ac_luma_row))
    assert np.array_equal(bstart.numpy(), np.asarray(xb))
    assert np.array_equal(err.numpy(), np.asarray(xe))
    assert not err.any()


@pytest.mark.parametrize("name,corrupt", [
    (name, False) for name in STREAMS] + [
    ("noise_q75_rst4", True), ("gradient_q98_bps1", True)])
def test_block_plain_matches_segrow_kernel(name, corrupt):
    """Phase C: coefficients and err equal the Pallas block kernel in its
    segment-row mode (with_cursor=True, interpret), on the same bstart."""
    b = _both(name, corrupt)
    bstart, err_a = b.port_scan()
    coefs, err = thd.decode_blocks(b.words, bstart, *b.targs)
    nseg, W = b.words.shape
    L = nseg * b.bps
    fn = b.jplan.kernel_segrow_fn(W, True)
    bufs_t = jnp.broadcast_to(b.jwords[:, None, :], (nseg, b.bps, W)) \
        .reshape(L, W).T
    jbs = jnp.asarray(bstart.numpy())
    jc, je = fn(bufs_t, jbs[:, 1:].reshape(1, L), jbs[:, :-1].reshape(1, L),
                *b.block_rows())
    assert np.array_equal(coefs.numpy(), np.asarray(jc))
    assert np.array_equal(err.numpy(), np.asarray(je).reshape(-1))
    if corrupt:
        assert err_a.any()
    else:
        assert not err.any()


@pytest.mark.parametrize("name", ["noise_q75_rst4", "gradient_48x64_auto"])
def test_block_plain_matches_split_kernel(name):
    """Phase C: the segment-row contract gives the coefficients of the JAX
    package's default split path (phase B buffers, Pallas block kernel
    in interpret mode)."""
    from gpujpeg_tpu.ops import huffdec2

    b = _both(name)
    bstart, _ = b.port_scan()
    coefs, err = thd.decode_blocks(b.words, bstart, *b.targs)
    jbs = jnp.asarray(bstart.numpy())
    needs = np.asarray(huffdec2.split_needs(jbs, b.bps))
    caps = tuple(int(n) + 1 for n in needs)
    L = b.words.shape[0] * b.bps
    bufs = b.jdec._split_fn(b.bps, caps)(b.jwords, jbs).reshape(L, -1)
    blen = (jbs[:, 1:] - jbs[:, :-1]).reshape(1, L)
    fn = b.jplan.kernel_block_fn(int(bufs.shape[1]), True)
    jc, je = fn(bufs.T, blen, *b.block_rows())
    assert np.array_equal(coefs.numpy(), np.asarray(jc))
    assert np.array_equal(err.numpy(), np.asarray(je).reshape(-1))


def test_corrupt_stream_flags_match_jax():
    """On the damaged stream phase A flags the same segments in both
    packages, and only blocks of flagged segments can differ from the
    undamaged decode."""
    good, bad = _both("noise_q75_rst4"), _both("noise_q75_rst4", True)
    gb, _ = good.port_scan()
    bb, be = bad.port_scan()
    kfn = bad.jplan.kernel_scan_fn(bad.words.shape[1], bad.words.shape[0],
                                   True)
    _jb, je = kfn(bad.jwords, *bad.jrows)
    assert np.array_equal(be.numpy(), np.asarray(je))
    gc, _ = thd.decode_blocks(good.words, gb, *good.targs)
    bc, bce = thd.decode_blocks(bad.words, bb, *bad.targs)
    seg_bad = be.numpy() | (bce.numpy().reshape(-1, bad.bps) != 0).any(1)
    diff = (gc.numpy() != bc.numpy()).any(0).reshape(-1, bad.bps).any(1)
    assert seg_bad.any()
    assert not (diff & ~seg_bad).any()
