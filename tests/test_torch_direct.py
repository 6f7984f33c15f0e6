"""PyTorch port, the direct route of one block a restart segment (the JAX
decoder's _decode_direct): non-interleaved streams at restart interval 1
decode with phase C alone, each segment row a block's buffer from bit 0
to the segment's bit count, with no phase A and no DC fix-up.

The reference is the JAX package's direct route, which its CPU decode
takes only with GPUJPEG_TPU_DECKERNEL=interpret (its Pallas block kernel
in buffer mode, interpret mode; tests/test_dec_kernel.py does the same).
Pixels are held at tolerance 0 on Q97 at restart 1, Q100 at the auto
interval in planar 4:4:4, planar 4:2:0 and greyscale, and on corrupted
streams, with a corruption in a block's padding bits too (the case
where the direct bound, the segment's byte-aligned bit count, is
laxer than phase A's exact block ends).  CPU, frames up to 64x80."""

import logging

import numpy as np
import pytest
import torch

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models import decoder as tdec
from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from gpujpeg_tpu_torch.stream import reader as treader
from tests import scan_rows
from tests import torch_threads  # noqa: F401


def _gradient(h, w, seed, ch=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  ((xx + yy) * 255 // (w + h))], -1)[..., :ch]
    f = np.clip(f + rng.integers(-20, 21, f.shape), 0, 255).astype(np.uint8)
    return f[..., 0] if ch == 1 else f


def _encode(frame, quality, rst=gt.RESTART_AUTO, samp=None):
    p = gt.Parameters(quality=quality, restart_interval=rst)
    if samp is not None:
        p = p.chroma_subsampled(samp)
    return gt.Encoder(device="cpu").encode(frame, p)


def _segments(data):
    """[(start, end)] stream byte ranges of every segment, scan by scan."""
    return [tuple(int(x) for x in seg)
            for scan in treader.parse(data).scans for seg in scan.segments]


def _flip(data, pos, mask):
    bad = bytearray(data)
    bad[pos] ^= mask
    return bytes(bad)


#: one CPU session for the helpers' prepares: a session keeps its plans,
#: and a direct-route plan holds the direct instance's table
#: (huffdec_kernel.direct_lut, a decode of every 16-bit peek)
_DEC = gt.Decoder(device="cpu")


def _ends(data, s=None):
    """(end bit of each segment's block by phase A, its error, nbits), of
    every segment, or of segment s alone: phase A's plain version on its
    one row (the rows decode independently)."""
    hf = _DEC.prepare(data)
    p = hf.plan
    rows = slice(None) if s is None else slice(s, s + 1)
    words = torch.from_numpy(hf.words)[rows]
    nbits = torch.from_numpy(hf.nbits)[rows]
    bstart, err = thd.scan_segments_plain(
        words, nbits, p.nblocks[rows], p.dc_luma[rows], p.ac_luma[rows],
        p.tables, 1, p.pattern)
    return bstart[:, 1].numpy(), err.numpy(), hf.nbits[rows]


def _direct_err(data):
    """The direct route's error flag of each segment's block."""
    hf = _DEC.prepare(data)
    p = hf.plan
    return thd.decode_blocks_direct(
        torch.from_numpy(hf.words), torch.from_numpy(hf.nbits), p.nblocks,
        p.dc_luma, p.ac_luma, p.tables, p.pattern)[1].numpy()


def _padding_flip(data):
    """(segment, byte, mask) of one bit near the end of a segment's block
    whose flip leaves the block decoding with no error but ending inside
    the segment's 1-padding, past its true end: the corruption the
    direct route's byte-aligned bound cannot see.  A trial flip changes
    its segment's row alone, so phase A judges it on that row."""
    end0, err0, nbits = _ends(data)
    assert not err0.any()
    for s, (st, en) in enumerate(_segments(data)):
        if 0xFF in data[st:en] or end0[s] >= nbits[s]:
            continue                      # stuffed bytes, or no padding
        for k in range(1, 17):
            bit = int(end0[s]) - k
            if bit < 0:
                break
            pos, mask = st + bit // 8, 0x80 >> (bit % 8)
            if data[pos] ^ mask == 0xFF:
                continue
            end1, err1, _ = _ends(_flip(data, pos, mask), s)
            if not err1[0] and end1[0] > end0[s]:
                return s, pos, mask
    raise AssertionError("no flip lands in a block's padding bits")


def _corrupt(data):
    """The stream with two corruptions: the bytes of its middle segment
    overwritten with one repeated byte such that its block is in error
    (the containment case of tests/test_dec_kernel.py), and one bit
    flipped in
    the block of another segment such that it ends in its padding bits
    (_padding_flip).  Returns (stream, padding segment, middle
    segment)."""
    segs = _segments(data)
    mid = len(segs) // 2
    s, pos, mask = _padding_flip(data)
    assert s != mid
    flipped = _flip(data, pos, mask)
    st, en = segs[mid]
    for byte in (0xFE, 0x55, 0xAA):
        bad = flipped[:st] + bytes([byte]) * (en - st) + flipped[en:]
        if _direct_err(bad)[mid]:
            return bad, s, mid
    raise AssertionError("no pattern puts the middle block in error")


S444 = ((1, 1), (1, 1), (1, 1))
S420 = ((2, 2), (1, 1), (1, 1))


@pytest.fixture(scope="module")
def q97():
    rng = np.random.default_rng(97)
    return _encode(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), 97,
                   rst=1)


@pytest.fixture(scope="module")
def corrupt_case(q97):
    """_corrupt of the q97_rst1 stream, (stream, padding segment, middle
    segment): the search runs once a module."""
    return _corrupt(q97)


@pytest.fixture(scope="module")
def streams(q97, corrupt_case):
    return dict(
        q97_rst1=q97,
        q100_444=_encode(_gradient(48, 64, 1), 100),
        q100_420=_encode(_gradient(48, 64, 2), 100, samp=S420),
        q100_grey=_encode(_gradient(32, 48, 3, ch=1), 100),
        corrupt=corrupt_case[0],
    )


#: the 4:2:0 case decodes to planar 4:2:0 (STD in YCbCr): the JAX package
#: would otherwise take its Pallas dpost at dx = dy = 2, which costs three
#: times the direct route in interpret mode
REQUESTS = {"q100_420": ("YCBCR_BT601_256LVLS", "STD")}


def _request(mod, name):
    """The case's output request (mod: gj or gt), or None."""
    if name not in REQUESTS:
        return None
    cs, pf = REQUESTS[name]
    return mod.ImageParameters(width=0, height=0,
                               color_space=mod.ColorSpace[cs],
                               pixel_format=mod.types.PixelFormatRequest[pf])


@pytest.fixture(scope="module")
def jax_direct(streams):
    """Each stream's pixels through the JAX package's direct route."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GPUJPEG_TPU_DECKERNEL", "interpret")
        dec = gj.Decoder()
        return {name: np.asarray(dec.decode(data, _request(gj, name)))
                for name, data in streams.items()}


@pytest.fixture
def no_phase_a(monkeypatch):
    """Phase A and the DC fix-up raise if the decode reaches them."""
    def boom(*a, **k):
        raise AssertionError("the direct route ran phase A or the fix-up")

    monkeypatch.setattr(thd, "scan_segments", boom)
    monkeypatch.setattr(tdec, "dc_fixup", boom)


CASES = ["q97_rst1", "q100_444", "q100_420", "q100_grey", "corrupt"]


@pytest.mark.parametrize("name", CASES)
def test_direct_pixels_match_jax(streams, jax_direct, no_phase_a, name):
    """The port's decode and decode_to_device take the direct route (no
    phase A, no fix-up) and give the JAX direct route's pixels."""
    data, req = streams[name], _request(gt, name)
    dec = gt.Decoder(device="cpu")
    hf = dec.prepare(data, req)
    assert hf.plan.bps == 1 and hf.plan.direct
    got = dec.decode(data, req)
    assert got.shape == jax_direct[name].shape
    assert np.array_equal(got, jax_direct[name])
    assert np.array_equal(dec.decode_to_device(data, req).numpy(), got)


def test_q100_auto_interval_is_one_block(streams):
    """The auto restart interval at Q >= 97 gives one block a segment in
    every non-interleaved layout of the cases; an interleaved stream of
    one MCU a segment keeps phases A and C."""
    for name in ("q100_444", "q100_420", "q100_grey"):
        assert treader.parse(streams[name]).restart_interval == 1
    p = gt.Parameters(quality=100, restart_interval=1, interleaved=True)
    data = gt.Encoder(device="cpu").encode(_gradient(16, 16, 4), p)
    plan = gt.Decoder(device="cpu").prepare(data).plan
    assert plan.geo.interleaved and plan.bps == 3 and not plan.direct


def test_corruptions_of_the_corrupt_case(streams, corrupt_case, caplog):
    """The corrupt case differs from its clean stream in one padding-bit
    flip, whose block decodes with no error on the direct route (bounded
    by the byte-aligned segment length), and in the middle segment,
    whose block is in error and is logged as a warning; every other
    segment's block equals the clean stream's, and so do most pixel
    rows.  The pixels equal the JAX direct route's
    (test_direct_pixels_match_jax)."""
    clean = streams["q97_rst1"]
    bad, s_pad, mid = corrupt_case
    assert bad == streams["corrupt"]
    coefs, errs = [], []
    for data in (clean, bad):
        hf = gt.Decoder(device="cpu").prepare(data)
        p = hf.plan
        c, e = thd.decode_blocks_direct(
            torch.from_numpy(hf.words), torch.from_numpy(hf.nbits),
            p.nblocks, p.dc_luma, p.ac_luma, p.tables, p.pattern,
            p.block_lut)
        coefs.append(c)
        errs.append(e)
    assert not bool(errs[0].any())
    assert errs[1].nonzero()[:, 0].tolist() == [mid]
    differ = (coefs[0] != coefs[1]).any(0).nonzero()[:, 0].tolist()
    assert s_pad in differ and set(differ) <= {s_pad, mid}
    with caplog.at_level(logging.WARNING):
        out = gt.Decoder(device="cpu").decode(bad)
    assert "corrupt segment" in caplog.text
    ref = gt.Decoder(device="cpu").decode(clean)
    assert (out == ref).all(axis=(1, 2)).mean() > 0.5


def test_compile_stream_pipeline_direct(streams, jax_direct, no_phase_a):
    """compile_stream_pipeline's device function takes the direct route
    and gives the JAX direct route's pixels."""
    for name in ("q100_444", "q100_grey"):
        fn, words, nbits = gt.Decoder(device="cpu").compile_stream_pipeline(
            streams[name])
        assert np.array_equal(fn(words, nbits).numpy(), jax_direct[name])


def test_decode_pipelined_direct(streams, jax_direct, no_phase_a):
    """decode_pipelined over bps-1 streams of one geometry (a corrupt one
    in the middle) yields the JAX direct route's pixels."""
    names = ["q97_rst1", "corrupt", "q97_rst1"]
    got = list(gt.Decoder(device="cpu").decode_pipelined(
        [streams[n] for n in names]))
    assert len(got) == 3
    for n, g in zip(names, got):
        assert np.array_equal(g, jax_direct[n])


@pytest.mark.parametrize("name", ["q100_420"])
def test_decode_coefficients_keeps_phase_a(streams, monkeypatch, name):
    """decode_coefficients keeps phases A and C on a bps-1 stream, as the
    JAX method does, and equals its coefficients."""
    calls = []
    scan = thd.scan_segments

    def counted(*a, **k):
        calls.append(1)
        return scan(*a, **k)

    monkeypatch.setattr(thd, "scan_segments", counted)
    got = gt.Decoder(device="cpu").decode_coefficients(streams[name])
    assert calls
    want = gj.Decoder().decode_coefficients(streams[name])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.int16 and np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name", CASES)
def test_direct_equals_phase_a_route(streams, name):
    """The direct route's pixels equal the same session's phase-A+C
    coefficients (DC integrated) taken through the back half."""
    dec, req = gt.Decoder(device="cpu"), _request(gt, name)
    hf = dec.prepare(streams[name], req)
    coefs_t, _ea, _ec = dec.coefficients_t(hf)
    img = dec.back_half(coefs_t, hf.plan, hf.out_pi)
    assert np.array_equal(dec.decode(streams[name], req), img.numpy())


def test_direct_plain_is_explicit_bstart():
    """decode_blocks_direct (CPU: its plain version) equals
    decode_blocks_plain with bstart = (0, nbits) on coded rows with long
    codes and on random words, and every error kind of
    scan_rows.block_error_rows decodes as the segment-row mode does once
    each block stands in a row of its own."""
    rng = np.random.default_rng(3)
    tabs = [scan_rows.long_code_tables(s) for s in (1, 2)]
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, 200, 1, tabs, thd.NO_PATTERN,
        (rng.integers(0, 2, 200), rng.integers(0, 2, 200)),
        rng.integers(0, 2, 200), long_share=0.5)
    words, nbits = scan_rows.word_matrix(rows)
    rand = rng.integers(-(1 << 31), 1 << 31, (150, 5)).astype(np.int32)
    cases = [(words, nbits, nb, dcl, acl),
             (rand, rng.integers(0, 161, 150), rng.integers(0, 2, 150),
              rng.integers(0, 2, 150), rng.integers(0, 2, 150))]
    tab = scan_rows.decode_tables(tabs)
    for case in cases:
        w, n, b, d, a = (torch.from_numpy(np.asarray(x, np.int32))
                         for x in case)
        got = thd.decode_blocks_direct(w, n, b, d, a, tab)
        want = thd.decode_blocks_plain(
            w, torch.stack([torch.zeros_like(n), n], 1), b, d, a, tab)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[1].any()) and not bool(got[1].all())

    words, bstart, nblocks, tab, want = scan_rows.block_error_rows()
    rows, bits, keep = [], [], []
    for s in range(len(nblocks)):
        row = np.unpackbits(words[s].view(np.uint8))
        for j in range(3):
            if j < nblocks[s]:
                lo, hi = int(bstart[s, j]), int(bstart[s, j + 1])
                rows.append(np.packbits(row[lo:]).tobytes())
                bits.append(hi - lo)
                keep.append(want[s][j])
    w, _ = scan_rows.word_matrix(rows)
    ones = torch.ones(len(rows), dtype=torch.int32)
    _, err = thd.decode_blocks_direct(
        torch.from_numpy(w), torch.tensor(bits, dtype=torch.int32), ones,
        ones, ones, tab)
    assert err.tolist() == keep


def test_direct_wrapper_refuses():
    """The direct wrapper checks its arguments as decode_blocks does, and
    a CUDA call without the lookahead table raises instead of falling
    back (meta tensors stand in for the card)."""
    tab = scan_rows.decode_tables([scan_rows.long_code_tables(0)] * 2)
    w = torch.zeros((4, 3), dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="per-segment"):
        thd.decode_blocks_direct(w, n[:3], n, n, n, tab)
    with pytest.raises(ValueError, match="words"):
        thd.decode_blocks_direct(w.to(torch.int64), n, n, n, n, tab)
    m = [x.to("meta") for x in (w, n, n, n, n, tab)]
    with pytest.raises(ValueError, match="CUDA"):
        thd.decode_blocks_direct(*m)
