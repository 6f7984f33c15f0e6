"""PyTorch port, phase C's direct instance and four-set instance
(csrc/huffdec_block.cu) against their plain versions on the card.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_phase_c.py -q

The direct instance (decode_blocks_direct: rows staged in shared memory,
or read from global memory when too wide, every token through
huffdec_kernel.direct_lut) and the segment-row instance of four table
sets (decode_blocks: CTAs of 8 warps, its tables in dynamic shared
memory) on coded rows of W = 1 to 40 words, segment counts that are not a
multiple of 32, word matrices off 16-byte alignment, two, three and four
table sets, random words and every error kind; the direct instance's
probe stages.  The tests marked gpu skip without a card; the others check
on any machine that the probe entry points take CUDA tensors only."""

import numpy as np
import pytest
import torch

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import _kernels
from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from tests import scan_rows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_card(cuda, words, offset):
    """The word matrix on the card, `offset` words past a 16-byte
    boundary."""
    words = torch.from_numpy(np.ascontiguousarray(words, np.int32))
    buf = torch.zeros(words.numel() + 4, dtype=torch.int32, device=cuda)
    w_dev = buf[offset:offset + words.numel()].view(words.shape)
    w_dev.copy_(words)
    assert w_dev.data_ptr() % 16 == 4 * offset
    return w_dev


def _direct_both(cuda, words, nbits, nb, dcl, acl, tab, pattern, offset=0):
    """The direct instance (one launch) and its plain version on the same
    rows: equal coefficients and err, which are returned."""
    w_dev = _on_card(cuda, words, offset)
    rows = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (nbits, nb, dcl, acl)]
    lut = torch.from_numpy(thd.direct_lut(tab.numpy())).to(cuda)
    _kernels.reset_launches()
    got = thd.decode_blocks_direct(w_dev, *[r.to(cuda) for r in rows],
                                   tab.to(cuda), pattern, lut)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffdec_block_direct"] == 1
    assert _kernels.LAUNCHES["huffdec_block"] == 0
    want = thd.decode_blocks_direct_plain(
        torch.from_numpy(np.ascontiguousarray(words, np.int32)), *rows, tab,
        pattern)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    return want


def _tabs(sets, seed):
    """Table sets of long codes (2-16 bits) and Annex K."""
    ak = scan_rows.annexk_tables()
    return [scan_rows.long_code_tables(seed), ak[1], ak[0],
            scan_rows.long_code_tables(seed + 1)][:sets]


def _one_block_rows(seed, sets, nseg, W):
    """Coded rows of one block, the segments' selectors at random, some
    segments empty, padded or cut to W words (a cut block overruns its
    bit count): (words, nbits, nblocks, dc_sel, ac_sel, tables,
    pattern)."""
    rng = np.random.default_rng(seed)
    wide = sets > 2
    nb = (rng.random(nseg) > 0.05).astype(np.int32)
    flags = (rng.integers(0, sets if wide else 2, nseg),
             rng.integers(0, sets if wide else 2, nseg))
    pattern = thd.NO_PATTERN_WIDE if wide else thd.NO_PATTERN
    tabs = _tabs(sets, seed)
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, 1, tabs, pattern, flags, nb, long_share=0.5)
    words, nbits = scan_rows.word_matrix([r[:4 * W] for r in rows], W)
    return (words, nbits, nb, dcl, acl, scan_rows.decode_tables(tabs),
            pattern)


DIRECT_CASES = [(1, 2, 0), (3, 3, 1), (7, 4, 3), (16, 2, 1), (17, 4, 0),
                (27, 2, 3), (27, 3, 0), (40, 2, 0), (40, 4, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("W,sets,offset", DIRECT_CASES)
def test_direct_coded_rows(cuda, W, sets, offset):
    """Coded rows of W = 1 to 40 words (odd and even widths, so both the
    padded and the unpadded stride of the staged rows), 333 segments (not
    a multiple of a warp's 32), two to four table sets, the word matrix
    off 16-byte alignment: bit for bit the plain decode; the rows that
    hold their whole block decode with no error."""
    words, nbits, nb, dcl, acl, tab, pattern = _one_block_rows(
        100 + W, sets, 333, W)
    coefs, err = _direct_both(cuda, words, nbits, nb, dcl, acl, tab,
                              pattern, offset)
    assert bool(coefs.any())
    if W >= 27:
        assert not bool(err[torch.from_numpy(nb) > 0].any())


@pytest.mark.gpu
@pytest.mark.parametrize("W,sets", [(1, 2), (2, 4), (9, 2), (33, 4)])
def test_direct_random_words(cuda, W, sets):
    """Random rows (invalid codes, overruns at DC and AC, DC symbols above
    15 under dc_with_big_symbols, runs past 63) with random bit counts in
    [0, 32 W], nblocks 0 or 1, random selectors: bit for bit the plain
    decode."""
    rng = np.random.default_rng(W)
    nseg = 1000
    tabs = _tabs(sets, W)
    tabs[0] = (scan_rows.dc_with_big_symbols(), tabs[0][1])
    words = rng.integers(-(1 << 31), 1 << 31, (nseg, W))
    _, err = _direct_both(cuda, words, rng.integers(0, 32 * W + 1, nseg),
                          rng.integers(0, 2, nseg),
                          rng.integers(0, sets, nseg),
                          rng.integers(0, sets, nseg),
                          scan_rows.decode_tables(tabs),
                          thd.NO_PATTERN_WIDE if sets > 2
                          else thd.NO_PATTERN, W % 4)
    assert bool(err.any()) and not bool(err.all())


@pytest.mark.gpu
@pytest.mark.parametrize("sets", [2, 4])
def test_direct_error_kinds(cuda, sets):
    """Each error kind of scan_rows.block_error_rows with every block in a
    row of its own, under two sets and under the same tables as four:
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
    n = len(rows)
    if sets == 2:
        sel, pattern = np.ones(n, np.int32), thd.NO_PATTERN
    else:       # set 0 of the two, padded: index 0 picks it
        tab = torch.cat([tab[:1], tab[1:2], tab[1:2], tab[1:2], tab[2:3],
                         tab[3:4], tab[3:4], tab[3:4]])
        sel, pattern = np.zeros(n, np.int32), thd.NO_PATTERN_WIDE
    _, err = _direct_both(cuda, w, np.asarray(bits), np.ones(n, np.int32),
                          sel, sel, tab, pattern)
    assert err.tolist() == keep


@pytest.mark.gpu
@pytest.mark.parametrize("sets", [2, 4])
def test_direct_wide_rows(cuda, sets):
    """Rows of 1,100 words, past the widest rows the instance stages in
    shared memory, read from global memory: coded blocks and random
    garbage after them, bit for bit the plain decode."""
    words, nbits, nb, dcl, acl, tab, pattern = _one_block_rows(
        7 + sets, sets, 70, 1100)
    rng = np.random.default_rng(sets)
    words[::2, 40:] = rng.integers(-(1 << 31), 1 << 31,
                                   words[::2, 40:].shape)
    nbits[1::4] = rng.integers(0, 32 * 1100 + 1, len(nbits[1::4]))
    _direct_both(cuda, words, nbits, nb, dcl, acl, tab, pattern, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gradient", "noise", "grey"])
def test_direct_q100_stream(cuda, kind):
    """A Q100 stream at the auto interval (one block a segment, about 61
    tokens a block) through the plan's direct_lut: bit for bit the plain
    decode, no error."""
    rng = np.random.default_rng(11)
    h, w = 240, 320
    if kind == "noise":
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        frame = np.clip(np.stack([xx * 255 // w, yy * 255 // h,
                                  (xx + yy) * 255 // (w + h)], -1)
                        + rng.integers(-24, 25, (h, w, 3)), 0,
                        255).astype(np.uint8)
        if kind == "grey":
            frame = np.ascontiguousarray(frame[..., 0])
    data = gt.Encoder(device="cpu").encode(frame, gt.Parameters(
        quality=100, restart_interval=gt.RESTART_AUTO))
    hf = gt.Decoder(device=cuda).prepare(data)
    p = hf.plan
    assert p.direct
    _kernels.reset_launches()
    words = torch.from_numpy(hf.words).to(cuda)
    nbits = torch.from_numpy(hf.nbits).to(cuda)
    got = thd.decode_blocks_direct(words, nbits, p.nblocks, p.dc_luma,
                                   p.ac_luma, p.tables, p.pattern,
                                   p.direct_lut)
    want = thd.decode_blocks_direct_plain(words, nbits, p.nblocks,
                                          p.dc_luma, p.ac_luma, p.tables,
                                          p.pattern)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool(got[1].any())
    assert _kernels.LAUNCHES["huffdec_block_direct"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("sets", [2, 4])
def test_direct_probe_stages_uncounted(cuda, sets):
    """The direct instance's probe stages: the full stage equals the plain
    decode, the others launch, and none is counted."""
    words, nbits, nb, dcl, acl, tab, pattern = _one_block_rows(
        40 + sets, sets, 300, 20)
    rows = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda)
            for a in (words, nbits, nb, dcl, acl)]
    lut = torch.from_numpy(thd.direct_lut(tab.numpy())).to(cuda)
    want = thd.decode_blocks_direct_plain(*[r.cpu() for r in rows], tab,
                                          pattern)
    _kernels.reset_launches()
    for stage in _kernels.PROBE_STAGES:
        coefs, err = thd.decode_blocks_direct_probe(
            *rows, tab.to(cuda), pattern, lut, stage)
        torch.cuda.synchronize()
        if stage == "full":
            assert torch.equal(coefs.cpu(), want[0])
            assert torch.equal(err.cpu(), want[1])
        elif stage == "load_store":
            assert not bool(coefs.any())
    assert _kernels.LAUNCHES["huffdec_block_direct"] == 0


def test_direct_probe_takes_cuda_tensors_only():
    """The direct instance's probe has no plain version: tensors off the
    card are refused, as the codec wrapper refuses a CUDA call without its
    table."""
    tab = scan_rows.decode_tables(_tabs(2, 0))
    words = torch.zeros((6, 9), dtype=torch.int32)
    rows = [torch.zeros(6, dtype=torch.int32) for _ in range(4)]
    lut = torch.from_numpy(thd.direct_lut(tab.numpy()))
    for stage in _kernels.PROBE_STAGES:
        with pytest.raises(ValueError, match="CUDA"):
            thd.decode_blocks_direct_probe(words, *rows, tab, thd.NO_PATTERN,
                                           lut, stage)
    assert "huffdec_block_direct" in _kernels.PROBES
    assert _kernels.source_of("huffdec_block_direct") == "huffdec_block"


# -- the four-set segment-row instance ---------------------------------------

def _segment_both(cuda, words, bstart, nb, dcl, acl, tab, pattern, offset):
    """The segment-row kernel (one launch) and the plain block decode on
    the same rows: equal coefficients and err, which are returned."""
    w_dev = _on_card(cuda, words, offset)
    rows = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (bstart, nb, dcl, acl)]
    lut = torch.from_numpy(thd.block_lut(tab.numpy())).to(cuda)
    _kernels.reset_launches()
    got = thd.decode_blocks(w_dev, *[r.to(cuda) for r in rows],
                            tab.to(cuda), pattern, lut)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["huffdec_block"] == 1
    want = thd.decode_blocks_plain(
        torch.from_numpy(np.ascontiguousarray(words, np.int32)), *rows, tab,
        pattern)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    return want


SEGMENT_CASES = [(3, 1, 3, 0), (4, 1, 7, 1), (3, 4, 16, 3), (4, 6, 27, 2),
                 (3, 3, 40, 1), (4, 10, 40, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("sets,bpm,W,offset", SEGMENT_CASES)
def test_four_set_segment_rows(cuda, sets, bpm, W, offset):
    """The four-set instance on coded rows of three or four sets picked by
    selectors plus 2-bit slot fields, rows of at least W = 3 to 40 words,
    301 segments, the word matrix off 16-byte alignment: bit for bit the
    plain decode from the plain scan's boundaries, and from boundaries
    shifted a few bits (garbage)."""
    rng = np.random.default_rng(sets * 100 + W)
    bps, nseg = 2 * bpm, 301
    fields = [rng.integers(0, sets, bpm) for _ in range(2)]
    pattern = (bpm,) + tuple(int(sum(int(f) << 2 * j
                                     for j, f in enumerate(fs)))
                             for fs in fields)
    sel = (rng.integers(0, 4, nseg), rng.integers(0, 4, nseg))
    tabs = _tabs(sets, W)
    rows, nb, dsel, asel = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern, sel, rng.integers(0, bps + 1, nseg),
        long_share=0.4)
    words, nbits = scan_rows.word_matrix(
        rows, max([W] + [-(-len(r) // 4) for r in rows]))
    tab = scan_rows.decode_tables(tabs)
    bstart, err = thd.scan_segments_plain(
        *(torch.from_numpy(np.asarray(a, np.int32))
          for a in (words, nbits, nb, dsel, asel)), tab, bps, pattern)
    assert not bool(err.any())
    coefs, err = _segment_both(cuda, words, bstart.numpy(), nb, dsel, asel,
                               tab, pattern, offset)
    assert not bool(err.any()) and bool(coefs.any())
    shifted = bstart.numpy().copy()
    shifted[:, :-1] += rng.integers(-3, 4, shifted[:, :-1].shape)
    shifted = np.clip(shifted, 0, 32 * words.shape[1])
    _, err = _segment_both(cuda, words, shifted, nb, dsel, asel, tab,
                           pattern, (offset + 1) % 4)
    assert bool(err.any())


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 13, 40])
def test_four_set_random_words(cuda, W):
    """Random rows and ascending boundaries (mostly bad tokens) with random
    set indices and fields (selector plus field wrapping past 3), a DC
    table with symbols above 15: bit for bit the plain decode."""
    rng = np.random.default_rng(W + 5)
    nseg, bps, bpm = 211, 5, 5
    tabs = _tabs(4, W)
    tabs[1] = (scan_rows.dc_with_big_symbols(), tabs[1][1])
    pattern = (bpm, int(rng.integers(0, 1 << 2 * bpm)),
               int(rng.integers(0, 1 << 2 * bpm)))
    words = rng.integers(-(1 << 31), 1 << 31, (nseg, W))
    bstart = np.sort(rng.integers(0, 32 * W + 1, (nseg, bps + 1)), axis=1)
    _segment_both(cuda, words, bstart, rng.integers(0, bps + 1, nseg),
                  rng.integers(0, 4, nseg), rng.integers(0, 4, nseg),
                  scan_rows.decode_tables(tabs), pattern, W % 4)
