"""PyTorch port, the decode kernels' table index widened to four table sets
(T.81's ids 0-3 a class; huffdec_kernel's module docstring): the kernels'
walks of phase A (huffdec_scan.cu) and phase C (huffdec_block.cu),
replayed in Python with their set choice (tests/scan_rows.block_sets),
against the plain versions on coded rows of three and four sets with long
codes, chosen by segment selectors, by slot patterns of 2 bits a slot,
and by both; the four-set mode against the two-set mode on rows of two
sets; and the lookahead tables of eight tables row for row against those
of each set's four.  The kernels themselves are held against the plain
versions on the card (tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from tests import scan_rows
from tests.test_torch_block_lut import _check_walk as _block_walk
from tests.test_torch_scan_lut import _check_walk as _scan_walk


def _sets(n, seed):
    """n (dc, ac) sets: long codes, Annex-K luma and chroma, long codes
    of another seed."""
    ak = scan_rows.annexk_tables()
    return [scan_rows.long_code_tables(seed), ak[1], ak[0],
            scan_rows.long_code_tables(seed + 100)][:n]


def _case(nsets, bpm, how, seed, nseg=12):
    """Coded rows of nsets sets whose blocks pick their set by `how`:
    "selector" (a set index a segment, the pattern's fields 0),
    "pattern" (selectors 0, a field a slot) or "both" (the two summed,
    mod 4).  -> (words, nbits, nblocks, dc_sel, ac_sel, tab, pattern,
    bps)."""
    rng = np.random.default_rng(seed)
    bps = 2 * bpm
    fields = [rng.integers(0, nsets, bpm) for _ in range(2)]
    pat = tuple(int(sum(int(f) << 2 * j for j, f in enumerate(fs)))
                for fs in fields)
    pattern = (bpm,) + (pat if how != "selector" else (0, 0))
    if how == "pattern":
        sel = (np.zeros(nseg, np.int32), np.zeros(nseg, np.int32))
    else:
        sel = (rng.integers(0, 4, nseg), rng.integers(0, 4, nseg))
    tabs = _sets(nsets, seed)
    nblocks = rng.integers(0, bps + 1, nseg)
    rows, nb, dsel, asel = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern, sel, nblocks, long_share=0.5)
    words, nbits = scan_rows.word_matrix(rows)
    return (words, nbits, nb, dsel, asel, scan_rows.decode_tables(tabs),
            pattern, bps)


CASES = [(n, bpm, how) for n in (3, 4) for bpm, how in
         ((1, "selector"), (3, "pattern"), (6, "pattern"), (10, "both"))]


@pytest.mark.parametrize("nsets,bpm,how", CASES)
def test_scan_walk_four_sets(nsets, bpm, how):
    """Phase A's walk with the eight-table lookahead table and the
    four-set choice equals the plain scan, with no error on intact
    rows."""
    words, nbits, nb, dsel, asel, tab, pattern, bps = _case(
        nsets, bpm, how, 10 * nsets + bpm)
    assert tuple(tab.shape) == (8, 290)
    _, err = _scan_walk(words, nbits, nb, dsel, asel, tab, bps, pattern)
    assert not err.any()


@pytest.mark.parametrize("nsets,bpm,how", CASES)
def test_block_walk_four_sets(nsets, bpm, how):
    """Phase C's walk with the eight-table lookahead table and the
    four-set choice equals the plain block decode on phase A's
    boundaries: equal coefficients and err, no error on intact rows."""
    words, nbits, nb, dsel, asel, tab, pattern, bps = _case(
        nsets, bpm, how, 10 * nsets + bpm + 1)
    bstart, err_a = thd.scan_segments_plain(
        *(torch.from_numpy(np.asarray(a, np.int32))
          for a in (words, nbits, nb, dsel, asel)), tab, bps, pattern)
    assert not err_a.any()
    coefs, err = _block_walk(words, bstart.numpy(), nb, dsel, asel, tab,
                             pattern)
    assert not err.any() and coefs.abs().sum() > 0


@pytest.mark.parametrize("bpm", [1, 4])
def test_four_set_mode_matches_two(bpm):
    """Rows of two sets decode alike in both modes: the two-set tables
    with luma flags and 1-bit patterns, and the same sets padded to four
    with set indices (flag 1 and bit 1 = set 0) and 2-bit patterns."""
    rng = np.random.default_rng(40 + bpm)
    nseg, bps = 10, 2 * bpm
    bits = [int(b) for b in rng.integers(0, 2, 2 * bpm)]
    pattern2 = (bpm, sum(b << j for j, b in enumerate(bits[:bpm])),
                sum(b << j for j, b in enumerate(bits[bpm:])))
    flags = (rng.integers(0, 2, nseg), rng.integers(0, 2, nseg))
    tabs = _sets(2, 7)
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern2, flags, long_share=0.5)
    words, nbits = scan_rows.word_matrix(rows)
    # the same choice as indices: set 1 - (flag & bit)
    if bpm == 1:
        sel4 = tuple(1 - (np.asarray(f) & (p & 1))
                     for f, p in zip((dcl, acl), pattern2[1:]))
        pattern4 = (1, 0, 0)
    else:
        # flags vary by segment and bits by slot: keep the segments whose
        # flags are 1, where the set is 1 - bit, a field a slot
        keep = (dcl != 0) & (acl != 0)
        words, nbits, nb = words[keep], nbits[keep], nb[keep]
        dcl, acl = dcl[keep], acl[keep]
        sel4 = (np.zeros(len(nb), np.int32), np.zeros(len(nb), np.int32))
        pattern4 = (bpm,) + tuple(
            sum((1 - ((pattern2[1 + k] >> j) & 1)) << 2 * j
                for j in range(bpm)) for k in range(2))
    args2 = [torch.from_numpy(np.asarray(a, np.int32))
             for a in (words, nbits, nb, dcl, acl)]
    args4 = args2[:3] + [torch.from_numpy(np.asarray(a, np.int32))
                         for a in sel4]
    tab2 = scan_rows.decode_tables(tabs)
    tab4 = scan_rows.decode_tables(tabs + tabs[-1:])
    b2, e2 = thd.scan_segments_plain(*args2, tab2, bps, pattern2)
    b4, e4 = thd.scan_segments_plain(*args4, tab4, bps, pattern4)
    assert torch.equal(b2, b4) and torch.equal(e2, e4) and not e2.any()
    c2, f2 = thd.decode_blocks_plain(args2[0], b2, *args2[2:], tab2,
                                     pattern2)
    c4, f4 = thd.decode_blocks_plain(args4[0], b4, *args4[2:], tab4,
                                     pattern4)
    assert torch.equal(c2, c4) and torch.equal(f2, f4) and not f2.any()


def test_lookahead_tables_of_four_sets():
    """scan_lut and block_lut of eight tables: the DC row of set k and
    the AC row of set k equal those of set k's own two-set stack."""
    sets = _sets(4, 3)
    tab = scan_rows.decode_tables(sets).numpy()
    slut, blut = thd.scan_lut(tab), thd.block_lut(tab)
    assert slut.shape == (8, 1 << thd.SCAN_LUT_BITS)
    assert blut.shape == (8, 1 << thd.BLOCK_LUT_BITS)
    for k, one in enumerate(sets):
        t2 = scan_rows.decode_tables([one, one]).numpy()
        s2, b2 = thd.scan_lut(t2), thd.block_lut(t2)
        for row, row2 in ((k, 0), (4 + k, 2)):
            assert np.array_equal(slut[row], s2[row2])
            assert np.array_equal(blut[row], b2[row2])


def test_table_set_checks():
    """Eight tables take 2-bit fields of at most 15 slots; other table
    counts and wider masks raise."""
    words = torch.zeros((2, 4), dtype=torch.int32)
    rows = [torch.zeros(2, dtype=torch.int32) for _ in range(4)]
    tab = scan_rows.decode_tables(_sets(4, 0))
    thd.scan_segments(words, *rows, tab, 3, (3, 0b111111, 0))
    with pytest.raises(ValueError, match="2 bpm bits"):
        thd.scan_segments(words, *rows, tab, 3, (3, 1 << 6, 0))
    with pytest.raises(ValueError, match="4 or 8"):
        thd.scan_segments(words, *rows, tab[:6], 3)
    with pytest.raises(ValueError, match="two or four"):
        thd.decode_tables(*[scan_rows.annexk_tables()[0][0]] * 6)
