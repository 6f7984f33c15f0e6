"""Segment rows for the Huffman decode tests (tests/test_torch_scan_lut.py
and tests/test_torch_block_lut.py on the CPU, tests/test_torch_kernels.py
on the card): canonical tables with codes of up to 16 bits and seeded
token streams coded with them, packed as the decoder's word matrix
(stream/segments.pack_segments_matrix: byte k of a row is stream byte k,
host-order int32 words, nbits = 8 x bytes), hand-coded rows with
block boundaries for each of phase C's error kinds, and the rewrite of a
stream into one of three Huffman table sets.  Imports neither JAX nor the
JAX package."""

import numpy as np
import torch

from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from gpujpeg_tpu_torch.utils import tables as tt

#: AC code lengths by rank: 2 of 2 bits, 2 of 3, 4 of 5, 8 of 8, 32 of
#: 10, 64 of 12, 32 of 14, the rest (18) of 16 bits
_AC_LENGTHS = [2] * 2 + [3] * 2 + [5] * 4 + [8] * 8 + [10] * 32 + \
    [12] * 64 + [14] * 32 + [16] * 18
#: DC code lengths of sizes 0..11
_DC_LENGTHS = [2, 2, 3, 3, 10, 11, 12, 13, 14, 15, 16, 16]


def _dht(lengths, symbols):
    """(bits[17], values) of symbols in rank order with these lengths."""
    order = np.argsort(lengths, kind="stable")
    bits = np.zeros(17, np.int32)
    for l in lengths:
        bits[l] += 1
    return bits, np.asarray(symbols, np.int32)[order]


def long_code_tables(seed=0):
    """(dc, ac) DHT (bits, values) pairs whose codes run from 2 to 16 bits,
    most AC symbols at 10 bits or longer: EOB, (0,1), (0,2), (1,1), (0,3)
    and ZRL get the short codes, the other 156 symbols take the longer
    ranks in a seeded order."""
    rng = np.random.default_rng(seed)
    first = [0x00, 0x01, 0x02, 0x11, 0x03, 0xF0]
    rest = [(r << 4) | s for r in range(16) for s in range(1, 11)
            if (r << 4) | s not in first]
    rest = [rest[i] for i in rng.permutation(len(rest))]
    ac = _dht(_AC_LENGTHS, first + rest)
    dc = _dht(_DC_LENGTHS, list(range(12)))
    return dc, ac


class _Coder:
    """Canonical codes of one DHT table: symbol -> (code, length)."""

    def __init__(self, dht):
        syms, lens, codes = tt.huffman_canonical(*dht)
        self.code = {int(s): (int(c), int(l))
                     for s, l, c in zip(syms, lens, codes)}
        self.symbols = [int(s) for s in syms]


def _block_tokens(rng, dc, ac, long_share, bad_run=False):
    """One block's tokens as (symbol, coder, value size) tuples: a DC size,
    then AC (run, size) symbols, ZRLs and an EOB unless position 64 is
    reached.  long_share is the chance of drawing any AC symbol (most
    have long codes) instead of one of the six short ones.  bad_run ends
    the block with a run past coefficient 63 (from position 60)."""
    toks = [(int(rng.integers(0, 12)), dc, None)]
    if bad_run:          # 59 steps of 1 to position 60, then a run of 15
        return toks + [(0x01, ac, None)] * 59 + [(0xF1, ac, None)]
    pos = 1
    while pos < 64:
        if rng.random() < 0.08:
            toks.append((0x00, ac, 0))
            return toks
        pool = ac.symbols if rng.random() < long_share else \
            [0x01, 0x02, 0x11, 0x03, 0xF0]
        sym = int(pool[rng.integers(0, len(pool))])
        if sym == 0x00:
            return toks + [(0x00, ac, 0)]
        run = 16 if sym == 0xF0 else (sym >> 4) + 1
        if pos + run > 64:
            continue
        toks.append((sym, ac, None))
        pos += run
    return toks


def block_sets(dc_sel, ac_sel, pattern, slot, nsets):
    """(DC set, AC set) of a block in slot `slot` of a segment with
    selectors dc_sel, ac_sel, as the kernels pick them (huffdec_kernel's
    module docstring): with two sets, set 0 where flag and pattern bit
    are set; with four, selector plus the slot's 2-bit field, mod 4."""
    _bpm, dc_pat, ac_pat = pattern
    if nsets == 2:
        return (0 if dc_sel and (dc_pat >> slot) & 1 else 1,
                0 if ac_sel and (ac_pat >> slot) & 1 else 1)
    return ((int(dc_sel) + (dc_pat >> 2 * slot)) & 3,
            (int(ac_sel) + (ac_pat >> 2 * slot)) & 3)


def segment_rows(rng, nseg, bps, tabs, pattern=thd.NO_PATTERN, flags=None,
                 nblocks=None, long_share=0.3, bad_run=()):
    """Seeded segments coded with two, three or four table sets.

    tabs: a (dc, ac) DHT pair a set; pattern and flags (the selectors
    dc_luma, ac_luma per segment: luma flags with two sets, set indices
    with more; default all 1 with two sets, all 0 with more) pick each
    block's set as the kernels do (block_sets; three sets decode as four,
    decode_tables).  nblocks: blocks coded a segment (default bps).
    bad_run: segments whose last block runs past coefficient 63.  Returns
    (rows: list of bytes, nblocks (nseg,) int32, dc_luma, ac_luma)."""
    bpm = pattern[0]
    nsets = 2 if len(tabs) == 2 else 4
    coders = [(_Coder(d), _Coder(a)) for d, a in _padded(tabs)]
    if flags is None:
        fill = 1 if nsets == 2 else 0
        flags = (np.full(nseg, fill, np.int32), np.full(nseg, fill, np.int32))
    if nblocks is None:
        nblocks = np.full(nseg, bps, np.int32)
    rows = []
    for s in range(nseg):
        bits = []
        for j in range(int(nblocks[s])):
            dset, aset = block_sets(flags[0][s], flags[1][s], pattern,
                                    j % bpm, nsets)
            bad = s in bad_run and j == int(nblocks[s]) - 1
            for sym, coder, size in _block_tokens(
                    rng, coders[dset][0], coders[aset][1], long_share, bad):
                code, length = coder.code[sym]
                bits.extend((code >> (length - 1 - i)) & 1
                            for i in range(length))
                size = sym & 15 if size is None else size
                bits.extend(int(b) for b in rng.integers(0, 2, size))
        bits.extend([1] * (-len(bits) % 8))       # T.81 padding bits
        rows.append(np.packbits(np.asarray(bits, np.uint8)).tobytes()
                    if bits else b"")
    return (rows, np.asarray(nblocks, np.int32),
            np.asarray(flags[0], np.int32), np.asarray(flags[1], np.int32))


def word_matrix(rows, W=None):
    """(words (nseg, W) int32, nbits (nseg,) int32) of byte rows; W
    defaults to the longest row's words."""
    need = max([-(-len(r) // 4) for r in rows] + [1])
    W = need if W is None else W
    assert W >= need
    buf = np.zeros((len(rows), W * 4), np.uint8)
    for i, r in enumerate(rows):
        buf[i, :len(r)] = np.frombuffer(r, np.uint8)
    nbits = np.asarray([8 * len(r) for r in rows], np.int32)
    return buf.view("<u4").view(np.int32).copy(), nbits


def _padded(tabs):
    """Two sets as they are; three or four padded to four with the last."""
    tabs = list(tabs)
    return tabs if len(tabs) == 2 else tabs + tabs[-1:] * (4 - len(tabs))


def decode_tables(tabs) -> torch.Tensor:
    """(4, DECODE_TABLE_WORDS) int32 of two (dc, ac) sets, or (8, ...) of
    three or four (padded to four with the last)."""
    sets = _padded(tabs)
    return torch.from_numpy(thd.decode_tables(*[d for d, _ in sets],
                                              *[a for _, a in sets]))


def annexk_tables():
    """((dc, ac) luma, (dc, ac) chroma) DHT pairs of T.81 Annex K."""
    return [(tt.huffman_spec_for("dc", luma), tt.huffman_spec_for("ac", luma))
            for luma in (True, False)]


def dc_with_big_symbols():
    """A DC table whose codes include symbols above 15 (bad in a block),
    at 3, 7 and 11 bits, and sizes 10 and 11 at 12 and 13 bits."""
    bits = np.zeros(17, np.int32)
    bits[2], bits[3] = 2, 3
    bits[4:14] = 1
    return bits, np.asarray([0, 1, 2, 3, 0x10, 4, 5, 6, 0x1F, 7, 8, 9, 0x33,
                             10, 11], np.int32)


def _bits(tokens):
    """Bytes of (code, length) pairs, 1-padded."""
    bits = []
    for code, length in tokens:
        bits.extend((code >> (length - 1 - i)) & 1 for i in range(length))
    bits.extend([1] * (-len(bits) % 8))
    return np.packbits(np.asarray(bits, np.uint8)).tobytes()


def block_error_rows():
    """Five hand-coded segments of 3 block slots, with phase C's block
    boundaries, for each of its error kinds (table set 0: DC
    dc_with_big_symbols, AC Annex-K luma; set 1 Annex-K chroma):

      0. a good block (DC 5, AC 1, EOB), a DC symbol 0x10, a block whose
         bits end right after its DC (good);
      1. a run past coefficient 63, a good block, a slot past nblocks;
      2. all one bits: invalid DC codes;
      3. a block cut 1 bit short (its EOB overruns), then a block of 2
         bits whose DC does not fit;
      4. a good DC, then an invalid AC code.

    Returns (words, bstart (5, 4), nblocks, tables (4, 290) int32 tensor,
    expected err (5, 3))."""
    dc_t = dc_with_big_symbols()
    ac_t = annexk_tables()[0][1]
    tab = decode_tables([(dc_t, ac_t), annexk_tables()[1]])
    dcc, acc = _Coder(dc_t), _Coder(ac_t)
    eob = acc.code[0x00]
    blk0 = [dcc.code[3], (0b101, 3), acc.code[0x01], (1, 1), eob]
    L0 = sum(l for _, l in blk0)
    run = [dcc.code[0]] + [acc.code[0x01], (0, 1)] * 59 + \
        [acc.code[0xF1], (1, 1)]
    Lr = sum(l for _, l in run)
    d16 = dcc.code[0x10][1] + eob[1]
    d0 = dcc.code[0][1]
    rows = [blk0 + [dcc.code[0x10], eob, dcc.code[0]],
            run + blk0,
            [(0xFFFF, 16)] * 4,
            blk0 * 2,
            [dcc.code[0], (0xFFFF, 16), (0xFFFF, 16)]]
    words, _ = word_matrix([_bits(r) for r in rows], 12)
    bstart = np.asarray([[0, L0, L0 + d16, L0 + d16 + d0],
                         [0, Lr, Lr + L0, Lr + L0],
                         [0, 10, 40, 64],
                         [0, L0 - 1, L0 + 1, L0 + 1],
                         [0, d0 + 32, d0 + 32, d0 + 32]], np.int32)
    nblocks = np.asarray([3, 2, 3, 2, 1], np.int32)
    want = [[0, 1, 0], [1, 0, 0], [1, 1, 1], [1, 1, 0], [1, 0, 0]]
    return words, bstart, nblocks, tab, want


def three_sets(data: bytes) -> bytes:
    """The stream with a copy of its chroma AC table (class 1, id 1) under
    id 2 and component 3's AC selector pointed at it in every SOS
    (tests/test_legacy_decode.py's rewrite): three AC table sets, the same
    pixels."""
    data = bytearray(data)
    i = 2
    while i < len(data) - 4:
        if data[i] == 0xFF and data[i + 1] == 0xC4:
            ln = (data[i + 2] << 8) | data[i + 3]
            if data[i + 4] == 0x11:
                seg = bytearray(data[i:i + 2 + ln])
                seg[4] = 0x12
                data[i + 2 + ln:i + 2 + ln] = bytes(seg)
                break
            i += 2 + ln
        else:
            i += 1
    else:
        raise ValueError("no AC table 1 in the stream")
    j = 0
    while j < len(data) - 2:
        if data[j] == 0xFF and data[j + 1] == 0xDA:
            ln = (data[j + 2] << 8) | data[j + 3]
            for k in range(data[j + 4]):
                if data[j + 5 + 2 * k] == 3:
                    data[j + 6 + 2 * k] = (data[j + 6 + 2 * k] & 0xF0) | 2
            j += 2 + ln
        else:
            j += 1
    return bytes(data)
