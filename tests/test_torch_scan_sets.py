"""PyTorch port, phase A's four-set instances (csrc/huffdec_scan.cu
huffdec_scan_sets_kernel): the dynamic shared memory a launch of three or
four sets builds, replayed on the CPU with the constants parsed from the
source: the lookahead rows of the sets it loads (24 KB for three, whose
fourth set is never loaded; 32 KB for four), the zero row that sends a
block of an unloaded set to the canonical decode, and the eight canonical
tables packed with their symbols as bytes (huffdec.cuh gj::Packed).  The
packed decode equals the canonical decode (gj::decode_one, the plain
_decode_token) on every 16-bit peek; the walk through these tables, with
each segment's selector added to its slot pattern (add_fields), equals
the plain scan (scan_segments_plain); the decoder's plans pass the sets
their streams use.  The kernel itself is held against the plain scan on
the card (tests/test_torch_kernels_fixup_scan.py)."""

import os
import re

import numpy as np
import pytest
import torch

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from tests import scan_rows
from tests.test_torch_table_sets import _case, _sets
from tests import torch_threads  # noqa: F401

CSRC = os.path.join(os.path.dirname(thd.__file__), os.pardir, "csrc")
K = thd.SCAN_LUT_BITS
PEEKS = torch.arange(1 << 16, dtype=torch.int64)


def _const(name: str) -> int:
    """A constexpr int of huffdec_scan.cu or huffdec.cuh, its operands
    resolved the same way."""
    for f in ("huffdec_scan.cu", "huffdec.cuh"):
        with open(os.path.join(CSRC, f)) as fh:
            m = re.search(rf"constexpr int {name} = ([^;]+);", fh.read())
        if m:
            expr = m.group(1).replace("gj::", "")
            names = set(re.findall(r"\bk[A-Z]\w*", expr))
            return int(eval(expr, {}, {n: _const(n) for n in names}))
    raise KeyError(name)


def _rows(load: int) -> int:
    """sets_rows(load): a DC and an AC row a loaded set, and the zero
    row when a set is left out."""
    return 2 * load + (1 if load < 4 else 0)


def _smem(tab: torch.Tensor, load: int):
    """The launch's dynamic shared memory: (lookahead rows (rows, 2048)
    uint16, mv (8, kPackedWords) int32, hv (8, 256) uint8, its bytes)."""
    lut = thd.scan_lut(tab.numpy()).astype(np.uint16)
    rows = [lut[r] for r in range(load)] + [lut[4 + r] for r in range(load)]
    if load < 4:
        rows.append(np.zeros(1 << K, np.uint16))
    pw = _const("kPackedWords")
    mv = tab.numpy()[:, :pw].astype(np.int32)
    hv = tab.numpy()[:, pw:].astype(np.uint8)
    nbytes = sum(r.nbytes for r in rows) + mv.nbytes + hv.nbytes
    return np.stack(rows), mv, hv, nbytes


def _packed_decode(mv, hv, t, p16):
    """gj::Packed::decode on table t: the binary search of mono[1..15],
    the symbol byte at valoff[clen] plus the code (clamped to 0..255)."""
    c = np.zeros_like(p16)
    for half in (8, 4, 2, 1):
        nxt = np.minimum(c + half, 15)
        c = np.where((c + half <= 15) & (p16 > mv[t, nxt]), c + half, c)
    ln = c + 1
    idx = np.clip((p16 >> (16 - ln)) + mv[t, 17 + ln], 0, 255)
    sym = hv[t, idx].astype(np.int64)
    return np.where(p16 > mv[t, 16], 0, ln), sym


def _add_fields(pat: int, sel: int) -> int:
    """add_fields: (sel + field) & 3 in each 2-bit field, carry-free."""
    lo = 0x55555555
    y = (sel & 3) * lo
    return (((pat & lo) + (y & lo)) ^ (pat & ~lo & 0xFFFFFFFF)
            ^ (y & ~lo & 0xFFFFFFFF)) & 0xFFFFFFFF


def _tables(kind: str) -> torch.Tensor:
    """Eight decode tables: three sets with the fourth a copy of the
    third (the decoder's plan of a three-set stream), or four sets."""
    return scan_rows.decode_tables(_sets(3 if kind == "three" else 4, 11))


def test_constants_and_budget():
    """The shared memory of a launch: rows of 4 KB, the packed tables
    3,136 bytes; 31,808 bytes for three sets and 35,904 for four, so six
    CTAs of 8 warps fit an SM (228 KB, 1 KB reserved a CTA) at the 40
    registers the launch bound leaves (65,536 / (6 x 256), in steps of
    8)."""
    threads, ctas = _const("kThreads"), _const("kSetsCtas")
    assert _const("kRowBytes") == 2 << K == 4096
    assert _const("kPackedBytes") == 8 * (4 * _const("kPackedWords") + 256) \
        == 3136
    smem = {load: _rows(load) * 4096 + 3136 for load in (3, 4)}
    assert smem == {3: 31808, 4: 35904}
    tab = _tables("four")
    for load in (3, 4):
        assert _smem(tab, load)[3] == smem[load]
        assert ctas * (smem[load] + 1024) <= 228 * 1024
    assert ctas == 6 and threads == 256
    assert 65536 // (ctas * threads) // 8 * 8 == 40


@pytest.mark.parametrize("kind", ["three", "four"])
def test_packed_decode_every_peek(kind):
    """Each of the eight packed tables decodes every 16-bit peek as the
    canonical decode on the unpacked table: code length (0 for an
    invalid code) and symbol."""
    tab = _tables(kind)
    _, mv, hv, _ = _smem(tab, 4)
    p = PEEKS.numpy()
    for t in range(8):
        clen, sym = thd._decode_token(tab.to(torch.int64),
                                      torch.full_like(PEEKS, t), PEEKS)
        got = _packed_decode(mv, hv, t, p)
        assert np.array_equal(got[0], clen.numpy())
        ok = clen.numpy() > 0
        assert np.array_equal(got[1][ok], sym.numpy()[ok])


@pytest.mark.parametrize("kind,load", [("three", 3), ("four", 3),
                                       ("four", 4)])
def test_lookahead_rows_of_the_launch(kind, load):
    """A block's DC and AC rows in the launch's shared memory (FourSets:
    set s < load at rows s and load + s, a set past them at the zero row)
    hold scan_lut's entries of its table for every 11-bit prefix, or 0,
    where every 16-bit peek takes the packed canonical decode; no row of
    the three-set launch is the fourth set's."""
    tab = _tables(kind)
    rows, mv, hv, _ = _smem(tab, load)
    full = thd.scan_lut(tab.numpy()).astype(np.uint16)
    for s in range(4):
        for is_dc in (True, False):
            r = (s if is_dc else load + s) if s < load else 2 * load
            want = full[s if is_dc else 4 + s] if s < load else 0
            assert np.array_equal(rows[r], np.broadcast_to(want, rows[r]
                                                           .shape))
    if load == 3:
        assert len(rows) == 7 and not rows[6].any()
        if kind == "three":       # the copy of set 2 is never loaded
            assert np.array_equal(full[3], full[2])


@pytest.mark.parametrize("pat", [0, 0b111001, 0x3FFFFFFF, 0x2D2D2D2D])
def test_add_fields(pat):
    """A segment's selector added to every 2-bit field of its slot
    pattern equals gj::set_of<4>'s (sel + field) & 3 in each slot, for
    selectors of any int32 value."""
    for sel in range(-6, 9):
        got = _add_fields(pat, sel)
        for slot in range(15):
            assert (got >> 2 * slot) & 3 == (sel + (pat >> 2 * slot)) & 3


def _sets_walk(words, nbits, nblocks, dsel, asel, tab, bps, pattern, load):
    """walk_row with FourSets<load>: the entry of the next K bits in the
    block's row of the launch's shared memory; one token from the packed
    canonical table of its set where the entry is 0 or its step would
    pass position 64; a block ends at an entry's EOB or position 64."""
    rows, mv, hv, _ = _smem(tab, load)
    bpm, dc_pat, ac_pat = pattern
    nseg, W = words.shape
    total = 32 * W
    bstart = np.zeros((nseg, bps + 1), np.int64)
    err = np.zeros(nseg, bool)
    for s in range(nseg):
        row = int.from_bytes(np.asarray(words[s]).astype("<u4").tobytes(),
                             "big") << 64         # zeros past the row
        dm = _add_fields(dc_pat, int(dsel[s]))
        am = _add_fields(ac_pat, int(asel[s]))

        def peek(c, n):
            return (row >> (total + 64 - c - n)) & ((1 << n) - 1)

        def cls(slot):
            ds, as_ = (dm >> 2 * slot) & 3, (am >> 2 * slot) & 3
            return ((ds if ds < load else 2 * load,
                     load + as_ if as_ < load else 2 * load), (ds, 4 + as_))

        cursor = blk = pos = slot = 0
        bad = False
        (dr, ar), (dt, at) = cls(0)
        while blk < int(nblocks[s]):
            is_dc = pos == 0
            e = int(rows[dr if is_dc else ar, peek(cursor, K)])
            new_pos = pos + ((e >> 5) & 63)
            if e == 0 or new_pos > 64:
                clen, sym = _packed_decode(mv, hv, dt if is_dc else at,
                                           np.int64(peek(cursor, 16)))
                if int(clen) == 0:
                    bad = True
                    break
                e = int(thd.scan_entry(int(clen), int(sym), is_dc))
                new_pos = pos + ((e >> 5) & 63)
            after = cursor + (e & 31)
            if after > int(nbits[s]) or new_pos > 64:
                bad = True
                break
            cursor = after
            if e & 0x800 or new_pos == 64:
                blk += 1
                slot = (slot + 1) % bpm
                bstart[s, blk] = after
                pos = 0
                (dr, ar), (dt, at) = cls(slot)
            else:
                pos = new_pos
        bstart[s, blk + 1:] = int(nbits[s])
        err[s] = bad or blk < int(nblocks[s])
    return torch.from_numpy(bstart.astype(np.int32)), torch.from_numpy(err)


@pytest.mark.parametrize("nsets,bpm,how,load", [
    (3, 1, "selector", 3), (3, 6, "pattern", 3), (3, 10, "both", 3),
    (4, 3, "pattern", 4), (4, 10, "both", 4), (4, 1, "selector", 3),
    (4, 6, "both", 3)])
def test_walk_matches_plain(nsets, bpm, how, load):
    """Coded rows of three or four sets with long codes, picked by
    selectors, 2-bit slot fields or both, walked through the launch's
    rows and packed tables: bstart and err equal the plain scan's, with
    no error.  The three-set launch on rows of four sets takes the
    canonical decode for every token of set 3 and gives the same."""
    words, nbits, nb, dsel, asel, tab, pattern, bps = _case(
        nsets, bpm, how, 90 + 10 * nsets + bpm)
    args = [torch.from_numpy(np.asarray(a, np.int32))
            for a in (words, nbits, nb, dsel, asel)]
    want = thd.scan_segments_plain(*args, tab, bps, pattern)
    got = _sets_walk(words, nbits, nb, dsel, asel, tab, bps, pattern, load)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not want[1].any()
    if load == 3 and nsets == 4 and how != "pattern":
        sets_of = [(int(d) + (pattern[1] >> 2 * j)) & 3
                   for d in dsel for j in range(bpm)]
        assert 3 in sets_of           # blocks of the unloaded set ran


def test_random_words_walk():
    """Random rows (mostly bad tokens) with random selectors and fields
    wrapping past 3, through the three- and four-set launches: the plain
    scan's bstart and err."""
    rng = np.random.default_rng(5)
    nseg, bps, bpm, W = 60, 6, 3, 7
    tab = _tables("four")
    pattern = (bpm, int(rng.integers(0, 1 << 2 * bpm)),
               int(rng.integers(0, 1 << 2 * bpm)))
    words = rng.integers(-(1 << 31), 1 << 31, (nseg, W)).astype(np.int32)
    nbits = rng.integers(0, 32 * W + 1, nseg)
    nb = rng.integers(0, bps + 1, nseg)
    sel = (rng.integers(0, 4, nseg), rng.integers(0, 4, nseg))
    args = [torch.from_numpy(np.asarray(a, np.int32))
            for a in (words, nbits, nb, *sel)]
    want = thd.scan_segments_plain(*args, tab, bps, pattern)
    for load in (3, 4):
        got = _sets_walk(words, nbits, nb, *sel, tab, bps, pattern, load)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plan_sets_and_wrapper():
    """The decoder's plan of a three-set stream has eight tables, its
    fourth set a copy of its third, and sets 3; a two-set stream's plan
    sets 2; the wrapper takes 3 or 4 sets of eight tables, 2 of four, and
    refuses others."""
    frame = np.random.default_rng(3).integers(0, 256, (32, 48, 3),
                                              dtype=np.uint8)
    params = gt.Parameters(quality=75, restart_interval=4,
                           huffman_tables="annexk")
    data = gt.Encoder(device="cpu").encode(frame, params)
    dec = gt.Decoder(device="cpu")
    hf2 = dec.prepare(data)
    hf3 = dec.prepare(scan_rows.three_sets(data))
    assert hf2.plan.sets == 2 and tuple(hf2.plan.tables.shape) == (4, 290)
    tab = hf3.plan.tables
    assert hf3.plan.sets == 3 and tuple(tab.shape) == (8, 290)
    assert torch.equal(tab[3], tab[2]) and torch.equal(tab[7], tab[6])
    assert np.array_equal(dec.decode(scan_rows.three_sets(data)),
                          dec.decode(data))
    words = torch.zeros((2, 4), dtype=torch.int32)
    rows = [torch.zeros(2, dtype=torch.int32) for _ in range(4)]
    for sets in (3, 4, None):
        thd.scan_segments(words, *rows, tab, 3, (3, 0, 0), sets=sets)
    for bad, t in ((2, tab), (5, tab), (3, tab[:4]), (4, tab[:4])):
        with pytest.raises(ValueError, match="sets"):
            thd.scan_segments(words, *rows, t, 3,
                              (3, 0, 0),
                              sets=bad)
