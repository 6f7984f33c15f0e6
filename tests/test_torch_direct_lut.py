"""PyTorch port, the direct instance of phase C (one block a segment):
its two-level table (huffdec_kernel.direct_lut) on all 65,536 16-bit
peeks against the canonical decode (_decode_token), a token decode from
the canonical codes and the JAX package's arithmetic decode of the tuned
tables; the kernel's walk (csrc/huffdec_block.cu, huffdec_direct_kernel:
the table, the value from the peek, a three-word window that reads
whatever follows a row) replayed here against the plain direct decode
(decode_blocks_direct_plain) on Q100 streams, coded rows of two and four
table sets, random words and every error kind; and Q >= 97 streams of
three table sets through the direct route, Q75 ones through phases A
and C, pixels equal to the JAX package's; and chip_smoke.token_paths,
whose token-path counts PERF.md reports, against the decoded tokens.
The kernel itself is held against the plain decode on the card
(tests/test_torch_kernels_phase_c.py)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpujpeg_tpu as gj
from gpujpeg_tpu.ops import huffdec_kernel as jhk
from gpujpeg_tpu.utils import tables as jt

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from gpujpeg_tpu_torch.utils import tables as tt
from tests import scan_rows
from tests import torch_threads  # noqa: F401

K = thd.DIRECT_LUT_BITS
PEEKS = np.arange(1 << 16, dtype=np.int64)


def _tuned(quality):
    return [(tt.huffman_spec_for("dc", luma), tt.ac_spec(luma, quality))
            for luma in (True, False)]


TABLES = {
    **{f"tuned_q{q}": (lambda q=q: _tuned(q)) for q in (10, 75, 100)},
    "annexk": scan_rows.annexk_tables,
    "long_codes": lambda: [scan_rows.long_code_tables(1),
                           scan_rows.annexk_tables()[1]],
    "dc_big_symbols": lambda: [(scan_rows.dc_with_big_symbols(),
                                scan_rows.annexk_tables()[0][1]),
                               scan_rows.annexk_tables()[1]],
    "four_sets": lambda: [scan_rows.long_code_tables(2),
                          scan_rows.annexk_tables()[1],
                          (scan_rows.dc_with_big_symbols(),
                           scan_rows.long_code_tables(4)[1]),
                          scan_rows.annexk_tables()[0]],
}


@functools.lru_cache(maxsize=None)
def _lut(name):
    """(decode tables, direct_lut) of a TABLES entry, built once a module:
    the table is a canonical decode of all 65,536 peeks of each of its
    tables, and several tests read it."""
    tab = scan_rows.decode_tables(TABLES[name]())
    return tab, thd.direct_lut(tab.numpy())


def _lookup(lut, t, peek16):
    """The kernel's two loads: the entry of the first K bits, and where it
    marks a second level, the entry of the next 16 - K bits in the
    second-level table it indexes."""
    u = lut.view(np.uint16).astype(np.int64)
    e = u[t, peek16 >> (16 - K)]
    sub = (e & thd.DIRECT_SUB) != 0
    second = np.where(sub, (1 << K) + ((e & 511) << (16 - K))
                      + (peek16 & ((1 << (16 - K)) - 1)), 0)
    return np.where(sub, u[t, second], e), sub


def _want(clen, sym, is_dc):
    ok = (clen >= 1) & ((sym <= 15) | (not is_dc))
    return np.where(ok, thd.direct_entry(clen, sym, is_dc),
                    thd.DIRECT_SPECIAL)


@pytest.mark.parametrize("name", list(TABLES))
def test_lut_matches_canonical_decode(name):
    """Over all 65,536 16-bit peeks the two loads give the canonical
    decode's token (_decode_token, the plain version's): DIRECT_SPECIAL
    alone for an invalid code and a DC symbol above 15.  The first level holds every code of
    at most K bits itself, a second level is marked only where a prefix
    holds a longer code, the stride is a multiple of 8, and every entry
    past a table's second levels is 0."""
    tab, lut = _lut(name)
    nt = tab.shape[0]
    assert lut.dtype == np.int16 and lut.shape[0] == nt
    assert lut.shape[1] % 8 == 0 and lut.shape[1] >= 1 << K
    for t in range(nt):
        is_dc = t < nt // 2
        clen, sym = (x.numpy() for x in thd._decode_token(
            tab.to(torch.int64), torch.full((1 << 16,), t),
            torch.from_numpy(PEEKS)))
        got, sub = _lookup(lut, t, PEEKS)
        assert np.array_equal(got, _want(clen, sym, is_dc)), t
        assert not (sub & (clen >= 1) & (clen <= K)).any()
        sub_prefixes = np.unique(PEEKS[sub] >> (16 - K))
        assert np.array_equal(
            sub_prefixes, np.unique(PEEKS[clen > K] >> (16 - K)))
        used = (1 << K) + (len(sub_prefixes) << (16 - K))
        assert not lut[t, used:].any()


def _codes(dht):
    syms, lens, codes = tt.huffman_canonical(*dht)
    return [(int(s), int(l), int(c)) for s, l, c in zip(syms, lens, codes)]


@pytest.mark.parametrize("name", ["tuned_q100", "long_codes",
                                  "dc_big_symbols"])
def test_lut_matches_canonical_codes(name):
    """Every 16-bit extension of every canonical code (tables.
    huffman_canonical, independent of the decode tables) looks up that
    code's token, and every peek no code covers the invalid entry."""
    sets = TABLES[name]()
    lut = _lut(name)[1]
    for t, dht in enumerate([d for d, _ in sets] + [a for _, a in sets]):
        is_dc = t < len(sets)
        got, _ = _lookup(lut, t, PEEKS)
        covered = np.zeros(1 << 16, bool)
        for sym, l, code in _codes(dht):
            lo = code << (16 - l)
            span = slice(lo, lo + (1 << (16 - l)))
            want = thd.DIRECT_SPECIAL if is_dc and sym > 15 else \
                int(thd.direct_entry(l, sym, is_dc))
            assert (got[span] == want).all(), (t, hex(sym), l)
            covered[span] = True
        assert (got[~covered] == thd.DIRECT_SPECIAL).all(), t


@pytest.mark.parametrize("quality", [10, 75, 100])
def test_lut_matches_jax_affine_decode(quality):
    """The tuned tables' entries on every 16-bit peek equal the tokens of
    the JAX package's arithmetic decode (affine_ac_decode,
    dc_identity_decode)."""
    peek16 = jnp.asarray(PEEKS, jnp.int32)
    for luma in (True, False):
        bits, vals = tt.ac_spec(luma, quality)
        acl = jt.affine_ac_decode_runtime(*jt.match_affine_ac(bits, vals))
        dbits, dvals = tt.huffman_spec_for("dc", luma)
        mono, roff = jhk.dc_decode_runtime(dbits, dvals)
        lut = thd.direct_lut(thd.decode_tables(
            (dbits, dvals), (dbits, dvals), (bits, vals), (bits, vals)))
        for t, is_dc in ((0, True), (2, False)):
            c, s_ = (jhk.dc_identity_decode(peek16, luma, mono, mono, roff,
                                            roff)
                     if is_dc else jhk.affine_ac_decode(peek16, luma, acl,
                                                        acl))
            clen, sym = np.asarray(c, np.int64), np.asarray(s_, np.int64)
            got, _ = _lookup(lut, t, PEEKS)
            assert np.array_equal(got, _want(clen, sym, is_dc))


# --- the kernel's walk -------------------------------------------------------

def _value(peek, clen, adv):
    """direct_value: the adv - clen value bits after the code, the mask of
    their size subtracted where the top one is 0 (a clamped shift gives
    0 bits and a 0 mask when there are none)."""
    x = (peek << clen) & 0xFFFFFFFF
    size = adv - clen
    vu = x >> (32 - size) if size else 0
    return vu if x >> 31 else vu - ((1 << size) - 1)


def _direct_walk(words, nbits, nblocks, dcl, acl, tab, pattern, rng):
    """huffdec_direct_kernel's walk of each row: the DC token from the
    row's first word, then AC tokens from a funnel shift of (hi, lo) at
    bit offset sh, the window moved down a word and the word after loaded
    when sh passes 32; every token through direct_lut's first level, its
    code length, advance and run read from the entry; one branch for a
    second-level entry, an end of block, an error and coefficient 63.
    The kernel reads whatever follows a row in shared memory (the next
    row, or slack) past its W words; here those words are random, and the
    result must still equal the plain decode's, which reads zeros."""
    lut = thd.direct_lut(tab.numpy()).view(np.uint16).astype(np.int64)
    ns = thd.table_sets(tab)
    nseg, W = words.shape
    coefs = np.zeros((64, nseg), np.int64)
    err = np.zeros(nseg, np.int64)
    special, sub = thd.DIRECT_SPECIAL, thd.DIRECT_SUB

    def first(t, peek):
        return int(lut[t, peek >> (32 - K)])

    def second(t, e, peek):
        return int(lut[t, (1 << K) + ((e & 511) << (16 - K))
                       + ((peek >> 16) & ((1 << (16 - K)) - 1))])

    for s in range(nseg):
        if nblocks[s] == 0:
            continue
        row = [int.from_bytes(int(w).to_bytes(4, "little", signed=True),
                              "big") for w in words[s]]
        row += [int(x) for x in rng.integers(0, 1 << 32, W + 3)]
        dc, ac = scan_rows.block_sets(dcl[s], acl[s], pattern, 0, ns)
        ac += ns
        bend = int(nbits[s])
        hi, lo, nx, nxt = row[0], row[1], row[2], 3
        e = first(dc, hi)
        if e & sub:
            e = second(dc, e, hi)
        clen, adv = e & 31, (e >> 5) & 31
        if e & special or adv > bend:
            err[s] = 1
            continue
        coefs[0, s] = _value(hi, clen, adv)
        if adv == bend:
            continue
        rem, sh, k = bend - adv, adv, 1
        while True:
            peek = ((((hi << 32) | lo) << sh) >> 32) & 0xFFFFFFFF
            e = first(ac, peek)
            coef, clen, adv = k + (e >> 12), e & 31, (e >> 5) & 31
            if e & (special | sub) or coef >= 63 or adv > rem:
                if e & sub:
                    e = second(ac, e, peek)
                    coef, clen, adv = k + (e >> 12), e & 31, (e >> 5) & 31
                if adv > rem or coef > 63 or (e & special and clen == 0):
                    err[s] = 1
                    break
                if e & special:
                    break
                if coef == 63:
                    coefs[coef, s] = _value(peek, clen, adv)
                    break
            coefs[coef, s] = _value(peek, clen, adv)
            rem -= adv
            k = coef + 1
            sh += adv
            if sh >= 32:
                sh -= 32
                hi, lo, nx = lo, nx, row[nxt]
                nxt += 1
    return (torch.from_numpy(coefs.astype(np.int16)),
            torch.from_numpy(err.astype(np.int32)))


def _check_walk(words, nbits, nblocks, dcl, acl, tab, pattern, seed=0):
    args = [torch.as_tensor(np.ascontiguousarray(a, np.int32))
            for a in (words, nbits, nblocks, dcl, acl)]
    want = thd.decode_blocks_direct_plain(*args, tab, pattern)
    got = _direct_walk(*(a.numpy() for a in args), tab, pattern,
                       np.random.default_rng(seed))
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    return want


@pytest.mark.parametrize("kind,grey", [("gradient", False), ("noise", False),
                                       ("gradient", True)])
def test_walk_matches_plain_q100(kind, grey):
    """The walk on Q100 streams at the auto interval (one block a
    segment, about 61 tokens a block, long values), a frame of the
    chip smoke's kinds: equal coefficients, no error."""
    rng = np.random.default_rng(7)
    h, w = 32, 48
    if kind == "noise":
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        frame = np.clip(np.stack([xx * 255 // w, yy * 255 // h,
                                  (xx + yy) * 255 // (w + h)], -1)
                        + rng.integers(-24, 25, (h, w, 3)), 0,
                        255).astype(np.uint8)
    if grey:
        frame = np.ascontiguousarray(frame[..., 0])
    data = gt.Encoder(device="cpu").encode(frame, gt.Parameters(
        quality=100, restart_interval=gt.RESTART_AUTO))
    hf = gt.Decoder(device="cpu").prepare(data)
    p = hf.plan
    assert p.direct and p.direct_lut is not None
    assert torch.equal(p.direct_lut, torch.from_numpy(
        thd.direct_lut(p.tables.numpy())))
    coefs, err = _check_walk(hf.words, hf.nbits, p.nblocks.numpy(),
                             p.dc_luma.numpy(), p.ac_luma.numpy(), p.tables,
                             p.pattern)
    assert not err.any() and (coefs != 0).sum(0).float().mean() > 30


@pytest.mark.parametrize("sets", [2, 3, 4])
def test_walk_matches_plain_coded_rows(sets):
    """Coded rows of one block (long codes, two to four table sets picked
    by the segments' selectors, some segments empty): equal coefficients
    and err, no error but in the empty segments."""
    rng = np.random.default_rng(sets)
    ak = scan_rows.annexk_tables()
    tabs = [scan_rows.long_code_tables(sets), ak[1], ak[0],
            scan_rows.long_code_tables(sets + 9)][:sets]
    nseg = 120
    nb = (rng.random(nseg) > 0.05).astype(np.int32)
    wide = sets > 2
    flags = (rng.integers(0, sets if wide else 2, nseg),
             rng.integers(0, sets if wide else 2, nseg))
    pattern = thd.NO_PATTERN_WIDE if wide else thd.NO_PATTERN
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, 1, tabs, pattern, flags, nb, long_share=0.5)
    words, nbits = scan_rows.word_matrix(rows)
    coefs, err = _check_walk(words, nbits, nb, dcl, acl,
                             scan_rows.decode_tables(tabs), pattern, sets)
    assert not err.any() and coefs.abs().sum() > 0


@pytest.mark.parametrize("W", [1, 2, 5])
def test_walk_matches_plain_random_words(W):
    """Random rows (mostly bad tokens: invalid codes, overruns, runs past
    63) with random bit counts in [0, 32 W] and nblocks 0 or 1: equal
    coefficients and err."""
    rng = np.random.default_rng(W)
    nseg = 300
    words = rng.integers(-(1 << 31), 1 << 31, (nseg, W))
    _, err = _check_walk(words, rng.integers(0, 32 * W + 1, nseg),
                         rng.integers(0, 2, nseg), rng.integers(0, 2, nseg),
                         rng.integers(0, 2, nseg),
                         scan_rows.decode_tables(
                             [scan_rows.long_code_tables(W),
                              scan_rows.annexk_tables()[1]]), thd.NO_PATTERN,
                         W)
    assert err.any() and not err.all()


def test_walk_error_kinds():
    """Each error kind of scan_rows.block_error_rows with every block in a
    row of its own, bounded by its length: an invalid code at a DC and
    after a good DC, a DC symbol above 15, a token past the block's end
    at DC and at AC, a run past coefficient 63; a block ending right
    after its DC is good; the segment-row mode's errors."""
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
    ones = np.ones(len(rows), np.int32)
    coefs, err = _check_walk(w, np.asarray(bits), ones, ones, ones, tab,
                             thd.NO_PATTERN)
    assert err.tolist() == keep
    assert coefs[0, 0] == 5 and coefs[1, 0] == 1


# --- three table sets through the routes, against the JAX package -----------

def _gradient(h, w, seed, ch=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  ((xx + yy) * 255 // (w + h))], -1)[..., :ch]
    return np.clip(f + rng.integers(-20, 21, f.shape), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("quality,rst,direct", [(100, gt.RESTART_AUTO, True),
                                                (97, 1, True),
                                                (75, 3, False)])
def test_three_sets_match_jax(quality, rst, direct):
    """A planar 4:4:4 stream rewritten to three table sets
    (scan_rows.three_sets) decodes through the four-set plan, on the
    direct route at Q >= 97 (one block a segment) and through phases A
    and C at Q75, to the JAX package's pixels (its legacy path) and to
    the unmodified stream's, tolerance 0."""
    frame = _gradient(40, 56, quality)
    base = bytes(gj.Encoder().encode(frame, gj.Parameters(
        quality=quality, restart_interval=rst)))
    data = scan_rows.three_sets(base)
    dec = gt.Decoder(device="cpu")
    p = dec.prepare(data).plan
    assert tuple(p.tables.shape) == (8, 290) and p.direct == direct
    assert (p.direct_lut is not None) == direct
    got = dec.decode(data)
    ref = np.asarray(gj.Decoder().decode(data))
    assert got.shape == ref.shape and np.array_equal(got, ref)
    assert np.array_equal(got, dec.decode(base))


def test_token_paths_count_every_token():
    """chip_smoke.token_paths (the token-path counts of the direct route
    that PERF.md reports) on Q100 streams, gradient and noise: its DC and
    AC tokens add up to the tokens of the decoded coefficients
    (chip_smoke.scan_tokens), a DC token a block, and every token is in
    exactly one of fit, window and long, the second-level ones among the
    long."""
    import chip_smoke

    rng = np.random.default_rng(9)
    for frame in (rng.integers(0, 256, (24, 40, 3), dtype=np.uint8),
                  _gradient(24, 40, 9)):
        data = gt.Encoder(device="cpu").encode(frame, gt.Parameters(
            quality=100, restart_interval=gt.RESTART_AUTO))
        hf = gt.Decoder(device="cpu").prepare(data)
        p = hf.plan
        words, nbits = torch.from_numpy(hf.words), torch.from_numpy(hf.nbits)
        got = chip_smoke.token_paths(torch, words, nbits, p)
        coefs, err = thd.decode_blocks_direct(words, nbits, p.nblocks,
                                              p.dc_luma, p.ac_luma, p.tables,
                                              p.pattern)
        assert not err.any()
        assert got["dc"]["tokens"] == got["blocks"] == words.shape[0]
        assert got["dc"]["tokens"] + got["ac"]["tokens"] == \
            chip_smoke.scan_tokens(torch, coefs, p)
        for c in (got["dc"], got["ac"]):
            assert c["fit"] + c["window"] + c["long"] == c["tokens"]
            assert c["second_level"] <= c["long"]
