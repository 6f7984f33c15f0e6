"""PyTorch port, phase C's lookahead table (huffdec_kernel.block_lut): every
entry against the canonical decode (_decode_token) on all 65,536 16-bit
peeks, against a token decode from the canonical codes and against the
JAX package's arithmetic decode of the tuned tables; slow entries for
every code longer than the table's 10 bits; and the CUDA kernel's walk
(table first, the canonical decode on a slow entry, the value from the
entry or from the bit window) replayed here against the plain block
decode (decode_blocks_plain) on coded rows with long codes, slot patterns,
blocks starting at every bit phase and each error kind.  The kernel
itself is held against the plain decode on the card
(tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpujpeg_tpu.ops import huffdec_kernel as jhk
from gpujpeg_tpu.utils import tables as jt

from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from gpujpeg_tpu_torch.utils import tables as tt
from tests import scan_rows
from tests import torch_threads  # noqa: F401

K = thd.BLOCK_LUT_BITS
PEEKS = torch.arange(1 << 16, dtype=torch.int64)


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
}


def _fields(e):
    """(advance, code length, run, eob, fits, value) of entries (int64)."""
    e = np.asarray(e, np.int64)
    value = (e >> 16) & 0xFFFF
    value = np.where(value >= 1 << 15, value - (1 << 16), value)
    return (e & 31, (e >> 5) & 31, (e >> 10) & 15, (e >> 14) & 1,
            (e >> 15) & 1, value)


def _value(bits, size):
    """Sign-extended value of `size` value bits (T.81 F.2.2.1)."""
    bits, size = np.asarray(bits, np.int64), np.asarray(size, np.int64)
    half = np.where(size > 0, 1 << np.maximum(size - 1, 0), 1)
    v = np.where(bits < half, bits - (1 << size) + 1, bits)
    return np.where(size > 0, v, 0)


@pytest.mark.parametrize("name", list(TABLES))
def test_lut_matches_canonical_decode(name):
    """Over all 65,536 16-bit peeks: an entry is nonzero exactly where the
    canonical decode (_decode_token, the kernel's slow path) finds a valid
    code of 1..K bits (and, for DC, a symbol of at most 15); its fields
    are that token's, and it holds the token's value exactly where code
    and value bits lie within the K bits."""
    tab = scan_rows.decode_tables(TABLES[name]())
    lut = thd.block_lut(tab.numpy())
    assert lut.shape == (4, 1 << K) and lut.dtype == np.int32
    peeks = PEEKS.numpy()
    for t in range(4):
        is_dc = t < 2
        clen, sym = (x.numpy() for x in thd._decode_token(
            tab.to(torch.int64), torch.full_like(PEEKS, t), PEEKS))
        e = lut[t][peeks >> (16 - K)].astype(np.int64)
        fast = (clen >= 1) & (clen <= K) & ((sym <= 15) | (not is_dc))
        assert np.array_equal(e != 0, fast), t
        adv, cl, run, eob, fits, value = _fields(e)
        size = sym & 15
        assert np.array_equal(adv[fast], (clen + size)[fast])
        assert np.array_equal(cl[fast], clen[fast])
        assert np.array_equal(run[fast], (sym >> 4)[fast])
        assert np.array_equal(eob[fast] == 1, ((sym == 0) & (not is_dc))[fast])
        fit = fast & (clen + size <= K)
        assert np.array_equal(fits == 1, fit)
        vbits = (peeks >> np.maximum(16 - clen - size, 0)) \
            & ((1 << size) - 1)
        assert np.array_equal(value[fit], _value(vbits, size)[fit])
        assert not value[~fit].any()
        assert np.array_equal(
            e[fast], thd.block_entry(clen, sym, is_dc,
                                     np.where(fit, _value(vbits, size), 0),
                                     fit)[fast].astype(np.uint32)
            .view(np.int32).astype(np.int64)), t


def _codes(dht):
    syms, lens, codes = tt.huffman_canonical(*dht)
    return {(int(l), int(c)): int(s) for s, l, c in zip(syms, lens, codes)}


@pytest.mark.parametrize("name", ["tuned_q75", "long_codes",
                                  "dc_big_symbols"])
def test_lut_matches_canonical_codes(name):
    """Every entry equals the token of its K bits decoded from the
    canonical codes (tables.huffman_canonical, independent of the decode
    tables), with its value where code and value bits fit."""
    (d0, a0), (d1, a1) = TABLES[name]()
    lut = thd.block_lut(thd.decode_tables(d0, d1, a0, a1)).astype(np.int64)
    for t, dht in enumerate((d0, d1, a0, a1)):
        codes = _codes(dht)
        for p in range(1 << K):
            hit = next(((l, codes[(l, p >> (K - l))]) for l in range(1, K + 1)
                        if (l, p >> (K - l)) in codes), None)
            if hit is None or (t < 2 and hit[1] > 15):
                assert lut[t, p] == 0, (t, p)
                continue
            l, sym = hit
            size = sym & 15
            fits = l + size <= K
            v = int(_value((p >> (K - l - size)) & ((1 << size) - 1), size)) \
                if fits else 0
            want = thd.block_entry(l, sym, t < 2, v, fits) & 0xFFFFFFFF
            assert lut[t, p] & 0xFFFFFFFF == want, (t, p)


@pytest.mark.parametrize("name", list(TABLES))
def test_lut_slow_for_every_long_code(name):
    """The K-bit prefix of every canonical code longer than K bits has a
    slow entry, and every code of up to K bits a fast one (but a DC
    symbol above 15) at each of its extensions."""
    sets = TABLES[name]()
    lut = thd.block_lut(scan_rows.decode_tables(sets).numpy())
    (d0, a0), (d1, a1) = sets
    for t, dht in enumerate((d0, d1, a0, a1)):
        syms, lens, codes = tt.huffman_canonical(*dht)
        for sym, l, code in zip(syms, lens, codes):
            l, code = int(l), int(code)
            if l > K:
                assert lut[t][code >> (l - K)] == 0, (t, hex(sym), l)
            else:
                for ext in (0, (1 << (K - l)) - 1):
                    e = int(lut[t][(code << (K - l)) | ext])
                    assert (e == 0) == (t < 2 and sym > 15), (t, hex(sym))


@pytest.mark.parametrize("quality", [10, 75, 100])
def test_lut_matches_jax_affine_decode(quality):
    """The entries of the tuned tables, rebuilt from the JAX package's
    arithmetic decode of each K-bit prefix (affine_ac_decode,
    dc_identity_decode), equal block_lut's."""
    prefix = np.arange(1 << K, dtype=np.int64)
    for luma in (True, False):
        bits, vals = tt.ac_spec(luma, quality)
        acl = jt.affine_ac_decode_runtime(*jt.match_affine_ac(bits, vals))
        dbits, dvals = tt.huffman_spec_for("dc", luma)
        mono, roff = jhk.dc_decode_runtime(dbits, dvals)
        lut = thd.block_lut(thd.decode_tables(
            (dbits, dvals), (dbits, dvals), (bits, vals), (bits, vals)))
        peek16 = jnp.asarray(prefix << (16 - K), jnp.int32)
        for t, is_dc in ((0, True), (2, False)):
            c, s_ = (jhk.dc_identity_decode(peek16, luma, mono, mono, roff,
                                            roff)
                     if is_dc else jhk.affine_ac_decode(peek16, luma, acl,
                                                        acl))
            clen, sym = np.asarray(c, np.int64), np.asarray(s_, np.int64)
            size = sym & 15
            fast = (clen >= 1) & (clen <= K) & ((sym <= 15) | (not is_dc))
            fits = fast & (clen + size <= K)
            vbits = (prefix >> np.maximum(K - clen - size, 0)) \
                & ((1 << size) - 1)
            want = np.where(fast, thd.block_entry(
                clen, sym, is_dc, np.where(fits, _value(vbits, size), 0),
                fits), 0)
            assert fits.mean() > 0.8
            assert np.array_equal(lut[t].astype(np.int64) & 0xFFFFFFFF,
                                  want & 0xFFFFFFFF)


# --- the kernel's walk -------------------------------------------------------

def _kernel_walk(words, bstart, nblocks, dcl, acl, tab, pattern):
    """huffdec_block.cu's walk, one block after another: the entry of the
    next K bits, the canonical decode where it is 0 (a DC symbol above 15
    is bad there), the value from the entry or from the window, one check
    of the cursor against the block's end and one of the coefficient
    index; a block ends after its DC when its bits end there, at an EOB
    or at coefficient 63."""
    lut = thd.block_lut(tab.numpy()).astype(np.int64) & 0xFFFFFFFF
    t64 = tab.to(torch.int64)
    bpm = pattern[0]
    ns = thd.table_sets(tab)
    nseg, W = words.shape
    bps = bstart.shape[1] - 1
    total = 32 * W
    coefs = np.zeros((64, nseg * bps), np.int64)
    err = np.zeros(nseg * bps, np.int64)
    for s in range(nseg):
        row = int.from_bytes(words[s].numpy().astype("<u4").tobytes(),
                             "big") << 64         # zeros past the row

        def peek(c, n):
            return (row >> (total + 64 - c - n)) & ((1 << n) - 1)

        def token(cls, cursor, is_dc):
            e = int(lut[cls, peek(cursor, K)])
            if e == 0:
                clen, sym = (int(x) for x in thd._decode_token(
                    t64, torch.tensor([cls]),
                    torch.tensor([peek(cursor, 16)])))
                if clen == 0 or (is_dc and sym > 15):
                    return None
                e = int(thd.block_entry(clen, sym, is_dc))
            adv, clen = e & 31, (e >> 5) & 31
            if e & thd.BLOCK_FIT:
                v = ((e >> 16) ^ 0x8000) - 0x8000
            else:
                size = adv - clen
                v = int(_value(peek(cursor + clen, size) if size else 0,
                               size))
            return e, adv, v

        for j in range(int(nblocks[s])):
            b = s * bps + j
            dc, ac = scan_rows.block_sets(dcl[s], acl[s], pattern, j % bpm,
                                          ns)
            ac += ns
            cursor, bend = int(bstart[s, j]), int(bstart[s, j + 1])
            tok = token(dc, cursor, True)
            if tok is None or cursor + tok[1] > bend:
                err[b] = 1
                continue
            coefs[0, b] = tok[2]
            cursor += tok[1]
            pos = 1
            while cursor < bend or pos > 1:   # no AC token when DC ends it
                tok = token(ac, cursor, False)
                if tok is None:
                    err[b] = 1
                    break
                e, adv, v = tok
                coef = pos + ((e >> 10) & 15)
                if cursor + adv > bend or coef > 63:
                    err[b] = 1
                    break
                if v:
                    coefs[coef, b] = v
                if e & (1 << 14) or coef == 63:
                    break
                cursor += adv
                pos = coef + 1
    return (torch.from_numpy(coefs.astype(np.int16)),
            torch.from_numpy(err.astype(np.int32)))


def _check_walk(words, bstart, nblocks, dcl, acl, tab, pattern):
    args = [torch.as_tensor(np.ascontiguousarray(a, np.int32))
            for a in (words, bstart, nblocks, dcl, acl)]
    want = thd.decode_blocks_plain(*args, tab, pattern)
    got = _kernel_walk(*args, tab, pattern)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    return want


def _rows(seed, nseg, bps, pattern, long_share=0.5, **kw):
    """Coded rows (long codes in set 0, Annex-K chroma in set 1) with
    random segment flags and block counts, and phase A's bstart of them:
    (words, bstart, nblocks, dc_luma, ac_luma, tab)."""
    rng = np.random.default_rng(seed)
    tabs = [scan_rows.long_code_tables(seed), scan_rows.annexk_tables()[1]]
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern,
        (rng.integers(0, 2, nseg), rng.integers(0, 2, nseg)),
        kw.pop("nblocks", rng.integers(0, bps + 1, nseg)),
        long_share=long_share, **kw)
    words, nbits = scan_rows.word_matrix(rows)
    tab = scan_rows.decode_tables(tabs)
    bstart, err = thd.scan_segments_plain(
        *(torch.from_numpy(np.asarray(a, np.int32))
          for a in (words, nbits, nb, dcl, acl)), tab, bps, pattern)
    return words, bstart.numpy(), nb, dcl, acl, tab, err


@pytest.mark.parametrize("bpm,seed", [(1, 0), (3, 1), (6, 2), (10, 3)])
def test_kernel_walk_matches_plain(bpm, seed):
    """Coded rows with long codes and values that do not fit the table,
    slot patterns of 1-10 slots, ragged nblocks: equal coefficients and
    err, no error on the intact rows, blocks starting at every bit phase
    of a word."""
    rng = np.random.default_rng(seed)
    pattern = (bpm, int(rng.integers(0, 1 << bpm)),
               int(rng.integers(0, 1 << bpm)))
    words, bstart, nb, dcl, acl, tab, err_a = _rows(seed, 16, 2 * bpm,
                                                    pattern)
    assert not err_a.any()
    coefs, err = _check_walk(words, bstart, nb, dcl, acl, tab, pattern)
    assert not err.any() and coefs.abs().sum() > 0
    # every bit phase of a word, on the rows of the 4-slot pattern
    if bpm == 3:
        starts = [int(bstart[s, j]) & 31 for s in range(len(nb))
                  for j in range(int(nb[s]))]
        words, bstart, nb, dcl, acl, tab, _ = _rows(11, 40, 8, pattern)
        starts += [int(bstart[s, j]) & 31 for s in range(len(nb))
                   for j in range(int(nb[s]))]
        _check_walk(words, bstart, nb, dcl, acl, tab, pattern)
        assert set(starts) == set(range(32))


def test_kernel_walk_error_kinds():
    """Each error kind against the plain decode (scan_rows.
    block_error_rows): an invalid code at a DC and after a good DC, a DC
    symbol above 15, a token past the block's end (at DC and at AC), a
    run past coefficient 63; a block whose bits end right after its DC
    (good) and slots past nblocks (zero, err 0)."""
    words, bstart, nb, tab, want = scan_rows.block_error_rows()
    ones = np.ones(len(nb), np.int32)
    coefs, err = _check_walk(words, bstart, nb, ones, ones, tab,
                             thd.NO_PATTERN)
    assert err.view(len(nb), 3).tolist() == want
    assert coefs[0, 0] == 5 and coefs[1, 0] == 1 and coefs[0, 4] == 5
    assert not coefs[:, 2].any() and not coefs[:, 5].any()


def test_kernel_walk_shifted_starts():
    """Blocks started a few bits off phase A's boundaries (the decode of
    garbage: invalid codes, overruns, runs past 63 at every phase) on
    rows with long codes: equal coefficients and err."""
    pattern = (4, 0b0101, 0b0011)
    words, bstart, nb, dcl, acl, tab, _ = _rows(5, 24, 8, pattern)
    rng = np.random.default_rng(5)
    shifted = bstart.copy()
    shifted[:, :-1] += rng.integers(-3, 4, shifted[:, :-1].shape)
    shifted = np.clip(shifted, 0, 32 * words.shape[1])
    _, err = _check_walk(words, shifted, nb, dcl, acl, tab, pattern)
    assert err.any() and not err.all()
