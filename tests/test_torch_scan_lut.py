"""PyTorch port, phase A's lookahead table (huffdec_kernel.scan_lut): every
entry against a token-by-token decode from the canonical codes, against
the canonical decode (_decode_token) on all 65,536 16-bit peeks and
against the JAX package's arithmetic decode of the tuned tables; slow
entries for every code longer than the table's 11 bits; and the CUDA
kernel's walk (table first, one token from the canonical decode on a
slow entry or a step past position 64, one fused position check)
replayed here against the plain scan (scan_segments_plain) on coded rows
with long codes, slot patterns and each error kind.  The kernel itself
is held against the plain scan on the card
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

K = thd.SCAN_LUT_BITS
PEEKS = torch.arange(1 << 16, dtype=torch.int64)


def _tuned(quality):
    out = []
    for luma in (True, False):
        out.append((tt.huffman_spec_for("dc", luma), tt.ac_spec(luma,
                                                                quality)))
    return out


def _annexk():
    return [(tt.huffman_spec_for("dc", luma), tt.huffman_spec_for("ac", luma))
            for luma in (True, False)]


TABLES = {
    **{f"tuned_q{q}": (lambda q=q: _tuned(q)) for q in (10, 50, 75, 90, 100)},
    "annexk": _annexk,
    "long_codes": lambda: [scan_rows.long_code_tables(1), _annexk()[1]],
}


def _decode_all(tab, t):
    clen, sym = thd._decode_token(tab.to(torch.int64),
                                  torch.full_like(PEEKS, t), PEEKS)
    return clen.numpy(), sym.numpy()


def _ref_entry(p, codes, is_dc):
    """The entry of K-bit prefix p, decoded token by token from the
    canonical codes ({(length, code): symbol}): the tokens whose codes lie
    inside the K bits, summed; stops after an EOB, before a step sum past
    63, and where no code fits."""
    adv = step = count = eob = 0
    while count < (1 if is_dc else K) and adv < K:
        hit = next(((l, codes[(l, (p >> (K - adv - l)) & ((1 << l) - 1))])
                    for l in range(1, K - adv + 1)
                    if (l, (p >> (K - adv - l)) & ((1 << l) - 1)) in codes),
                   None)
        if hit is None:
            break
        l, sym = hit
        inc = 1 if is_dc else (sym >> 4) + 1
        if step + inc > 63:
            break
        adv, step, count = adv + l + (sym & 15), step + inc, count + 1
        eob = int(not is_dc and sym == 0)
        if eob:
            break
    return adv | (step << 5) | (eob << 11) if count else 0


def _codes(dht):
    syms, lens, codes = tt.huffman_canonical(*dht)
    return {(int(l), int(c)): int(s) for s, l, c in zip(syms, lens, codes)}


@pytest.mark.parametrize("name", list(TABLES))
def test_lut_matches_canonical_codes(name):
    """Every entry equals the token-by-token decode of its K bits from the
    canonical codes (tables.huffman_canonical, independent of the decode
    tables); a DC entry is one token."""
    (d0, a0), (d1, a1) = TABLES[name]()
    lut = thd.scan_lut(thd.decode_tables(d0, d1, a0, a1))
    assert lut.shape == (4, 1 << K) and lut.dtype == np.int16
    for t, dht in enumerate((d0, d1, a0, a1)):
        codes = _codes(dht)
        want = [_ref_entry(p, codes, t < 2) for p in range(1 << K)]
        assert lut[t].tolist() == want, t


@pytest.mark.parametrize("name", list(TABLES))
def test_lut_fast_where_first_code_fits(name):
    """Over all 65,536 16-bit peeks: an entry is nonzero exactly where the
    canonical decode (_decode_token, the kernels' slow path) finds a valid
    code of 1..K bits, and a DC entry is that token's scan_entry."""
    tab = scan_rows.decode_tables(TABLES[name]())
    lut = thd.scan_lut(tab.numpy())
    for t in range(4):
        clen, sym = _decode_all(tab, t)
        e = lut[t][PEEKS.numpy() >> (16 - K)].astype(np.int64)
        assert np.array_equal(e != 0, (clen >= 1) & (clen <= K))
        if t < 2:
            fast = e != 0
            assert np.array_equal(e[fast],
                                  thd.scan_entry(clen, sym, True)[fast])


@pytest.mark.parametrize("name", list(TABLES))
def test_lut_slow_for_every_long_code(name):
    """The K-bit prefix of every canonical code longer than K bits has a
    slow entry, and that of every shorter code a fast one whose advance
    covers the code and its value bits."""
    sets = TABLES[name]()
    tab = scan_rows.decode_tables(sets)
    lut = thd.scan_lut(tab.numpy())
    (d0, a0), (d1, a1) = sets
    longs = 0
    for t, dht in enumerate((d0, d1, a0, a1)):
        syms, lens, codes = tt.huffman_canonical(*dht)
        for sym, l, code in zip(syms, lens, codes):
            l, code = int(l), int(code)
            if l > K:
                assert lut[t][code >> (l - K)] == 0, (t, hex(sym), l)
                longs += 1
            else:
                for ext in (0, (1 << (K - l)) - 1):
                    e = int(lut[t][(code << (K - l)) | ext])
                    assert e & 31 >= l + (int(sym) & 15), (t, hex(sym))
    assert longs > 0


@pytest.mark.parametrize("name", list(TABLES))
def test_lut_one_token_entries(name):
    """Every fast entry starts with the token that the canonical decode
    (_decode_token, the kernel's slow path) reads at its peek, and holds
    that token alone where nothing can follow it (an EOB, or bits past the
    K of the entry): the kernel, sending the first token alone through
    the canonical decode when an entry's step passes 64, walks the same
    tokens."""
    tab = scan_rows.decode_tables(TABLES[name]())
    lut = thd.scan_lut(tab.numpy())
    for t in range(4):
        clen, sym = _decode_all(tab, t)
        e = lut[t][PEEKS.numpy() >> (16 - K)].astype(np.int64)
        fast = e != 0
        first = thd.scan_entry(clen, sym, t < 2)
        assert np.all((e & 31)[fast] >= (first & 31)[fast])
        assert np.all((e >> 5 & 63)[fast] >= (first >> 5 & 63)[fast])
        alone = fast & (((first >> 11) & 1 == 1) | ((first & 31) >= K))
        assert alone.any()
        assert np.array_equal(e[alone], first[alone])


@pytest.mark.parametrize("quality", [10, 75, 100])
def test_lut_matches_jax_affine_decode(quality):
    """The entries of the tuned tables, rebuilt token by token from the JAX
    package's arithmetic decode of the remaining bits (affine_ac_decode,
    dc_identity_decode), equal scan_lut's."""
    prefix = np.arange(1 << K, dtype=np.int64)
    for luma in (True, False):
        bits, vals = tt.ac_spec(luma, quality)
        acl = jt.affine_ac_decode_runtime(*jt.match_affine_ac(bits, vals))
        dbits, dvals = tt.huffman_spec_for("dc", luma)
        mono, roff = jhk.dc_decode_runtime(dbits, dvals)
        lut = thd.scan_lut(thd.decode_tables(
            (dbits, dvals), (dbits, dvals), (bits, vals), (bits, vals)))

        def jdec(peek16, is_dc):
            p = jnp.asarray(peek16, jnp.int32)
            c, s_ = (jhk.dc_identity_decode(p, luma, mono, mono, roff, roff)
                     if is_dc else jhk.affine_ac_decode(p, luma, acl, acl))
            return np.asarray(c, np.int64), np.asarray(s_, np.int64)

        for t, is_dc in ((0, True), (2, False)):
            adv = np.zeros(1 << K, np.int64)
            step = np.zeros_like(adv)
            eob = np.zeros_like(adv)
            count = np.zeros_like(adv)
            live = np.ones(1 << K, bool)
            for _ in range(1 if is_dc else K):
                peek16 = ((prefix << np.minimum(adv, K)) & ((1 << K) - 1)) \
                    << (16 - K)
                clen, sym = jdec(peek16, is_dc)
                inc = 1 if is_dc else (sym >> 4) + 1
                ok = (live & (clen >= 1) & (clen <= K - adv)
                      & (step + inc <= 63))
                adv = np.where(ok, adv + clen + (sym & 15), adv)
                step = np.where(ok, step + inc, step)
                end = ok & (sym == 0) & (not is_dc)
                eob = np.where(ok, end, eob)
                count += ok
                live = ok & ~end & (adv < K)
            want = np.where(count > 0, adv | (step << 5) | (eob << 11), 0)
            assert (want != 0).mean() > 0.9
            assert np.array_equal(lut[t].astype(np.int64), want)


def _kernel_walk(words, nbits, nblocks, dcl, acl, tab, bps, pattern):
    """huffdec_scan.cu's walk, one segment after another: the entry of
    the next K bits; one token from the canonical decode where the entry
    is slow or its step would pass position 64; one position check; a
    block ends at an entry's EOB or at position 64."""
    lut = thd.scan_lut(tab.numpy()).astype(np.int64)
    t64 = tab.to(torch.int64)
    bpm = pattern[0]
    ns = thd.table_sets(tab)
    nseg, W = words.shape
    total = 32 * W
    bstart = np.zeros((nseg, bps + 1), np.int64)
    err = np.zeros(nseg, bool)
    for s in range(nseg):
        row = int.from_bytes(words[s].numpy().astype("<u4").tobytes(),
                             "big") << 64         # zeros past the row

        def peek(c, n):
            return (row >> (total + 64 - c - n)) & ((1 << n) - 1)

        cursor = blk = pos = slot = 0
        bad = False
        while blk < int(nblocks[s]):
            is_dc = pos == 0
            dset, aset = scan_rows.block_sets(dcl[s], acl[s], pattern, slot,
                                              ns)
            cls = dset if is_dc else ns + aset
            e = int(lut[cls, peek(cursor, K)])
            new_pos = pos + ((e >> 5) & 63)
            if e == 0 or new_pos > 64:
                clen, sym = thd._decode_token(
                    t64, torch.tensor([cls]), torch.tensor([peek(cursor,
                                                                 16)]))
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
            else:
                pos = new_pos
        bstart[s, blk + 1:] = int(nbits[s])
        err[s] = bad or blk < int(nblocks[s])
    return torch.from_numpy(bstart.astype(np.int32)), torch.from_numpy(err)


def _check_walk(words, nbits, nblocks, dcl, acl, tab, bps, pattern):
    args = [torch.as_tensor(a) for a in (words, nbits, nblocks, dcl, acl)]
    want = thd.scan_segments_plain(*args, tab, bps, pattern)
    got = _kernel_walk(*args, tab, bps, pattern)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return want


@pytest.mark.parametrize("bpm,seed", [(1, 0), (3, 1), (6, 2), (10, 3)])
def test_kernel_walk_matches_plain(bpm, seed):
    """Coded rows with long codes in set 0 and Annex-K in set 1, slot
    patterns of 1-10 slots, rows of every length: equal bstart and err,
    and no error on the intact rows."""
    rng = np.random.default_rng(seed)
    tabs = [scan_rows.long_code_tables(seed), _annexk()[1]]
    nseg, bps = 12, 2 * bpm
    pattern = (bpm, int(rng.integers(0, 1 << bpm)),
               int(rng.integers(0, 1 << bpm)))
    flags = (rng.integers(0, 2, nseg), rng.integers(0, 2, nseg))
    nblocks = rng.integers(0, bps + 1, nseg)
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern, flags, nblocks, long_share=0.5)
    words, nbits = scan_rows.word_matrix(rows)
    _, err = _check_walk(words, nbits, nb, dcl, acl,
                         scan_rows.decode_tables(tabs), bps, pattern)
    assert not err.any()


def test_kernel_walk_error_kinds():
    """Each error kind: an invalid code, bits past nbits, a run past
    coefficient 63, a segment short of its blocks; and empty segments."""
    rng = np.random.default_rng(7)
    tabs = [scan_rows.long_code_tables(7), _annexk()[1]]
    nseg, bps = 10, 4
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, bps, tabs, bad_run=(3,))
    words, nbits = scan_rows.word_matrix(rows, W=max(len(r) for r in rows)
                                         // 4 + 3)
    words[1, 0] = -1                    # 32 one bits: no valid code
    nbits[2] -= 9                       # the last token ends past nbits
    nb[4] = bps + 1                     # one block more than coded
    words[5], nbits[5], nb[5] = 0, 0, 0  # empty and expected so
    nbits[6], nb[6] = 0, 1              # empty, one block expected
    tab = scan_rows.decode_tables(tabs)
    bstart, err = _check_walk(words, nbits, nb, dcl, acl, tab, bps + 1,
                              thd.NO_PATTERN)
    assert err.tolist() == [False, True, True, True, True, False, True,
                            False, False, False]
    assert bstart[5].tolist() == [0] * (bps + 2)
