"""Huffman decode of restart segments: phase A (block boundaries) and phase
C (coefficients), the decoder's two entropy kernels.

Counterparts of the JAX package's Pallas kernels in
gpujpeg_tpu.ops.huffdec_kernel:

  scan_segments   csrc/huffdec_scan.cu   _scan_kernel_body (phase A;
                                         two instances, scan_instance)
  decode_blocks   csrc/huffdec_block.cu  _block_kernel_body, segment-row
                                         mode (with_cursor=True)
  decode_blocks_  csrc/huffdec_block.cu  _block_kernel_body, buffer mode
    direct        (the direct instance,  (with_cursor=False), the JAX
                  a kernel of its own)   decoder's _decode_direct

decode_blocks_direct is phase C for scans of one block a restart segment:
the segment row is the block's buffer, decoded from bit 0 up to the
segment's byte-aligned bit count, with no phase A before it.

The JAX package's default path splits every segment row into per-block
buffers between the two phases (phase B, huffdec2.make_split_fn) with a
grow-and-retry capacity protocol.  The port takes the segment-row
contract instead: a block decodes straight out of its segment's row, from
phase A's bit cursor to the next boundary, which costs nothing on the
card (a thread indexes its segment's row).  Phase B and its capacities do
not exist here; the coefficients are the same.

Both kernels take canonical tables (tables.kernel_decode_table) of two
or of four table sets, stacked as (2 * nsets, DECODE_TABLE_WORDS) int32:
the nsets DC tables, then the nsets AC tables.  A block's DC and AC table
comes from its segment's selectors (dc_sel, ac_sel) and field j % bpm of
the slot pattern (bpm, dc mask, ac mask) for its slot j in the segment:

  two sets (4 tables, DC luma, DC chroma, AC luma, AC chroma): a selector
      is a luma flag and a mask holds a bit a slot; the block takes set
      0 ("luma") when both are set, else set 1.  A non-interleaved scan
      passes the pattern (1, 1, 1), so the segment's flag decides; an
      interleaved scan passes flags 1 and the classes of one MCU's
      blocks, as the JAX kernels' luma_patterns (scan) and per-block
      class rows (segment-row block kernel);
  four sets (8 tables; T.81 allows table ids 0-3 a class): a selector is
      a table index and a mask holds 2 bits a slot (slot j at bits 2j and
      2j + 1); the block takes set selector + field.  A non-interleaved
      scan passes each segment's index with the pattern (1, 0, 0); an
      interleaved scan passes selectors 0 and one MCU's indices.  Streams
      with more than two sets take this mode (the JAX package decodes
      them on its legacy path, gpujpeg_tpu.models.decoder._decode_legacy).

The canonical decode takes any baseline DHT table (libjpeg's,
Annex K, optimised ones: the JAX package's "generic" kernel mode,
pack_decode_tables); for the tuned AC family with identity DC values it
gives the same (code length, symbol) as the JAX package's arithmetic
decode (affine_ac_decode / dc_identity_decode) on every 16-bit peek,
invalid codes included (code length 0); tests/test_torch_huffdec.py
checks all 65,536 peeks.  Each kernel also takes a lookahead table built here from
the canonical tables: phase A's scan_lut (the tokens inside the next 11
bits, summed) and phase C's block_lut (one token of the next 9 bits
with its value where the value bits fit too); what a table cannot
resolve the kernel decodes from the canonical tables.  The direct
instance reads every token through direct_lut, a two-level table that
resolves every code of a 16-bit peek, and no canonical table.
tests/test_torch_scan_lut.py, tests/test_torch_block_lut.py and
tests/test_torch_direct_lut.py hold every entry against independent
decodes.

Words are the host-order rows of stream/segments.pack_segments_matrix
(stream byte k is byte k of the row) as int32; the kernels and the plain
versions byteswap a word as they load it, and read zeros past the row.
Every bit a token commits is checked against the segment's bit count (or
the block's end), so bytes past a segment's data never reach a result.

For CPU tensors each wrapper runs its plain version below, which repeats
the kernel's arithmetic vectorised over segments (phase A) or blocks
(phase C); for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import tables
from . import _kernels

#: phase A's sync instance (csrc/huffdec_scan.cu; the same constants
#: there): a CTA walks SYNC_THREADS subsequences, a thread each, the first
#: SYNC_WARM replaying the previous chunk's last ones; its scratch is
#: SYNC_SCRATCH_HEAD words (the ticket) and a look-back record of
#: SYNC_REC_WORDS words a chunk
SYNC_THREADS = 256
SYNC_WARM = 8
SYNC_REC_WORDS = 16
SYNC_SCRATCH_HEAD = 16
#: (bits a subsequence, bits a guessed walk starts before it) of a scan
#: of one component, and of an interleaved scan (sync_schedule)
SYNC_SCHEDULE = (512, 512)
SYNC_SCHEDULE_PATTERN = (4096, 4096)

#: scan_instance takes the sync instance for rows of at least this many
#: words (PERF.md, phase A: at 8K Q75 the two instances tie near 700 words
#: a row in planar 4:4:4 and the sync one wins from about 1,600 in il
#: 4:2:0)
SYNC_MIN_WORDS = 1024

#: phase C decodes at most this many AC tokens per block (63 AC + slack),
#: as the JAX package's block kernel (huffdec_kernel.MAX_AC_STEPS)
MAX_AC_STEPS = 66

_MONO, _VALOFF, _HUFFVAL = 0, 17, 34

#: the slot pattern (bpm, dc mask, ac mask) of a non-interleaved scan: the
#: segment's flags alone decide a block's classes
NO_PATTERN = (1, 1, 1)

#: the same with four table sets: the segment's table indices alone
NO_PATTERN_WIDE = (1, 0, 0)

#: phase A's lookahead table is indexed by the next SCAN_LUT_BITS bits
SCAN_LUT_BITS = 11

#: phase C's lookahead table is indexed by the next BLOCK_LUT_BITS bits
BLOCK_LUT_BITS = 9

#: block_entry's fields: bits 0-4 the advance (code plus value bits),
#: 5-9 the code length, 10-13 the run, bit 14 an AC end of block, bit 15
#: "the value is in bits 16-31" (a signed 16-bit value)
BLOCK_FIT = 1 << 15

#: the direct instance's table (direct_lut) is indexed by the next
#: DIRECT_LUT_BITS bits, then, for a longer or mixed prefix, by the
#: 16 - DIRECT_LUT_BITS bits after them
DIRECT_LUT_BITS = 11

#: direct_entry's fields: bits 0-4 the code length, 5-9 the advance (code
#: plus value bits), 12-15 the run; DIRECT_SPECIAL marks an AC end of
#: block, and with code length 0 an invalid code or a DC symbol above 15
#: (the entry DIRECT_SPECIAL itself); DIRECT_SUB marks a first-level entry
#: whose bits 0-8 index its second-level table
DIRECT_SPECIAL = 1 << 10
DIRECT_SUB = 1 << 11


def decode_tables(*tabs) -> np.ndarray:
    """(n, DECODE_TABLE_WORDS) int32 from n (bits, values) DHT tables: the
    DC tables of the sets, then their AC tables, two or four of each (DC
    luma, DC chroma, AC luma, AC chroma for two sets)."""
    if len(tabs) not in (4, 8):
        raise ValueError("decode_tables takes the DC and AC tables of two "
                         "or four sets")
    return np.stack([tables.kernel_decode_table(*t) for t in tabs])


def table_sets(tab) -> int:
    """Table sets of a stack of decode tables (2 or 4)."""
    return tab.shape[0] // 2


def scan_entry(clen, sym, is_dc):
    """Phase A's summary of one decoded token (numpy or torch integers),
    the layout of a lookahead-table entry: bits 0-4 the cursor's advance
    (code plus value bits), bits 5-10 the step of the block position (1
    for a DC token, run + 1 for an AC token; a ZRL is run 15), bit 11 an
    AC end of block.  Never 0 for a valid code."""
    inc = 1 if is_dc else (sym >> 4) + 1
    eob = 0 if is_dc else (sym == 0) * 1
    return (clen + (sym & 15)) | (inc << 5) | (eob << 11)


def scan_lut(tab: np.ndarray) -> np.ndarray:
    """Phase A's lookahead table of the canonical tables `tab` (n,
    DECODE_TABLE_WORDS), n = 4 or 8 (decode_tables): (n, 1 <<
    SCAN_LUT_BITS) int16 of scan_entry layout, indexed by table and by the
    next K = SCAN_LUT_BITS bits of the row.

    A DC entry summarises the one token whose code lies within the K bits
    (_decode_token).  An AC entry sums the tokens that follow one another
    inside the K bits: every token's code lies within the K bits and so
    does every bit before it, the last may take its value bits past them;
    it stops after an end of block, before a token that would take the
    step past 63, and where the next code does not fit.  Its advance is
    then the bits of all of them, its step the sum of their steps, and
    its EOB bit that of the last.  An entry is 0 ("slow") where the first
    code does not fit in K bits or is invalid; the kernel decodes such a
    token from the canonical table, and so it does the first token alone
    when an entry's step would pass position 64 (a block that ends inside
    the entry, or an error).

    A pure function of the tables; the decoder caches it on its plan
    (models/decoder.Plan.scan_lut)."""
    K = SCAN_LUT_BITS
    t64 = torch.from_numpy(np.asarray(tab, np.int64))
    prefix = np.arange(1 << K, dtype=np.int64)
    nt = t64.shape[0]
    out = np.zeros((nt, 1 << K), np.int16)
    for t in range(nt):
        is_dc = t < nt // 2
        adv = np.zeros(1 << K, np.int64)
        step = np.zeros_like(adv)
        eob = np.zeros_like(adv)
        count = np.zeros_like(adv)
        live = np.ones(1 << K, bool)
        for _ in range(1 if is_dc else K):   # a token takes a bit or more
            # the bits after `adv`, left-aligned, zeros past the K bits
            peek16 = ((prefix << np.minimum(adv, K)) & ((1 << K) - 1)) \
                << (16 - K)
            clen, sym = (x.numpy() for x in _decode_token(
                t64, torch.full((1 << K,), t, dtype=torch.int64),
                torch.from_numpy(peek16)))
            inc = 1 if is_dc else (sym >> 4) + 1
            ok = (live & (clen >= 1) & (clen <= K - adv)
                  & (step + inc <= 63))
            adv = np.where(ok, adv + clen + (sym & 15), adv)
            step = np.where(ok, step + inc, step)
            end = ok & (sym == 0) & (not is_dc)
            eob = np.where(ok, end, eob)
            count += ok
            live = ok & ~end & (adv < K)
        out[t] = np.where(count > 0, adv | (step << 5) | (eob << 11), 0)
    return out


def block_entry(clen, sym, is_dc, value=0, fits=False):
    """Phase C's summary of one decoded token (numpy or torch integers), the
    layout of a block_lut entry (BLOCK_FIT's fields): the advance clen +
    size, the code length, the run, an AC end of block and, where `fits`,
    the token's sign-extended value.  Never 0 for a valid code."""
    eob = 0 if is_dc else (sym == 0) * 1
    return ((clen + (sym & 15)) | (clen << 5) | ((sym >> 4) << 10)
            | (eob << 14) | (fits * BLOCK_FIT) | ((value & 0xFFFF) << 16))


def block_lut(tab: np.ndarray) -> np.ndarray:
    """Phase C's lookahead table of the canonical tables `tab` (n,
    DECODE_TABLE_WORDS), n = 4 or 8 (decode_tables): (n, 1 <<
    BLOCK_LUT_BITS) int32 of block_entry layout, indexed by table and by
    the next K = BLOCK_LUT_BITS bits of the row, one token an entry
    (libjpeg's "fast AC" lookahead, jdhuff.c).

    An entry holds the token whose code lies within the K bits
    (_decode_token), and its decoded value (T.81 F.2.2.1) where its value
    bits lie within them too.  It is 0 ("slow") where the code is longer
    than K bits or invalid, and for a DC symbol above 15 (an error the
    kernel finds on its slow path); the kernel decodes such a token from
    the canonical table, and takes the value bits of a token whose value
    does not fit from its bit window.

    A pure function of the tables; the decoder caches it on its plan
    (models/decoder.Plan.block_lut)."""
    K = BLOCK_LUT_BITS
    t64 = torch.from_numpy(np.asarray(tab, np.int64))
    prefix = np.arange(1 << K, dtype=np.int64)
    nt = t64.shape[0]
    out = np.zeros((nt, 1 << K), np.int32)
    for t in range(nt):
        is_dc = t < nt // 2
        clen, sym = (x.numpy() for x in _decode_token(
            t64, torch.full((1 << K,), t, dtype=torch.int64),
            torch.from_numpy(prefix << (16 - K))))
        size = sym & 15
        fast = (clen >= 1) & (clen <= K) & ((sym <= 15) | (not is_dc))
        fits = fast & (clen + size <= K)
        vu = (prefix >> np.maximum(K - clen - size, 0)) \
            & ((1 << size) - 1)
        value = np.where(vu < (1 << np.maximum(size - 1, 0)),
                         vu - (1 << size) + 1, vu)
        value = np.where(fits & (size > 0), value, 0)
        e = block_entry(clen, sym, is_dc, value, fits)
        out[t] = np.where(fast, e, 0).astype(np.uint32).view(np.int32)
    return out


def direct_entry(clen, sym, is_dc):
    """The direct instance's summary of one decoded token (numpy or torch
    integers), the layout of a direct_lut entry: code length, advance,
    run and, for an AC end of block, DIRECT_SPECIAL.  The kernel finds the
    run in the entry's top bits and the value's size as advance minus
    code length."""
    eob = 0 if is_dc else (sym == 0) * 1
    return (clen | ((clen + (sym & 15)) << 5) | (eob * DIRECT_SPECIAL)
            | ((sym >> 4) << 12))


def direct_lut(tab: np.ndarray) -> np.ndarray:
    """The direct instance's two-level table of the canonical tables `tab`
    (n, DECODE_TABLE_WORDS), n = 4 or 8 (decode_tables): (n, stride)
    int16 of direct_entry layout, every token of a 16-bit peek without
    the canonical decode.

    Table t's first 1 << K entries (K = DIRECT_LUT_BITS) are indexed by
    the next K bits.  Where every 16-bit peek of those K bits decodes
    alike (_decode_token: a code of at most K bits, or an invalid code),
    the entry is that token (DIRECT_SPECIAL for an invalid code and for a
    DC symbol above 15).  Else (a code longer than K bits, or codes of
    several lengths) it is DIRECT_SUB | i, and second-level table i, at
    entry (1 << K) + i * (1 << (16 - K)), indexed by the peek's next
    16 - K bits, holds the tokens of the 16-bit peeks.  So a lookup gives
    the canonical decode of every 16-bit peek.  Second-level tables follow
    the first level in the order of their prefixes; stride is the longest
    table's entries, rounded up to a multiple of 8 (16 bytes).

    A pure function of the tables; the decoder caches it on a plan of the
    direct route (models/decoder.Plan.direct_lut)."""
    K = DIRECT_LUT_BITS
    t64 = torch.from_numpy(np.asarray(tab, np.int64))
    peeks = torch.arange(1 << 16, dtype=torch.int64)
    nt = t64.shape[0]
    levels = []
    for t in range(nt):
        is_dc = t < nt // 2
        clen, sym = (x.numpy() for x in _decode_token(
            t64, torch.full((1 << 16,), t, dtype=torch.int64), peeks))
        ok = (clen >= 1) & ((sym <= 15) | (not is_dc))
        e = np.where(ok, direct_entry(clen, sym, is_dc),
                     DIRECT_SPECIAL).reshape(1 << K, 1 << (16 - K))
        same = (e == e[:, :1]).all(axis=1)
        first = e[:, 0].copy()
        mixed = np.flatnonzero(~same)
        # an entry indexes its second level in 9 bits; a table of at most
        # 256 codes has at most 257 such prefixes
        if len(mixed) > 511:
            raise ValueError("direct_lut: more second-level tables than "
                             "an entry indexes")
        first[mixed] = DIRECT_SUB | np.arange(len(mixed))
        levels.append(np.concatenate([first, e[mixed].reshape(-1)]))
    stride = -(-max(len(x) for x in levels) // 8) * 8
    out = np.zeros((nt, stride), np.int64)
    for t, x in enumerate(levels):
        out[t, :len(x)] = x
    return out.astype(np.uint16).view(np.int16)


# --- plain versions -----------------------------------------------------------

def _word_be(words: torch.Tensor, seg: torch.Tensor,
             wi: torch.Tensor) -> torch.Tensor:
    """Big-endian value (int64) of word wi of each lane's segment row;
    0 past the row."""
    W = words.shape[1]
    inside = wi < W
    w = words.reshape(-1)[seg * W + torch.clamp(wi, max=W - 1)]
    w = w.to(torch.int64) & 0xFFFFFFFF
    be = (((w & 0xFF) << 24) | (((w >> 8) & 0xFF) << 16)
          | (((w >> 16) & 0xFF) << 8) | (w >> 24))
    return torch.where(inside, be, 0)


def _peek32(words, seg, cursor):
    """The 32 bits of each lane's row from bit `cursor` on (int64)."""
    wi = cursor >> 5
    r = cursor & 31
    hi = _word_be(words, seg, wi)
    lo = _word_be(words, seg, wi + 1)
    return ((hi << r) | (lo >> (32 - r))) & 0xFFFFFFFF


def _decode_token(tab: torch.Tensor, t: torch.Tensor, peek16: torch.Tensor):
    """(clen, sym) of one token per lane from table t (lane-wise index into
    tab (n, DECODE_TABLE_WORDS) int64); clen == 0 marks an invalid code."""
    clen = torch.ones_like(peek16)
    for l in range(1, 16):
        clen += peek16 > tab[t, _MONO + l]
    invalid = peek16 > tab[t, _MONO + 16]
    code = peek16 >> (16 - clen)
    idx = torch.clamp(code + tab[t, _VALOFF + clen], 0, 255)
    sym = tab[t, _HUFFVAL + idx]
    return torch.where(invalid, 0, clen), sym


def _value_bits(peek, clen, size):
    """Sign-extended `size` value bits after a `clen`-bit code (T.81
    F.2.2.1), as huffdec_kernel.value_bits."""
    vu = ((peek << clen) & 0xFFFFFFFF) >> torch.clamp(32 - size, 0, 31)
    vu = torch.where(size == 0, 0, vu)
    one = torch.ones_like(size)
    half = torch.where(size > 0, one << torch.clamp(size - 1, min=0), 1)
    return torch.where((size > 0) & (vu < half), vu - (one << size) + 1, vu)


def _slot_class(sel, pattern_mask: int, slot, first: int, nsets: int):
    """Table index of each lane's block among tables first .. first + nsets
    - 1 (the module docstring): with two sets, first when its segment flag
    and its slot's pattern bit are set, else first + 1; with four, first
    plus its segment's index plus its slot's 2-bit field, modulo 4."""
    if nsets == 2:
        bit = (pattern_mask >> slot) & 1
        return torch.where((sel != 0) & (bit != 0), first,
                           first + 1).to(torch.int64)
    field = (pattern_mask >> (2 * slot)) & 3
    return first + ((sel.to(torch.int64) + field) & 3)


def scan_segments_plain(words, nbits, nblocks, dc_luma, ac_luma, tab,
                        bps: int, pattern=NO_PATTERN):
    """Plain version of scan_segments, on any device: one lane per
    segment, one token per lane and step until every lane has finished
    its blocks or failed."""
    dev = words.device
    nseg = words.shape[0]
    tab = tab.to(torch.int64)
    nbits = nbits.to(torch.int64)
    nblk = nblocks.to(torch.int64)
    bpm, dc_pat, ac_pat = pattern
    ns = table_sets(tab)
    seg = torch.arange(nseg, device=dev)
    cursor = torch.zeros(nseg, dtype=torch.int64, device=dev)
    blk = torch.zeros_like(cursor)
    pos = torch.zeros_like(cursor)
    err = torch.zeros(nseg, dtype=torch.bool, device=dev)
    bstart = torch.zeros((nseg, bps + 1), dtype=torch.int64, device=dev)
    live = seg[blk < nblk]
    while live.numel():
        c, p = cursor[live], pos[live]
        peek16 = _peek32(words, live, c) >> 16
        is_dc = p == 0
        slot = blk[live] % bpm
        t = torch.where(is_dc,
                        _slot_class(dc_luma[live], dc_pat, slot, 0, ns),
                        _slot_class(ac_luma[live], ac_pat, slot, ns, ns))
        clen, sym = _decode_token(tab, t, peek16)
        run, size = sym >> 4, sym & 15
        after = c + clen + size
        is_eob = ~is_dc & (sym == 0)
        is_zrl = ~is_dc & (sym == 0xF0)
        coef_idx = torch.where(is_dc, 0, p + run)
        new_pos = torch.where(is_dc, 1, torch.where(
            is_eob, 64, torch.where(is_zrl, p + 16, coef_idx + 1)))
        bad = ((clen == 0) | (after > nbits[live]) | (coef_idx > 63)
               | (new_pos > 64))
        done = ~bad & (new_pos >= 64)
        b = blk[live]
        bstart[live[done], b[done] + 1] = after[done]
        err[live] = bad
        cursor[live] = torch.where(bad, c, after)
        blk[live] = b + done.to(torch.int64)
        pos[live] = torch.where(bad | done, torch.where(bad, p, 0), new_pos)
        live = live[~bad & (blk[live] < nblk[live])]
    err = err | (blk < nblk)
    # entries past the last decoded block hold the segment's end
    col = torch.arange(bps + 1, device=dev)[None, :]
    bstart = torch.where(col > blk[:, None], nbits[:, None], bstart)
    return bstart.to(torch.int32), err


def decode_blocks_plain(words, bstart, nblocks, dc_luma, ac_luma, tab,
                        pattern=NO_PATTERN):
    """Plain version of decode_blocks, on any device: one lane per block
    slot, the DC token, then up to MAX_AC_STEPS AC tokens."""
    dev = words.device
    nseg, bps1 = bstart.shape
    bps = bps1 - 1
    L = nseg * bps
    tab = tab.to(torch.int64)
    seg = torch.arange(L, device=dev) // bps
    j = torch.arange(L, device=dev) % bps
    bst = bstart.to(torch.int64)
    cur = bst[:, :bps].reshape(-1)
    bend = bst[:, 1:].reshape(-1)
    valid = j < nblocks.to(torch.int64)[seg]
    bpm, dc_pat, ac_pat = pattern
    ns = table_sets(tab)
    slot = j % bpm
    coefs = torch.zeros((64, L), dtype=torch.int64, device=dev)
    # DC token
    peek = _peek32(words, seg, cur)
    clen, sym = _decode_token(
        tab, _slot_class(dc_luma[seg], dc_pat, slot, 0, ns), peek >> 16)
    size = sym & 15
    after = cur + clen + size
    err = valid & ((clen == 0) | (after > bend) | (sym > 15))
    ok = valid & ~err
    coefs[0] = torch.where(ok & (size > 0), _value_bits(peek, clen, size),
                           0)
    cur = torch.where(ok, after, cur)
    done = ~valid | err | (cur >= bend)
    pos = torch.ones(L, dtype=torch.int64, device=dev)
    act = _slot_class(ac_luma[seg], ac_pat, slot, ns, ns)
    live = torch.nonzero(~done)[:, 0]
    for _ in range(MAX_AC_STEPS):
        if not live.numel():
            break
        c, p = cur[live], pos[live]
        peek = _peek32(words, seg[live], c)
        clen, sym = _decode_token(tab, act[live], peek >> 16)
        run, size = sym >> 4, sym & 15
        after = c + clen + size
        is_eob = sym == 0
        is_zrl = sym == 0xF0
        coef_idx = p + run
        new_pos = torch.where(is_eob, 64,
                              torch.where(is_zrl, p + 16, coef_idx + 1))
        bad = ((clen == 0) | (after > bend[live]) | (coef_idx > 63)
               | (new_pos > 64))
        write = ~bad & ~is_eob & ~is_zrl & (size > 0)
        coefs[coef_idx[write], live[write]] = _value_bits(
            peek, clen, size)[write]
        err[live] = bad
        cur[live] = torch.where(bad, c, after)
        pos[live] = torch.where(bad, p, new_pos)
        fin = ~bad & (new_pos >= 64)
        done[live] = bad | fin
        live = live[~bad & ~fin]
    # a block still unfinished after MAX_AC_STEPS is corrupt
    err = valid & (err | ~done)
    return coefs.to(torch.int16), err.to(torch.int32)


# --- wrappers -----------------------------------------------------------------

def _check(name: str, words, tab, *rows):
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"{name}: words must be a 2-D int32 tensor")
    if tab.dim() != 2 or tab.shape[0] not in (4, 8) or \
            tab.shape[1] != tables.DECODE_TABLE_WORDS or \
            tab.dtype != torch.int32:
        raise ValueError(f"{name}: tables must be (4 or 8, "
                         f"{tables.DECODE_TABLE_WORDS}) int32")
    for r in rows:
        if r.dtype != torch.int32 or tuple(r.shape) != (words.shape[0],):
            raise ValueError(f"{name}: per-segment arrays must be "
                             f"({words.shape[0]},) int32")


def _check_pattern(pattern, tab) -> None:
    bpm, dc_pat, ac_pat = pattern
    if table_sets(tab) == 4:
        if not 1 <= bpm <= 15 or not (0 <= dc_pat < 1 << 2 * bpm
                                      and 0 <= ac_pat < 1 << 2 * bpm):
            raise ValueError(f"slot pattern {pattern} of four sets: 1 <= "
                             "bpm <= 15 and masks of 2 bpm bits")
    elif not 1 <= bpm <= 32 or not (0 <= dc_pat < 1 << bpm
                                    and 0 <= ac_pat < 1 << bpm):
        raise ValueError(f"slot pattern {pattern}: 1 <= bpm <= 32 and "
                         "masks of bpm bits")


def _check_cursors(name: str, words) -> None:
    """The kernels' bit cursors are int32 in [0, 32 W]: a row of 2^26
    words (a scan of 256 MiB) or more raises instead of wrapping."""
    if 32 * words.shape[1] >= 1 << 31:
        raise ValueError(f"{name}: rows of {words.shape[1]} words hold more "
                         "bits than the kernels' int32 cursors address")


def sync_schedule(pattern: Tuple[int, int, int]) -> Tuple[int, int]:
    """(bits a subsequence, lead) of the sync instance for a slot pattern.
    A walk begun at a guessed state (position 0, slot 0) `lead` bits
    before its subsequence falls onto the true tokens and positions within
    a few hundred bits in a scan of one component (SYNC_SCHEDULE); in an
    interleaved scan the slot in the MCU takes longer (about 500 bits,
    past 2,000 in one walk of ten on a 512x384 stream, and stretches of an
    8K frame stay out of phase for thousands of bits, which then walk one
    subsequence after another), so its walks start further back and
    cover more bits (SYNC_SCHEDULE_PATTERN; PERF.md, phase A: 0.84 ms at 8K
    4:2:0 against 7.1 with (1024, 4096) and 21 with (4096, 2048))."""
    return SYNC_SCHEDULE if pattern[0] == 1 else SYNC_SCHEDULE_PATTERN


def sync_chunks(W: int, sub_bits: int = SYNC_SCHEDULE[0]) -> int:
    """Chunks (CTAs) of the sync instance a row of W words."""
    nsub = -(-32 * W // sub_bits)
    return max(1, -(-nsub // (SYNC_THREADS - SYNC_WARM)))


def sync_scratch_words(nseg: int, W: int,
                       sub_bits: int = SYNC_SCHEDULE[0]) -> int:
    """int32 words of the sync instance's scratch (the ticket and a
    look-back record a chunk of every row); the kernel zeroes it."""
    return SYNC_SCRATCH_HEAD + nseg * sync_chunks(W, sub_bits) \
        * SYNC_REC_WORDS


def scan_instance(nseg: int, W: int) -> str:
    """Phase A's instance for nseg segment rows of W words: "sync" (many
    threads a row: subsequences of sync_schedule's bits walked from guessed
    states and joined where Huffman codes resynchronise) for rows of at
    least SYNC_MIN_WORDS words, such as a scan of one segment (restart
    interval 0); else "serial" (a thread walks a row).  Restart auto
    (about 20 words a row at 8K Q75) keeps the serial instance."""
    return "sync" if nseg > 0 and W >= SYNC_MIN_WORDS else "serial"


def scan_segments(words: torch.Tensor, nbits: torch.Tensor,
                  nblocks: torch.Tensor, dc_luma: torch.Tensor,
                  ac_luma: torch.Tensor, tab: torch.Tensor, bps: int,
                  pattern: Tuple[int, int, int] = NO_PATTERN,
                  lut: Optional[torch.Tensor] = None,
                  instance: Optional[str] = None,
                  stats: Optional[dict] = None,
                  sets: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase A: (words (nseg, W) int32 host-order rows; nbits, nblocks,
    dc_luma, ac_luma (nseg,) int32, the segments' table selectors: luma
    flags with two sets, table indices with four; tab (4 or 8,
    DECODE_TABLE_WORDS) int32, decode_tables) -> (bstart (nseg, bps+1)
    int32, err (nseg,) bool).

    bstart[s, 0] = 0 and bstart[s, b+1] is the bit cursor after block b;
    entries past the last decoded block hold nbits[s].  err[s] is set
    when a token of the segment is invalid, overruns the segment's bits
    or the block's 64 coefficients, or the segment ends short of
    nblocks[s] blocks (huffdec_kernel._scan_kernel_body).  pattern is
    the slot pattern (bpm, dc mask, ac mask) of the module docstring.

    lut is scan_lut(tab) on the words' device, which the kernel reads its
    tokens through (the decoder passes the one cached on its plan); a
    CUDA call raises without it, and for rows of 2^26 words or more (the
    kernels' bit cursors are int32).  The plain version does not use
    it.  The CUDA call launches the instance scan_instance picks, or
    `instance` ("serial" or "sync") where given; both give the same
    bstart and err (_kernels.INSTANCES counts them).  Given a dict
    `stats`, a launch of the sync instance waits for the card and fills
    it with the launch's rounds (summed over its CTAs), the chunks that
    walked again from a true entry their guess missed ("redo"), the
    subsequences walked by running ahead ("ahead") and the longest CTA's
    microseconds in its local walks, look-back and writing walk.

    sets, with eight tables, is 3 or 4 (default table_sets(tab)): the
    serial instance loads the lookahead rows of sets 0 .. sets - 1 alone
    (the decoder passes Plan.sets, 3 where its fourth set is a copy of
    the third), and a block of a set past them decodes each token from
    the canonical tables, with the same result."""
    _check("scan_segments", words, tab, nbits, nblocks, dc_luma, ac_luma)
    _check_pattern(pattern, tab)
    nsets = table_sets(tab)
    if sets is None:
        sets = nsets
    elif sets != nsets and not (nsets == 4 and sets == 3):
        raise ValueError(f"scan_segments: {sets} sets of {tab.shape[0]} "
                         "tables (3 or 4 of eight, 2 of four)")
    if words.device.type == "cpu":
        return scan_segments_plain(words, nbits, nblocks, dc_luma, ac_luma,
                                   tab, bps, pattern)
    _kernels.require_cuda("huffdec_scan", words, nbits, nblocks, dc_luma,
                          ac_luma, tab)
    _check_cursors("scan_segments", words)
    nt = tab.shape[0]
    if lut is None or tuple(lut.shape) != (nt, 1 << SCAN_LUT_BITS) or \
            lut.dtype != torch.int16 or lut.data_ptr() % 16:
        raise ValueError(f"scan_segments: lut must be ({nt}, "
                         f"{1 << SCAN_LUT_BITS}) int16 (scan_lut), 16-byte "
                         "aligned")
    nseg, W = words.shape
    bstart = torch.empty((nseg, bps + 1), dtype=torch.int32,
                         device=words.device)
    err = torch.empty(nseg, dtype=torch.bool, device=words.device)
    _kernels.require_cuda("huffdec_scan", words, lut, bstart, err)
    inst = instance or scan_instance(nseg, W)
    args = (words, nseg, W, nbits, nblocks, dc_luma, ac_luma, *pattern,
            nsets, tab, lut, bps, bstart, err)
    if inst == "serial":
        _kernels.launch("huffdec_scan", *args[:10], sets, *args[11:],
                        instance="serial")
    elif inst == "sync":
        sub_bits, lead = sync_schedule(pattern)
        scratch = torch.empty(sync_scratch_words(nseg, max(W, 1), sub_bits),
                              dtype=torch.int32, device=words.device)
        _kernels.launch("huffdec_scan_sync", *args, sub_bits, lead, scratch,
                        instance="sync")
        if stats is not None:
            d = scratch[:7].tolist()
            stats.update(rounds=d[1], redo=d[2], ahead=d[3], local_us=d[4],
                         look_back_us=d[5], write_us=d[6],
                         chunks=nseg * sync_chunks(max(W, 1), sub_bits))
    else:
        raise ValueError(f"scan_segments: no instance {inst!r}")
    return bstart, err


def decode_blocks(words: torch.Tensor, bstart: torch.Tensor,
                  nblocks: torch.Tensor, dc_luma: torch.Tensor,
                  ac_luma: torch.Tensor, tab: torch.Tensor,
                  pattern: Tuple[int, int, int] = NO_PATTERN,
                  lut: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase C, segment-row contract: block slot b = s*bps + j decodes
    from bit bstart[s, j] to bstart[s, j+1] of segment row s (bstart from
    0 to 32 W) -> (coefs_t (64, nseg*bps) int16 zig-zag with DIFFERENTIAL
    DC, err (nseg*bps,) int32).  Slots j >= nblocks[s] are all zero with
    err 0; every slot a block does not write is 0
    (huffdec_kernel._block_kernel_body).  The selectors, tab and
    pattern as scan_segments.

    lut is block_lut(tab) on the words' device, which the kernel reads its
    tokens through (the decoder passes the one cached on its plan); a
    CUDA call raises without it, and for rows of 2^26 words or more.  The
    plain version does not use it."""
    _check("decode_blocks", words, tab, nblocks, dc_luma, ac_luma)
    _check_pattern(pattern, tab)
    nseg = words.shape[0]
    if bstart.dtype != torch.int32 or bstart.dim() != 2 or \
            bstart.shape[0] != nseg:
        raise ValueError("decode_blocks: bstart must be (nseg, bps+1) int32")
    if words.device.type == "cpu":
        return decode_blocks_plain(words, bstart, nblocks, dc_luma, ac_luma,
                                   tab, pattern)
    coefs, err, args = _block_args(words, bstart, bstart.shape[1] - 1,
                                   nblocks, dc_luma, ac_luma, tab, pattern,
                                   lut)
    _kernels.launch("huffdec_block", *args)
    return coefs, err


def decode_blocks_direct_plain(words, nbits, nblocks, dc_luma, ac_luma, tab,
                               pattern=NO_PATTERN):
    """Plain version of decode_blocks_direct, on any device:
    decode_blocks_plain with bstart[s] = (0, nbits[s])."""
    bstart = torch.stack([torch.zeros_like(nbits), nbits], dim=1)
    return decode_blocks_plain(words, bstart, nblocks, dc_luma, ac_luma, tab,
                               pattern)


def decode_blocks_direct(words: torch.Tensor, nbits: torch.Tensor,
                         nblocks: torch.Tensor, dc_luma: torch.Tensor,
                         ac_luma: torch.Tensor, tab: torch.Tensor,
                         pattern: Tuple[int, int, int] = NO_PATTERN,
                         lut: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase C of one block a segment (the JAX kernel's buffer mode,
    with_cursor=False): block slot s decodes from bit 0 to bit nbits[s] of
    segment row s -> (coefs_t (64, nseg) int16 zig-zag, err (nseg,)
    int32).  nbits is the segment's byte-aligned bit count, so a corrupt
    block may consume up to 7 padding bits without an error, as in the
    JAX decoder's _decode_direct.  DC is as coded, which is absolute at
    one block a segment.  Slots with nblocks[s] == 0 are zero with err 0.
    The selectors, tab and pattern as decode_blocks.

    lut is direct_lut(tab) on the words' device (the decoder passes the
    one cached on its plan), which the CUDA call's kernel, csrc/
    huffdec_block.cu's direct instance, reads every token through; it
    reads no bstart and no canonical table.  A CUDA call raises without
    it, and for rows of 2^26 words or more.  The plain version does not
    use it."""
    _check("decode_blocks_direct", words, tab, nbits, nblocks, dc_luma,
           ac_luma)
    _check_pattern(pattern, tab)
    if words.device.type == "cpu":
        return decode_blocks_direct_plain(words, nbits, nblocks, dc_luma,
                                          ac_luma, tab, pattern)
    coefs, err, args = _direct_args(words, nbits, nblocks, dc_luma, ac_luma,
                                    tab, pattern, lut)
    _kernels.launch("huffdec_block_direct", *args)
    return coefs, err


def _block_args(words, bstart, bps, nblocks, dc_luma, ac_luma, tab, pattern,
                lut):
    """The outputs and the C arguments of csrc/huffdec_block.cu's entry
    point gj_huffdec_block."""
    _kernels.require_cuda("huffdec_block", words, bstart, nblocks, dc_luma,
                          ac_luma, tab)
    _check_cursors("decode_blocks", words)
    nt = tab.shape[0]
    if lut is None or tuple(lut.shape) != (nt, 1 << BLOCK_LUT_BITS) or \
            lut.dtype != torch.int32 or lut.data_ptr() % 16:
        raise ValueError(f"decode_blocks: lut must be ({nt}, "
                         f"{1 << BLOCK_LUT_BITS}) int32 (block_lut), "
                         "16-byte aligned")
    nseg = words.shape[0]
    L = nseg * bps
    coefs = torch.empty((64, L), dtype=torch.int16, device=words.device)
    err = torch.empty(L, dtype=torch.int32, device=words.device)
    _kernels.require_cuda("huffdec_block", words, lut, coefs, err)
    return coefs, err, (words, nseg, words.shape[1], bstart, bps, nblocks,
                        dc_luma, ac_luma, *pattern, table_sets(tab), tab,
                        lut, coefs, err)


def _direct_args(words, nbits, nblocks, dc_luma, ac_luma, tab, pattern, lut):
    """The outputs and the C arguments of csrc/huffdec_block.cu's entry
    point gj_huffdec_block_direct: the tables reach the kernel as lut
    alone, (2 * sets, stride) int16 (direct_lut)."""
    _kernels.require_cuda("huffdec_block_direct", words, nbits, nblocks,
                          dc_luma, ac_luma, tab)
    _check_cursors("decode_blocks_direct", words)
    nt = tab.shape[0]
    if lut is None or lut.dim() != 2 or lut.shape[0] != nt or \
            lut.shape[1] < 1 << DIRECT_LUT_BITS or lut.shape[1] % 8 or \
            lut.shape[1] > 1 << 15 or lut.dtype != torch.int16 or \
            lut.data_ptr() % 16:
        raise ValueError(f"decode_blocks_direct: lut must be ({nt}, stride) "
                         "int16 (direct_lut), 16-byte aligned")
    nseg = words.shape[0]
    coefs = torch.empty((64, nseg), dtype=torch.int16, device=words.device)
    err = torch.empty(nseg, dtype=torch.int32, device=words.device)
    _kernels.require_cuda("huffdec_block_direct", words, lut, coefs, err)
    return coefs, err, (words, nseg, words.shape[1], nbits, nblocks, dc_luma,
                        ac_luma, *pattern, table_sets(tab), lut,
                        lut.shape[1], coefs, err)


def decode_blocks_probe(words: torch.Tensor, bstart: torch.Tensor,
                        nblocks: torch.Tensor, dc_luma: torch.Tensor,
                        ac_luma: torch.Tensor, tab: torch.Tensor,
                        pattern: Tuple[int, int, int], lut: torch.Tensor,
                        stage: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """decode_blocks' kernel cut to a decomposition stage
    (_kernels.PROBE_STAGES: the full kernel; every block's loads and
    window with no token decoded, the zero tiles stored; the decode
    without the coefficient store) for chip_smoke.py's probe; no codec
    path calls it.  Only the "full" stage's output is the coefficients."""
    _check("decode_blocks", words, tab, nblocks, dc_luma, ac_luma)
    _check_pattern(pattern, tab)
    coefs, err, args = _block_args(words, bstart, bstart.shape[1] - 1,
                                   nblocks, dc_luma, ac_luma, tab, pattern,
                                   lut)
    _kernels.probe("huffdec_block", stage, *args)
    return coefs, err


def decode_blocks_direct_probe(words: torch.Tensor, nbits: torch.Tensor,
                               nblocks: torch.Tensor, dc_luma: torch.Tensor,
                               ac_luma: torch.Tensor, tab: torch.Tensor,
                               pattern: Tuple[int, int, int],
                               lut: torch.Tensor, stage: str
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """decode_blocks_direct's kernel cut to a decomposition stage
    (_kernels.PROBE_STAGES: the full kernel; every tile's rows staged and
    every block's first three words loaded with no token decoded, the
    zero tiles stored; the decode without the coefficient store) for
    chip_smoke.py's probe; no codec path calls it.  Only the "full"
    stage's output is the coefficients."""
    _check("decode_blocks_direct", words, tab, nbits, nblocks, dc_luma,
           ac_luma)
    _check_pattern(pattern, tab)
    coefs, err, args = _direct_args(words, nbits, nblocks, dc_luma, ac_luma,
                                    tab, pattern, lut)
    _kernels.probe("huffdec_block_direct", stage, *args)
    return coefs, err
