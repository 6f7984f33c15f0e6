"""PyTorch port, phase A's sync instance (csrc/huffdec_scan.cu,
huffdec_scan_sync_kernel): its schedule replayed in Python with the
kernel's own constants, read from its source, and at small subsequences
(32-128 bits, so that a 128x96 stream has hundreds): the subsequence cut,
each thread's walk from a guessed state (its first bit, position 0, slot
0) up to the first token boundary at or past its end (one token a step
where a lookahead entry would pass the end), the rounds inside a CTA
until no exit changes, the decoupled look-back across CTAs in ticket
order (aggregates composed from the nearest inclusive record while each
guess equals the exit before it, a wrong guess resolved by its own CTA
walking its rounds again), the writing walk at the prefix of the block
counts, and the fills of err and of the entries after the last block.
The replay is held against the plain version (scan_segments_plain) and
against the JAX package's Pallas phase A (_scan_kernel_body) in interpret
mode on restart-0 streams, rows with long codes and four table sets, a
truncated scan, an invalid code mid-scan and a stream that never
resynchronises.  The kernel itself is held against the serial instance
and the plain version on the card (tests/test_torch_kernels.py)."""

import io
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpujpeg_tpu as gj
from gpujpeg_tpu.models import decoder as jdec
from gpujpeg_tpu.ops import huffdec_kernel as jhk
from gpujpeg_tpu.stream import reader as jreader
from gpujpeg_tpu.utils.geometry import get_geometry as jget_geometry

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from tests import scan_rows
from tests import torch_threads  # noqa: F401

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gpujpeg_tpu_torch", "csrc", "huffdec_scan.cu")


def _constants():
    """The kernel's `constexpr int` constants, evaluated in order."""
    env = {}
    with open(_SRC) as f:
        for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                     f.read(), re.M):
            env[name] = eval(expr, {}, dict(env))
    return env


K = _constants()
#: a schedule: (bits a subsequence, threads a CTA, warm threads); the
#: kernel's takes its subsequence from huffdec_kernel.sync_schedule
KERNEL = (None, K["kSyncThreads"], K["kWarm"])
DEAD = 1 << 16
#: a guessed entry: its walk restarts past a bad token instead of dying
GUESS = 1 << 17
#: lookahead and canonical decode tables by decode tables
_TABLES = {}


class Replay:
    """The sync instance's schedule over the rows of one call."""

    def __init__(self, words, nbits, nblocks, dcl, acl, tab, bps,
                 pattern=thd.NO_PATTERN, sched=KERNEL, lead=None):
        self.S, self.T, self.warm = sched
        # the bits a guessed walk starts before its subsequence
        sub_bits, self.lead = thd.sync_schedule(pattern)
        self.S = self.S or sub_bits
        self.lead = self.lead if lead is None else lead
        self.own = self.T - self.warm
        self.words = np.asarray(words)
        self.nbits = [int(x) for x in np.asarray(nbits)]
        self.nb = [int(x) for x in np.asarray(nblocks)]
        self.dcl = np.asarray(dcl)
        self.acl = np.asarray(acl)
        self.bps = bps
        self.pattern = pattern
        self.ns = thd.table_sets(tab)
        key = tab.numpy().tobytes()
        if key not in _TABLES:
            t64 = tab.to(torch.int64)
            peeks = torch.arange(1 << 16, dtype=torch.int64)
            _TABLES[key] = (
                thd.scan_lut(tab.numpy()).astype(np.int64).tolist(),
                [tuple(x.numpy().tolist() for x in thd._decode_token(
                    t64, torch.full_like(peeks, t), peeks))
                 for t in range(tab.shape[0])])
        self.lut, self.dec = _TABLES[key]
        self.stats = dict(rounds=0, walks=0, redo=0, composed=0, waits=0,
                          restarts=0, ahead=0)

    # -- one thread's walk (huffdec_scan.cu walk) ---------------------------
    def _peek(self, c, n):
        return (self.row >> (self.total + 64 - c - n)) & ((1 << n) - 1)

    def walk(self, st, end, out=None, base=0, nb=0):
        cur, meta = st
        spec = bool(meta & GUESS)
        if spec and cur >= self.seg_nbits:      # a guess past the bits
            return (0, DEAD), 0
        if meta & DEAD or cur >= end:
            return (cur, meta & ~GUESS), 0
        self.stats["walks"] += 1
        pos, slot = meta & 127, (meta >> 8) & 255
        bpm = self.pattern[0]
        count = 0
        Kb = thd.SCAN_LUT_BITS
        while cur < end:
            is_dc = pos == 0
            dset, aset = scan_rows.block_sets(self.sdc, self.sac,
                                              self.pattern, slot, self.ns)
            cls = dset if is_dc else self.ns + aset
            e = self.lut[cls][self._peek(cur, Kb)]
            new_pos = pos + ((e >> 5) & 63)
            if e == 0 or new_pos > 64 or cur + (e & 31) > end:
                p16 = self._peek(cur, 16)
                clen, sym = self.dec[cls][0][p16], self.dec[cls][1][p16]
                if clen == 0:
                    if spec:        # a guess: on from the next bit
                        cur, pos, slot = cur + 1, 0, 0
                        self.stats["restarts"] += 1
                        continue
                    return (0, DEAD), count
                e = int(thd.scan_entry(clen, sym, is_dc))
                new_pos = pos + ((e >> 5) & 63)
            after = cur + (e & 31)
            if after > self.seg_nbits:
                return (0, DEAD), count
            if new_pos > 64:
                if spec:
                    cur, pos, slot = cur + 1, 0, 0
                    self.stats["restarts"] += 1
                    continue
                return (0, DEAD), count
            cur = after
            if e & 0x800 or new_pos == 64:
                if out is not None and base + count < nb:
                    out[base + count + 1] = after
                count += 1
                slot = (slot + 1) % bpm
                pos = 0
            else:
                pos = new_pos
        return (cur, pos | (slot << 8)), count

    # -- a CTA ----------------------------------------------------------------
    def _relax(self, cta, k, e, walking):
        """A walking thread's run-ahead: walk subsequence k from e; while
        the exit differs from the recorded one and the next thread does
        not walk this round, walk the next subsequence from it too."""
        ent, ex, cnt = cta["entry"], cta["exit"], cta["cnt"]
        changed = False
        while True:
            ent[k] = e
            x, cnt[k] = self.walk(e, cta["end"][k])
            if x == ex[k]:
                return changed
            ex[k] = x
            changed = True
            if k + 1 >= self.T or walking[k + 1]:
                return changed
            self.stats["ahead"] += 1
            k, e = k + 1, x

    def _rounds(self, cta, frm):
        ent, ex = cta["entry"], cta["exit"]
        while True:
            self.stats["rounds"] += 1
            new = [ex[t - 1] if t > frm else ent[t] for t in range(self.T)]
            walking = [t > frm and new[t] != ent[t] for t in range(self.T)]
            changed = False
            for t in range(self.T):
                if walking[t]:
                    changed |= self._relax(cta, t, new[t], walking)
            if not changed:
                return

    def _local(self, k):
        """Every thread's walk from its guess, then the rounds: a chunk's
        aggregate (guess, exit, own blocks)."""
        bits = 32 * self.W
        first = self.warm if k == 0 else 0
        cta = dict(entry=[], exit=[], cnt=[], end=[], first=first)
        for t in range(self.T):
            sub = k * self.own + t - self.warm
            end = min((sub + 1) * self.S, bits)
            st = (min(max(sub, 0) * self.S, bits), 0 if k == 0 and
                  t == first else GUESS)
            x, c = (self.walk((max(st[0] - self.lead, 0), GUESS)
                              if st[1] else st, end)
                    if t >= first else (st, 0))
            cta["entry"].append(st)
            cta["exit"].append(x)
            cta["cnt"].append(c)
            cta["end"].append(end)
        self._rounds(cta, first)
        cta["guess"] = cta["exit"][self.warm - 1]
        return cta

    def _blocks(self, cta):
        return sum(cta["cnt"][self.warm:])

    def _look_back(self, recs, k):
        """Warp 0's look-back over the 32 nearest records, or None where
        the kernel would spin."""
        lanes = [recs[k - 1 - i] for i in range(32) if k - 1 - i >= 0]
        incl = [i for i, r in enumerate(lanes) if r["flag"] == 2]
        if not incl or any(r["flag"] == 0 for r in lanes[:incl[0]]):
            return None
        i = incl[0]
        E, B = lanes[i]["X"], lanes[i]["C"]
        for m in range(i - 1, -1, -1):
            if E != lanes[m]["g"]:
                return None
            E, B = lanes[m]["x"], B + lanes[m]["c"]
            self.stats["composed"] += 1
        return E, B

    def set_row(self, s, words=None):
        """Walks read row s (of `words` where given)."""
        if words is not None:
            self.words = np.asarray(words)
        self.W = self.words.shape[1]
        self.total = 32 * self.W
        self.row = int.from_bytes(
            self.words[s].astype("<u4").tobytes(), "big") << 64
        self.seg_nbits = self.nbits[s]
        self.sdc, self.sac = self.dcl[s], self.acl[s]

    def _row(self, s):
        self.set_row(s)
        nb = self.nb[s]
        nsub = -(-self.total // self.S)
        nchunk = max(1, -(-nsub // self.own))
        if self.own == K["kOwn"]:
            assert nchunk == thd.sync_chunks(self.W, self.S)
        out = np.full(self.bps + 1, -7, np.int64)
        ctas = [self._local(k) for k in range(nchunk)]
        recs = [dict(flag=0) for _ in range(nchunk)]
        for k, cta in enumerate(ctas):
            recs[k] = dict(flag=1, g=cta["guess"], x=cta["exit"][-1],
                           c=self._blocks(cta))
        recs[0] = dict(flag=2, X=ctas[0]["exit"][-1], C=self._blocks(ctas[0]))
        ctas[0]["base"] = 0
        # later chunks first, so that aggregates are composed
        pending = list(range(1, nchunk))
        while pending:
            done = []
            for k in reversed(pending):
                res = self._look_back(recs, k)
                if res is None:
                    self.stats["waits"] += 1
                    continue
                E, B = res
                cta = ctas[k]
                if E != cta["guess"]:
                    self.stats["redo"] += 1
                    self._relax(cta, self.warm, E, [False] * self.T)
                    self._rounds(cta, self.warm)
                cta["base"] = B
                recs[k] = dict(recs[k], flag=2, X=cta["exit"][-1],
                               C=B + self._blocks(cta))
                done.append(k)
            assert done, "no chunk could resolve its look-back"
            pending = [k for k in pending if k not in done]
        # the writes, entries past nblocks, err and the last chunk's fill
        out[0] = 0
        out[nb + 1:] = self.seg_nbits
        for cta in ctas:
            base = cta["base"]
            for t in range(self.warm, self.T):
                if base < nb:
                    self.walk(cta["entry"][t], cta["end"][t], out, base, nb)
                base += cta["cnt"][t]
        total = recs[-1]["C"]
        out[total + 1:nb + 1] = self.seg_nbits
        assert (out != -7).all(), "an entry of bstart was never written"
        return out, total < nb

    def run(self):
        rows = [self._row(s) for s in range(self.words.shape[0])]
        bstart = torch.from_numpy(np.stack([r[0] for r in rows])
                                  .astype(np.int32))
        return bstart, torch.tensor([r[1] for r in rows])


def _check(words, nbits, nblocks, dcl, acl, tab, bps, pattern, sched,
           want=None):
    args = [torch.as_tensor(np.asarray(a)) for a in (words, nbits, nblocks,
                                                     dcl, acl)]
    if want is None:
        want = thd.scan_segments_plain(*args, tab, bps, pattern)
    rp = Replay(*args, tab, bps, pattern, sched)
    got = rp.run()
    assert torch.equal(got[0], want[0]), \
        int((got[0] != want[0]).nonzero()[0, 1])
    assert torch.equal(got[1], want[1])
    return want, rp.stats


SMALL = (64, 16, 2)          # bits a subsequence, threads a CTA, warm
TINY = (32, 8, 2)


def _gradient(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  ((xx + yy) * 255 // (w + h))], -1)
    return np.clip(f + rng.integers(-24, 24, f.shape), 0, 255) \
        .astype(np.uint8)


def _pil(layout, h=48, w=64):
    """A libjpeg restart-0 stream (one segment a scan) at Q75."""
    Image = pytest.importorskip("PIL.Image")
    frame = _gradient(h, w, 1)
    im = Image.fromarray(frame)
    kw = dict(quality=75, subsampling=2 if layout == "420" else 0)
    if layout == "grey":
        im = im.convert("L")
        kw.pop("subsampling")
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _prepared(data):
    hf = gt.Decoder(device="cpu").prepare(data)
    p = hf.plan
    assert hf.words.shape[0] == 1 and p.geo.segment_count == 1
    return hf, p


def test_constants_match_the_wrapper():
    """The wrapper sizes the scratch and picks the schedule with the
    kernel's constants."""
    assert (thd.SYNC_THREADS, thd.SYNC_WARM, thd.SYNC_REC_WORDS,
            thd.SYNC_SCRATCH_HEAD) == (
        K["kSyncThreads"], K["kWarm"], K["kRecWords"], K["kScratchHead"])
    assert K["kOwn"] == K["kSyncThreads"] - K["kWarm"] > 0
    # one record a chunk of every row
    W = 10_000
    for pattern in (thd.NO_PATTERN, (6, 15, 15)):
        sub_bits, lead = thd.sync_schedule(pattern)
        assert sub_bits >= 32 and lead >= 0
        nsub = -(-32 * W // sub_bits)
        assert thd.sync_chunks(W, sub_bits) == -(-nsub // K["kOwn"])
        assert thd.sync_scratch_words(3, W, sub_bits) == K["kScratchHead"] \
            + 3 * thd.sync_chunks(W, sub_bits) * K["kRecWords"]
    assert thd.sync_schedule((3, 1, 1)) == thd.SYNC_SCHEDULE_PATTERN


def test_scan_instance_threshold():
    """Rows of SYNC_MIN_WORDS words or more take the sync instance (a
    restart-0 scan), shorter ones the serial walk (restart auto)."""
    assert thd.scan_instance(1, 140_000) == "sync"
    assert thd.scan_instance(3, thd.SYNC_MIN_WORDS) == "sync"
    assert thd.scan_instance(1_555_200, 20) == "serial"
    assert thd.scan_instance(4, thd.SYNC_MIN_WORDS - 1) == "serial"
    assert thd.scan_instance(0, 1 << 20) == "serial"


_PLAIN = {}


def _pil_plain(layout):
    """A 64x48 PIL restart-0 stream of the layout, prepared, with the
    plain version's (bstart, err) on it (computed once a module)."""
    if layout not in _PLAIN:
        hf, p = _prepared(_pil(layout))
        _PLAIN[layout] = hf, p, thd.scan_segments_plain(
            torch.from_numpy(hf.words), torch.from_numpy(hf.nbits),
            p.nblocks, p.dc_luma, p.ac_luma, p.tables, p.bps, p.pattern)
    return _PLAIN[layout]


@pytest.mark.parametrize("layout", ["grey", "444", "420"])
@pytest.mark.parametrize("sched", [SMALL, KERNEL], ids=["small", "kernel"])
def test_pil_restart0_matches_plain(layout, sched):
    """PIL restart-0 streams at 64x48 (a scan one segment; 4:4:4 and
    4:2:0 one interleaved scan with slot patterns): bstart and err equal
    the plain version's, at small subsequences (over a hundred a scan,
    many chunks) and at the kernel's own."""
    hf, p, want = _pil_plain(layout)
    _want, stats = _check(hf.words, hf.nbits, p.nblocks, p.dc_luma,
                          p.ac_luma, p.tables, p.bps, p.pattern, sched,
                          want)
    assert not want[1].any()
    if sched == SMALL:
        assert stats["composed"] > 0 and stats["walks"] > 100


#: small PIL streams the JAX kernel compiles in interpret mode in seconds
#: (its loop state carries a tuple of bps planes)
JAX_STREAMS = {"grey": (16, 16), "444": (8, 16), "420": (16, 16)}


def _jax_scan(layout, h, w):
    """The JAX package's Pallas phase A (_scan_kernel_body, generic
    tables) in interpret mode on a small restart-0 stream of the layout,
    with the same word matrix: (hf, plan, bstart, err)."""
    data = _pil(layout, h, w)
    hf, p = _prepared(data)
    ps = jreader.parse(data)
    geo = jget_geometry(jreader.parsed_to_parameters(ps),
                        jdec.resolve_output(ps, None, 0)
                        .with_(width_padding=0))
    jplan = gj.Decoder()._plan_for(geo, ps)
    pats = None
    if jplan.luma_patterns is not None:
        dc_pat, ac_pat, bpm = jplan.luma_patterns
        pats = (tuple(bool(x) for x in dc_pat),
                tuple(bool(x) for x in ac_pat), int(bpm))
    tbl, nw_dc, nw_ac = jplan.generic
    fn = jhk.make_scan_kernel(
        hf.words.shape[1], jplan.bps, None, None, None, None, 128, True,
        pats, None, generic=(nw_dc, nw_ac), baked_tbl=jplan.generic_baked)
    rows = (jnp.asarray(hf.nbits), jnp.asarray(p.nblocks.numpy()),
            jnp.asarray(jplan.dc_luma_row.astype(np.int32)),
            jnp.asarray(jplan.ac_luma_row.astype(np.int32)))
    jwords = jnp.asarray(hf.words.view(np.uint32).byteswap())
    lead = () if jplan.generic_baked is not None else (jnp.asarray(tbl),)
    jb, je = fn(*lead, jwords, *rows)
    return hf, p, np.asarray(jb), np.asarray(je)


@pytest.mark.parametrize("layout", list(JAX_STREAMS))
def test_pil_restart0_matches_jax_kernel(layout):
    """Small PIL restart-0 streams, subsequences of 32 bits: bstart and
    err equal the JAX Pallas phase A's in interpret mode."""
    hf, p, jb, je = _jax_scan(layout, *JAX_STREAMS[layout])
    rp = Replay(hf.words, hf.nbits, p.nblocks.numpy(), p.dc_luma.numpy(),
                p.ac_luma.numpy(), p.tables, p.bps, p.pattern, TINY)
    bstart, err = rp.run()
    assert np.array_equal(bstart.numpy(), jb)
    assert np.array_equal(err.numpy(), je)
    assert not err.any() and rp.stats["walks"] > 20


def _long_rows(seed, bpm, nsets, nseg=3, bps=60):
    """Rows of scan_rows' coded blocks with long codes: two sets (long
    codes, Annex K) or four (three long-code sets and Annex K), with a
    slot pattern of bpm slots."""
    rng = np.random.default_rng(seed)
    if nsets == 2:
        tabs = [scan_rows.long_code_tables(seed),
                scan_rows.annexk_tables()[1]]
        pattern = (bpm, int(rng.integers(1, 1 << bpm)),
                   int(rng.integers(1, 1 << bpm)))
        flags = (rng.integers(0, 2, nseg), rng.integers(0, 2, nseg))
    else:
        tabs = [scan_rows.long_code_tables(seed + i) for i in range(3)] + \
            [scan_rows.annexk_tables()[1]]
        pattern = (bpm, int(rng.integers(0, 1 << 2 * bpm)),
                   int(rng.integers(0, 1 << 2 * bpm)))
        flags = (rng.integers(0, 4, nseg), rng.integers(0, 4, nseg))
    rows, nb, dcl, acl = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern, flags,
        np.full(nseg, bps), long_share=0.5)
    words, nbits = scan_rows.word_matrix(rows)
    return words, nbits, nb, dcl, acl, scan_rows.decode_tables(tabs), \
        bps, pattern


@pytest.mark.parametrize("bpm,nsets,seed", [(1, 2, 0), (3, 2, 1), (6, 2, 2),
                                            (2, 4, 3), (3, 4, 4)])
def test_long_code_rows(bpm, nsets, seed):
    """Rows of 60 blocks with codes of up to 16 bits (many past the
    lookahead table), slot patterns, two and four table sets, rows of
    different lengths in one call: equal to the plain version, no
    error."""
    args = _long_rows(seed, bpm, nsets)
    want, _ = _check(*args, TINY)
    assert not want[1].any()


def test_truncated_scan():
    """A scan whose bit count ends mid-block, and one whose bits stop a
    block short: err set, the entries after the last decoded block
    nbits, as the plain version."""
    words, nbits, nb, dcl, acl, tab, bps, pattern = _long_rows(5, 3, 2)
    nbits = nbits.copy()
    nbits[0] = nbits[0] // 2 + 3
    nbits[2] -= 40
    want, _ = _check(words, nbits, nb, dcl, acl, tab, bps, pattern, TINY)
    assert want[1].tolist() == [True, False, True]


def test_invalid_code_mid_scan():
    """Thirty-two one bits mid-row (no valid code) in a PIL restart-0
    scan and in a long-code row: the first bad token on the true walk
    sets err; the speculative walks that meet it set nothing."""
    hf, p, _ = _pil_plain("444")
    words = hf.words.copy()
    words[0, words.shape[1] // 2] = -1
    want, stats = _check(words, hf.nbits, p.nblocks, p.dc_luma, p.ac_luma,
                         p.tables, p.bps, p.pattern, SMALL)
    assert want[1].tolist() == [True]
    assert (want[0][0] == int(hf.nbits[0])).sum() > 10
    w2, nbits, nb, dcl, acl, tab, bps, pattern = _long_rows(6, 1, 2)
    w2[1, w2.shape[1] // 3] = -1
    want, _ = _check(w2, nbits, nb, dcl, acl, tab, bps, pattern, TINY)
    assert want[1].tolist() == [False, True, False]


def test_corrupt_pil_bit_flip():
    """One bit flipped mid-scan in a PIL restart-0 stream, the first from
    the middle on that the serial walk (the replay's walk from bit 0 over
    the whole row) finds: bstart and err equal the plain version's."""
    hf, p, _ = _pil_plain("420")
    nbits = int(hf.nbits[0])
    rp = Replay(hf.words, hf.nbits, p.nblocks, p.dc_luma, p.ac_luma,
                p.tables, p.bps, p.pattern)
    for bit in range(nbits // 2, nbits):
        words = hf.words.copy()
        w = words.view(np.uint32)
        w[0, bit >> 5] ^= np.uint32(1) << np.uint32(
            24 - 8 * ((bit >> 3) & 3) + 7 - (bit & 7))
        rp.set_row(0, words)
        _x, n = rp.walk((0, 0), nbits + 1)
        if n < int(p.nblocks[0]):
            break
    else:
        raise AssertionError("no bit flip phase A detects")
    want, _ = _check(words, hf.nbits, p.nblocks, p.dc_luma, p.ac_luma,
                     p.tables, p.bps, p.pattern, SMALL)
    assert want[1].tolist() == [True]


def _unsyncable(nblocks=400):
    """A row that never resynchronises: DC size 0 and the AC EOB both
    code as "00", so a block of no coefficients is 4 zero bits, after a
    first block of 5 bits (DC size 2, EOB).  A walk begun off the true
    boundaries reads the same symbols a bit or more out of phase forever,
    so every guess is wrong and the true states travel from chunk 0
    through every subsequence and every chunk."""
    dc = scan_rows._dht([2, 3, 3, 3, 3, 4, 4, 5, 5, 6, 6, 7], list(range(12)))
    ac = scan_rows._dht([2] + [4] * 4 + [6] * 10,
                        [0x00, 0x01, 0x02, 0x11, 0xF0]
                        + [0x03, 0x04, 0x05, 0x12, 0x21, 0x31, 0x41, 0x13,
                           0x51, 0x61])
    tabs = [(dc, ac), (dc, ac)]
    # DC size 2 is the second 3-bit code, 011, then 2 value bits; EOB 00
    bits = "01111" + "00" + "0000" * (nblocks - 1)
    bits += "1" * (-len(bits) % 8)
    data = int(bits, 2).to_bytes(len(bits) // 8, "big")
    words, nbits = scan_rows.word_matrix([data])
    tab = scan_rows.decode_tables([(dc, ac), (dc, ac)])
    one = np.ones(1, np.int32)
    return words, nbits, one * nblocks, one, one, tab, nblocks, \
        thd.NO_PATTERN


def test_never_resynchronises():
    """_unsyncable: the replay's guesses all fail, the walks run ahead
    with the true states through the subsequences of a chunk and every
    chunk's look-back finds its guess wrong; bstart equals the plain
    version's all the same."""
    want, stats = _check(*_unsyncable(), TINY)
    assert not want[1].any()
    assert stats["redo"] >= 5 and stats["ahead"] > 20
