"""PyTorch port, the token-row packer's scan instance (csrc/
pack_stuff_rows.cu, pack_stuff_scan_kernel): its schedule replayed in
Python with the kernel's own constants, read from its source, and at
small chunks (a few tokens a thread, a few threads a CTA, so that a short
row has dozens of chunks): a CTA scan of each thread's bit count, the
look-back over the chunks' bit sums (aggregates summed 32 chunks a step
back to the nearest inclusive record), the previous chunk's last tokens
read again into the head of the chunk's bit buffer, each thread's tokens
placed MSB first (its first and last words ORed, the words between
stored), the 1-bit pad, the owned bytes stuffed into a staging row placed
by a scan of each thread's bytes and 0xFF count, the look-back over the
chunks' 0xFF counts, and the marker, row length and needs.  The replay is
held against the plain version (pack_stuff_rows_plain on the tokens as
one row, the CPU path of fusedpack.pack_stuff_scan) and against the host
packer (native.pack_tokens) on 0xFF bytes across chunk edges, runs of
0xFF, a pad that makes 0xFF, one token and no token, with and without a
marker.  The kernel itself is held against the plain version on the card
(tests/test_torch_kernels.py).  Imports no JAX."""

import os
import re

import numpy as np
import pytest
import torch

from gpujpeg_tpu_torch import native
from gpujpeg_tpu_torch.ops import fusedpack as tfp

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gpujpeg_tpu_torch", "csrc", "pack_stuff_rows.cu")


def _constants():
    """The kernel's `constexpr int` constants, evaluated in order."""
    env = {}
    with open(_SRC) as f:
        for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                     f.read(), re.M):
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


K = _constants()
#: the kernel's schedule: (threads a CTA, tokens a thread)
KERNEL = (K["kScanThreads"], K["kScanTok"])
SMALL = (4, 3)
TINY = (2, 1)


def _words_of(threads, per):
    """kChunkWords and kStageBytes of a schedule, by the source's
    formulas."""
    w = (31 + threads * per * 27 + 7 + 31) // 32 + 1
    return w, 8 * w


def _look_back(recs, k, fld, stats):
    """Warp 0's sum of the aggregates before chunk k (field fld), or None
    where the kernel would spin: 32 records a step, on past a window of
    aggregates, up to the nearest inclusive one."""
    acc, j = 0, k - 1
    while True:
        lanes = [recs[j - i] if j - i >= 0 else {fld: 2, fld + 2: 0}
                 for i in range(32)]
        flags = [r[fld] for r in lanes]
        i = flags.index(2) if 2 in flags else 32
        if 0 in flags[:i]:
            return None
        acc += sum(r[fld + 1] for r in lanes[:i])
        if i < 32:
            return acc + lanes[i][fld + 2]
        stats["windows"] += 1
        j -= 32


def _resolve(recs, fld, agg, stats):
    """Every chunk publishes its aggregate (chunk 0 its inclusive sum),
    then the later chunks look back first, so that windows of aggregates
    are summed; -> each chunk's sum of the chunks before it."""
    n = len(agg)
    for k in range(n):
        recs[k][fld], recs[k][fld + 1] = (2, 0) if k == 0 else (1, agg[k])
        if k == 0:
            recs[k][fld + 2] = agg[0]
    before = [0] * n
    pending = list(range(1, n))
    while pending:
        done = []
        for k in reversed(pending):
            b = _look_back(recs, k, fld, stats)
            if b is None:
                continue
            before[k] = b
            recs[k][fld], recs[k][fld + 2] = 2, b + agg[k]
            done.append(k)
        assert done
        pending = [k for k in pending if k not in done]
    return before


def replay(bits, lens, marker, stride, sched=KERNEL):
    """The scan instance over one row of tokens -> (rows (1, stride),
    row_bytes (1,), needs (2,)) and the schedule's counts."""
    threads, per = sched
    words_cap, stage_cap = _words_of(threads, per)
    bits = [int(b) & 0xFFFFFFFF for b in np.asarray(bits)]
    lens = [int(x) for x in np.asarray(lens)]
    n = len(bits)
    ct = threads * per
    nchunk = max(1, -(-n // ct))
    stats = dict(windows=0, head_tokens=0, or_words=0, stored_words=0)
    recs = [{0: 0, 3: 0} for _ in range(nchunk)]
    out = bytearray(stride)

    def tok(i):
        return bits[i] & ((1 << lens[i]) - 1), lens[i]

    # 1. each thread's bits, the chunks' sums, the chunks' first bits
    mine = [[sum(lens[c * ct + t * per + k] for k in range(per)
                 if c * ct + t * per + k < n) for t in range(threads)]
            for c in range(nchunk)]
    offs = _resolve(recs, 0, [sum(m) for m in mine], stats)
    bufs, owned, ends = [], [], []
    for c in range(nchunk):
        last = c == nchunk - 1
        off = offs[c]
        hb = off & 31
        buf = [0] * words_cap
        written = set()

        def put(p, v, nb):                      # bitbuf.cuh put_bits
            assert 1 <= nb <= 32 and v < (1 << nb)
            w, sh = p >> 5, 32 - (p & 31) - nb
            if sh >= 0:
                buf[w] |= v << sh
            else:
                buf[w] |= v >> -sh
                buf[w + 1] |= (v << (32 + sh)) & 0xFFFFFFFF

        # 2. the previous chunk's bits in word off / 32, 32 tokens a step
        if c > 0 and hb:
            after, g = 0, c * ct - 1
            while g >= 0 and after < hb:
                step = [tok(g - lane) if g - lane >= 0 else (0, 0)
                        for lane in range(32)]
                incl = np.cumsum([l for _, l in step])
                for lane, (bv, l) in enumerate(step):
                    hi = hb - (after + int(incl[lane]) - l)
                    if l > 0 and hi > 0:
                        lo = max(hi - l, 0)
                        put(lo, bv & ((1 << (hi - lo)) - 1), hi - lo)
                        stats["head_tokens"] += 1
                after += int(incl[-1])
                g -= 32
        # this chunk's tokens, a thread's words ORed at its ends
        excl = 0
        for t in range(threads):
            p = hb + excl
            w, na, acc, first = p >> 5, p & 31, 0, True
            for k in range(per):
                i = c * ct + t * per + k
                if i >= n or lens[i] == 0:
                    continue
                bv, l = tok(i)
                acc |= bv << (64 - na - l)
                na += l
                if na >= 32:
                    word = acc >> 32
                    if first:
                        buf[w] |= word
                        stats["or_words"] += 1
                    else:                  # wholly this thread's
                        assert buf[w] == 0 and w not in written
                        buf[w] = word
                        stats["stored_words"] += 1
                    written.add(w)
                    first = False
                    w += 1
                    acc = (acc << 32) & ((1 << 64) - 1)
                    na -= 32
            if na > 0:
                buf[w] |= acc >> 32
            excl += mine[c][t]
        end = hb + sum(mine[c])
        if last and end & 7:                     # F.1.2.3: 1-bits
            pl = 8 - (end & 7)
            put(end, (1 << pl) - 1, pl)
            end += pl
        assert (end + 31) // 32 <= words_cap
        bufs.append(buf)
        ends.append(end)
        owned.append(end >> 3 if last else 4 * (end >> 5))
    # 3. the owned bytes, stuffed, and the chunks' places
    stages = []
    for c in range(nchunk):
        ob = owned[c]
        nw = (ob + 3) >> 2
        q = -(-nw // threads)
        stage = bytearray()
        for t in range(threads):
            for w in range(min(t * q, nw), min(t * q + q, nw)):
                for b in range(min(4, ob - 4 * w)):
                    byte = (bufs[c][w] >> (24 - 8 * b)) & 0xFF
                    stage.append(byte)
                    if byte == 0xFF:
                        stage.append(0)
        assert len(stage) <= stage_cap
        stages.append(stage)
    ffs = [len(s) - o for s, o in zip(stages, owned)]
    ff_before = _resolve(recs, 3, ffs, stats)
    at = 0
    for c in range(nchunk):
        at = 4 * (offs[c] >> 5) + ff_before[c]
        out[at:at + len(stages[c])] = stages[c]
    total = at + len(stages[-1])
    if marker:
        out[total:total + 2] = bytes([0xFF, marker])
        total += 2
    rows = torch.frombuffer(out, dtype=torch.uint8).reshape(1, stride)
    needs = torch.tensor([ff_before[-1] + ffs[-1], total], dtype=torch.int32)
    return (rows.clone(), torch.tensor([total], dtype=torch.int32), needs,
            stats, nchunk)


def _check(bits, lens, marker, sched, stride=None):
    """The replay against the plain version and the host packer."""
    b = torch.as_tensor(np.asarray(bits, np.int64).astype(np.int32))
    ln = torch.as_tensor(np.asarray(lens, np.int32))
    if stride is None:
        stride = -(-2 * int(ln.sum()) // 32) * 4 + 16
    rows, rb, needs, stats, nchunk = replay(b, ln, marker, stride, sched)
    p_rows, p_rb, p_needs = tfp.pack_stuff_scan(b, ln, marker, stride)
    nbytes = int(rb[0])
    assert int(p_rb[0]) == nbytes
    assert torch.equal(rows[0, :nbytes], p_rows[0, :nbytes])
    assert torch.equal(needs, p_needs)
    host = native.pack_tokens(b.numpy().astype(np.uint32), ln.numpy())
    assert bytes(rows[0, :nbytes - (2 if marker else 0)].numpy()) == host
    return stats, nchunk, bytes(rows[0, :nbytes].numpy())


def _tokens(rng, n, ones=0.0):
    """n tokens of 1-27 bits (most short, as Huffman codes with their
    value bits), a share `ones` of them all one bits."""
    lens = np.minimum(1 + rng.geometric(0.15, n), 27).astype(np.int32)
    bits = rng.integers(0, 1 << 27, n).astype(np.int64)
    all1 = rng.random(n) < ones
    bits[all1] = (1 << lens[all1].astype(np.int64)) - 1
    return bits, lens


def test_constants_match_the_wrapper():
    """fusedpack sizes the scratch with the kernel's constants; the
    buffer holds a chunk's worst case."""
    assert K["kChunkTok"] == K["kScanThreads"] * K["kScanTok"] \
        == tfp.SCAN_CHUNK_TOKENS
    assert (K["kScanRec"], K["kScanHead"]) == (tfp.SCAN_REC, tfp.SCAN_HEAD)
    assert (K["kChunkWords"], K["kStageBytes"]) == _words_of(*KERNEL)
    assert 4 * K["kChunkWords"] + K["kStageBytes"] < 48 * 1024
    assert tfp.scan_chunks(0) == 1
    assert tfp.scan_chunks(K["kChunkTok"] + 1) == 2


@pytest.mark.parametrize("sched", [TINY, SMALL, KERNEL],
                         ids=["tiny", "small", "kernel"])
@pytest.mark.parametrize("marker", [0, 0xD5])
def test_random_rows(sched, marker):
    """Seeded token rows long enough for dozens of chunks at the small
    schedules (windows of 32 aggregates summed) and several at the
    kernel's: equal to the plain version and to the host packer."""
    rng = np.random.default_rng(11)
    n = 3000 if sched != KERNEL else 3 * K["kChunkTok"] + 77
    stats, nchunk, _ = _check(*_tokens(rng, n, 0.1), marker, sched)
    assert nchunk >= 3 and stats["head_tokens"] > 0
    if sched[1] > 1:            # a thread's words between its first, last
        assert stats["stored_words"] > 0
    if sched != KERNEL:
        assert stats["windows"] > 0


@pytest.mark.parametrize("sched", [TINY, SMALL], ids=["tiny", "small"])
def test_ff_runs_across_chunk_edges(sched):
    """Runs of one bits: most bytes 0xFF, many of them made of two chunks'
    tokens; every token one bits, and a row of 27-bit tokens whose
    0xFF bytes straddle every chunk edge."""
    rng = np.random.default_rng(12)
    _s, _n, data = _check(*_tokens(rng, 2000, 0.9), 0xD0, sched)
    assert data.count(b"\xff\x00") > 1000
    lens = np.full(500, 27, np.int32)
    _s, _n, data = _check((1 << 27) - 1 + np.zeros(500, np.int64), lens, 0,
                          sched)
    assert data.count(b"\xff\x00") == -(-500 * 27 // 8)


def test_pad_makes_ff():
    """Bits that end 4 one bits into a byte: the 1-bit pad completes a
    0xFF, which is stuffed; and a pad after a zero bit, which is not."""
    for tail, want in ((0b1111, b"\xff\x00"), (0b1110, b"\xef")):
        bits = np.asarray([0x3F, 0x3, tail], np.int64)
        lens = np.asarray([6, 2, 4], np.int32)
        for sched in (TINY, KERNEL):
            _s, _n, data = _check(bits, lens, 0, sched)
            assert data.endswith(want)


@pytest.mark.parametrize("marker", [0, 0xD7])
def test_one_token_and_none(marker):
    """One token (a byte and a pad), and no token at all: no bytes, the
    marker alone."""
    _s, nchunk, data = _check([0x5], [3], marker, SMALL)
    assert nchunk == 1 and data[:1] == b"\xbf"
    _s, nchunk, data = _check(np.zeros(0, np.int64), np.zeros(0, np.int32),
                              marker, SMALL, stride=16)
    assert nchunk == 1
    assert data == (bytes([0xFF, marker]) if marker else b"")


def test_zero_length_slots():
    """Zero-length slots mixed in (the packer's contract allows them; the
    scan's tokens have none) and bits above a token's length ignored."""
    rng = np.random.default_rng(13)
    bits, lens = _tokens(rng, 1500, 0.3)
    lens[rng.random(1500) < 0.4] = 0
    bits |= np.int64(0x7) << 28 & 0x7FFFFFFF
    _check(bits, lens, 0xD2, SMALL)
    _check(bits, lens, 0, TINY)


def test_scan_rows_stride_has_no_int32_limit():
    """scan_rows takes a scan whose worst-case row passes 2^31 bytes
    (15360x8640 interleaved 4:4:4): the stride is an int64 of the scan
    instance, no refusal (on the card it packs, tests/test_torch_kernels
    .py); on the CPU the plain version packs the same tokens."""
    tabs = tfp.class_tables(75, True, "cpu")
    st = tfp.SlotTables((tabs, tabs), (0, 1, 1), (0, 1, 2))
    assert st.stride(3 * 2073600) > (1 << 31) - 1
    rng = np.random.default_rng(14)
    bits, lens = _tokens(rng, 100)
    b = torch.from_numpy(bits.astype(np.int32))
    ln = torch.from_numpy(lens)
    rows, rb, needs = tfp.scan_rows(b, ln, 3, st, 0xD1)
    assert rows.shape == (1, st.stride(3))
    want = native.pack_tokens(bits.astype(np.uint32), lens)
    assert bytes(rows[0, :int(rb[0])].numpy()) == want + b"\xff\xd1"
