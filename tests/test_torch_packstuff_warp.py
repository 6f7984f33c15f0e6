"""PyTorch port, the token-row packer's warp schedule: the walk of
csrc/pack_stuff_rows.cu (a warp a row, rounds of 32 quads, a lane a quad,
its tokens masked and summed, a warp exclusive scan placing them MSB first
in the warp's bit buffer, the flush of whole words past the threshold with
the partial last word carried, the warp-parallel stuffing of flush_bytes
in both of its paths, the 1-bit pad and the unstuffed marker) replayed in
Python with the kernel's own constants, read from its source.  The replay
is held against the plain version (pack_stuff_rows_plain) and against the
JAX package's Pallas deep-stuff kernel in interpret mode
(pack_stuff_fused, as tests/test_torch_packstuff.py runs it) on the rows
that kernel takes and interpret mode runs in seconds (up to T = 388 and
250 stuffed zeros a row; the plain version is held against it over more
shapes there).  The kernel
itself is held against the plain version on the card
(tests/test_torch_kernels.py)."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpujpeg_tpu.ops import fusedpack as jfp

from gpujpeg_tpu_torch.ops import fusedpack as tfp

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gpujpeg_tpu_torch", "csrc", "pack_stuff_rows.cu")


def _constants():
    """The kernel's `constexpr int` constants, evaluated in order."""
    env = {}
    with open(_SRC) as f:
        for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                     f.read(), re.M):
            env[name] = eval(expr, {}, dict(env))
    return env


K = _constants()


class _Warp:
    """One warp's state over a row: the bit buffer (Python ints as u32
    words), the bits in it, the row's bytes, and what the walk saw."""

    def __init__(self, stride):
        self.buf = [0] * K["kBufWords"]
        self.pos = 0
        self.out = bytearray(stride)
        self.outpos = 0
        self.nff = 0
        self.stats = dict(mid_flushes=0, carried=0, word_path=0,
                          scan_path=0, top_word=0)

    def put_bits(self, p, v, n):
        """bitbuf.cuh put_bits: OR n bits MSB first at bit p."""
        w, sh = p >> 5, 32 - (p & 31) - n
        if sh >= 0:
            self.buf[w] |= (v << sh) & 0xFFFFFFFF
            top = w
        else:
            self.buf[w] |= v >> -sh
            self.buf[w + 1] |= (v << (32 + sh)) & 0xFFFFFFFF
            top = w + 1
        self.stats["top_word"] = max(self.stats["top_word"], top)

    def flush_bytes(self, nbytes):
        """bitbuf.cuh flush_bytes: 32 words a pass, lane l word l; whole
        words where the pass has no 0xFF and outpos is word-aligned, else
        a warp scan of each word's bytes plus its 0xFF count."""
        nw = (nbytes + 3) >> 2
        for w0 in range(0, nw, 32):
            words, nbs, ffs = [], [], []
            for lane in range(32):
                w = w0 + lane
                nb = min(4, max(0, nbytes - 4 * w))
                word = self.buf[w] if nb else 0
                by = [(word >> (24 - 8 * q)) & 0xFF for q in range(nb)]
                words.append(by)
                nbs.append(nb)
                ffs.append(by.count(0xFF))
            chunk = min(nbytes - 4 * w0, 128)
            if not any(ffs) and self.outpos % 4 == 0:
                self.stats["word_path"] += 1
                for lane, by in enumerate(words):
                    o = self.outpos + 4 * lane
                    self.out[o:o + len(by)] = bytes(by)
                self.outpos += chunk
                continue
            self.stats["scan_path"] += 1
            mine = [nb + ff for nb, ff in zip(nbs, ffs)]
            incl = np.cumsum(mine)
            for lane, by in enumerate(words):
                o = self.outpos + int(incl[lane]) - mine[lane]
                for b in by:
                    self.out[o] = b
                    o += 1
                    if b == 0xFF:
                        self.out[o] = 0
                        o += 1
            self.nff += int(incl[-1]) - chunk
            self.outpos += int(incl[-1])


def replay(bits, lens, markers, stride):
    """The kernel's walk of every row, as numpy arrays: (rows (R, stride)
    uint8, row_bytes, needs, stats summed over the rows)."""
    R, T = lens.shape
    nq = T // 4
    rq, kq = K["kRoundQuads"], K["kQ"]
    nc = -(-nq // rq) if nq else 1
    rows = np.zeros((R, stride), np.uint8)
    row_bytes = np.zeros(R, np.int32)
    needs = [0, 0]
    stats = {}
    lane_q = (np.arange(32)[:, None] * kq + np.arange(kq)[None, :])
    for s in range(R):
        wp = _Warp(stride)
        for c in range(nc):
            q = c * rq + lane_q                         # (32, kQ) quads
            ok = q < nq
            slots = (4 * q[..., None] + np.arange(4)).reshape(32, -1)
            okt = np.repeat(ok, 4, axis=1)
            n = np.where(okt, lens[s][np.minimum(slots, T - 1)], 0)
            v = np.where(okt, bits[s][np.minimum(slots, T - 1)], 0)
            v = v.astype(np.int64) & ((1 << n.astype(np.int64)) - 1)
            mine = n.sum(axis=1)
            at = wp.pos + np.cumsum(mine) - mine        # exclusive scan
            for lane in range(32):
                a = int(at[lane])
                for t in range(n.shape[1]):
                    if n[lane, t]:
                        wp.put_bits(a, int(v[lane, t]), int(n[lane, t]))
                        a += int(n[lane, t])
            wp.pos += int(mine.sum())
            if (wp.pos >> 5) > K["kFlushWords"]:        # whole words out
                nw = wp.pos >> 5
                wp.flush_bytes(4 * nw)
                part = wp.buf[nw]
                wp.buf[:nw + 1] = [0] * (nw + 1)
                wp.buf[0] = part
                wp.pos &= 31
                wp.stats["mid_flushes"] += 1
                wp.stats["carried"] += int(part != 0)
        if wp.pos & 7:                                  # F.1.2.3
            pl = 8 - (wp.pos & 7)
            wp.put_bits(wp.pos, (1 << pl) - 1, pl)
            wp.pos += pl
        wp.flush_bytes(wp.pos >> 3)
        assert not any(wp.buf[(wp.pos >> 3) + 3 >> 2:]), "bits past the row"
        if markers[s]:
            wp.out[wp.outpos:wp.outpos + 2] = bytes([0xFF, int(markers[s])])
            wp.outpos += 2
        assert wp.stats["top_word"] < K["kBufWords"], "bit buffer overrun"
        rows[s] = np.frombuffer(bytes(wp.out), np.uint8)
        row_bytes[s] = wp.outpos
        needs = [max(needs[0], wp.nff), max(needs[1], wp.outpos)]
        for k, x in wp.stats.items():
            stats[k] = max(stats.get(k, 0), x) if k == "top_word" \
                else stats.get(k, 0) + x
    return rows, row_bytes, np.asarray(needs, np.int32), stats


def _tokens(rng, R, T, density=0.5, ff=False):
    lens = rng.integers(1, 28, (R, T)).astype(np.int32)
    lens = np.where(rng.random((R, T)) < density, lens, 0).astype(np.int32)
    if ff:                                   # all-ones 27-bit tokens
        lens = np.where(lens > 0, 27, 0).astype(np.int32)
        bits = np.full((R, T), (1 << 27) - 1, np.int64)
    else:
        bits = rng.integers(0, 1 << 31, (R, T))
    # bits above a token's length are set: the kernel masks them
    return bits.astype(np.uint32).view(np.int32), lens


def _markers(R):
    r = np.arange(R)
    return np.where(r % 3 != 2, 0xD0 + r % 8, 0).astype(np.int32)


def _stride(lens):
    return -(-(2 * -(-int(lens.sum(axis=1).max()) // 8) + 2) // 16) * 16


def _jax_rows(bits, lens, markers, z_cap):
    """The JAX package's pack_stuff_fused in interpret mode, its stuffing
    steps cut to z_cap (at least the rows' stuffed zeros) -> the rows'
    bytes and its needs vector."""
    mask = np.where(lens > 0, (1 << lens.astype(np.int64)) - 1, 0)
    b = (bits.view(np.uint32).astype(np.int64) & mask).astype(np.uint32)
    nbits = int(lens.sum(axis=1).max())
    w_out = (2 * nbits // 8 + 8) // 4 + 4
    r, ob, jneeds = jfp.pack_stuff_fused(
        jnp.asarray(b), jnp.asarray(lens), markers.astype(np.uint32), l0=0,
        z_cap=z_cap, w_out=w_out, interpret=True)
    ob, jneeds = np.asarray(ob), np.asarray(jneeds)
    by = np.ascontiguousarray(np.asarray(r).astype(">u4")).view(
        np.uint8).reshape(len(ob), -1)
    return [by[i, :ob[i]].tobytes() for i in range(len(ob))], jneeds


CASES = {
    # all-ones 27-bit tokens: every byte 0xFF, flushes through the scan
    # path, the partial word carried across them.  1,296 stuffed zeros a
    # row are past the JAX kernel's fused stuffing (exact to 250 a row; its
    # encoder takes the XLA tree beyond), so this row is held against the
    # plain version only, and a short one against both
    "all_ones_27": dict(R=3, T=384, density=0.9, ff=True, jax=False),
    "all_ones_27_short": dict(R=2, T=32, density=1.0, ff=True, jax=True),
    # rows longer than the buffer: several flushes a row
    "T4096": dict(R=2, T=4096, density=0.5, jax=False),
    "T4096_all_ones": dict(R=1, T=4096, density=0.7, ff=True, jax=False),
    "T4": dict(R=7, T=4, density=0.7, jax=True),
    # not a multiple of a round's 128 slots: a last round of one quad
    "T388": dict(R=3, T=388, density=0.3, jax=True),
    # empty rows, with and without a marker
    "empty_rows": dict(R=7, T=4, density=0.0, jax=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_replay_matches_plain_and_jax(name):
    c = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name) + 40)
    bits, lens = _tokens(rng, c["R"], c["T"], c["density"], c.get("ff"))
    markers = _markers(c["R"])
    if name == "empty_rows":
        lens[1, 2] = 3                       # one row with a token
        markers[:] = 0                       # and no marker at all
        markers[4] = 0xD4
    stride = _stride(lens)
    rows, rb, needs, stats = replay(bits, lens, markers, stride)
    p_rows, p_rb, p_needs = tfp.pack_stuff_rows_plain(
        torch.from_numpy(bits), torch.from_numpy(lens),
        torch.from_numpy(markers), stride)
    assert np.array_equal(rb, p_rb.numpy())
    assert np.array_equal(needs, p_needs.numpy())
    got = [rows[i, :rb[i]].tobytes() for i in range(len(rb))]
    assert got == [p_rows[i, :rb[i]].numpy().tobytes()
                   for i in range(len(rb))]
    if c["jax"]:
        j_rows, j_needs = _jax_rows(bits, lens, markers, int(needs[0]) + 1)
        assert got == j_rows
        assert np.array_equal(needs, j_needs[-2:])
    if name == "empty_rows":
        assert got[0] == b"" and got[4] == b"\xff\xd4"
    if c.get("ff"):
        assert stats["scan_path"] > 0 and needs[0] > 0
    if c["T"] >= 384 and c["density"] >= 0.5:
        assert stats["mid_flushes"] >= 2 and stats["carried"] > 0
        assert stats["top_word"] > K["kFlushWords"]
    if name == "T4096":
        assert stats["word_path"] > 0


def test_buffer_holds_a_round_past_the_threshold():
    """The buffer's sizing: a round that starts just under the flush
    threshold (the worst carry) and adds 32 lanes x 4 all-ones 27-bit
    tokens, then the pad, stays inside the buffer."""
    start = (K["kFlushWords"] + 1) * 32 - 1
    top = start + 32 * K["kQ"] * 4 * 27 - 1
    assert K["kRoundWords"] * 32 >= 32 * K["kQ"] * 4 * 27
    assert (top >> 5) < K["kBufWords"]
    # after a round that left at most kFlushWords words, the pad of up to
    # 7 bits and the flush read no further than the buffer
    assert ((K["kFlushWords"] + 1) * 32 + 7 + 31) // 32 <= K["kBufWords"]
