"""PyTorch port, the DC fix-up: the port's dc_fixup (its plain version on
the CPU) against the JAX package's XLA _dc_fixup_t on the same seeded
rows, and the schedule of csrc/dc_fixup.cu replayed in numpy (its
constants parsed from the source) against the plain version: tiles of
whole rows or chained tiles, each thread's segmented scan, the warps'
shuffle scans, the CTA's scan of its warps and the look-back carries of
chained tiles.  The kernel itself runs in tests/test_torch_kernels.py
and tests/test_torch_kernels_fixup_scan.py on a card."""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpujpeg_tpu.models import decoder as jdec
from gpujpeg_tpu_torch.models import decoder as tdec
from tests.test_torch_kernels import FIXUP_CASES, dc_coefs, fixup_plan
from tests import torch_threads  # noqa: F401

SOURCE = os.path.join(os.path.dirname(tdec.__file__), os.pardir, "csrc",
                      "dc_fixup.cu")


def _const(name: str) -> int:
    with open(SOURCE) as f:
        src = f.read()
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    names = set(re.findall(r"\bk[A-Z]\w*", m.group(1)))
    return int(eval(m.group(1), {}, {k: _const(k) for k in names}))


def test_constants_match_source():
    """The wrapper's slots a vector, tile size and vectors a thread are
    the kernel's; a look-back round reads 8 records a lane."""
    assert tdec.DC_PER == _const("kVecSlots")
    assert tdec.DC_TILE == _const("kTile") \
        == _const("kThreads") * _const("kVecSlots")
    assert tdec.DC_THREAD_VECS == _const("kMaxThreadVecs")
    assert tdec.DC_CHAIN_VECS == _const("kChainVecs")
    assert _const("kChainTile") == _const("kTile") * _const("kChainVecs")
    assert _const("kLookBack") == 32 * 8
    assert _const("kWarps") == _const("kThreads") // 32


def _layout(nseg, bps, aligned=True):
    """The source's layout(): a thread's 8, 16 or 24 slots whole rows
    (aligned rows only), else a tile of whole rows where lcm(bps, 8) <=
    kTile, else chained tiles of kChainTile slots."""
    per, tile = _const("kVecSlots"), _const("kTile")
    for vecs in range(1, _const("kMaxThreadVecs") + 1):
        if aligned and per * vecs % bps == 0:
            return tile * vecs, -(-nseg * bps // (tile * vecs)), vecs, \
                "thread"
    lcm = bps // math.gcd(bps, per) * per
    if lcm <= tile:
        slots, vecs, mode = tile // lcm * lcm, 1, "tile"
    else:
        slots, vecs, mode = _const("kChainTile"), _const("kChainVecs"), \
            "chained"
    return slots, -(-nseg * bps // slots), vecs, mode


def _combine(af, as_, bf, bs):
    """Span a then span b: (a row starts in either, the sums since the
    last start)."""
    return af | bf, np.where(bf[..., None], bs, as_ + bs)


def _replay(dc: np.ndarray, nseg: int, bps: int, ent, seed: int,
            aligned: bool = True):
    """dc_fixup.cu's schedule on the DC row dc (int16): the layout's kP
    slots a thread, its first slot's place in its row from one division,
    its row starts as a mask and its slots' components from one shift of
    the MCU's component sequence (ext), its own segmented scan; past the
    "thread" layout the warp's Hillis-Steele scan of the threads'
    aggregates (shfl_up by 1, 2, ..., 16), the CTA's walk over its warps'
    aggregates, and for chained tiles the records (inclusive at once where
    a row starts in the tile) and the look-back in rounds of kLookBack
    records back to the nearest inclusive one, each predecessor without a
    row start seen published as an aggregate or, once its own look-back
    ended, as inclusive (seeded); all modulo 2^32, stored modulo 2^16."""
    threads, per = _const("kThreads"), _const("kVecSlots")
    rnd = _const("kLookBack")
    bpm = len(ent)
    nc = max(ent) + 1
    ext = sum(ent[f % bpm] << 2 * f for f in range(32))
    L = nseg * bps
    slots, tiles, vecs, mode = _layout(nseg, bps, aligned)
    assert (slots, tiles, vecs, mode) == tdec.fixup_layout(nseg, bps,
                                                           aligned)
    kp = per * vecs
    t0 = np.arange(tiles, dtype=np.int64) * slots
    g0 = t0[:, None] + np.arange(threads, dtype=np.int64)[None] * kp
    end = np.minimum(t0 + slots, L)[:, None]
    flat = dc.astype(np.int64).astype(np.uint32)
    x = np.zeros((tiles, threads, kp), np.uint32)
    for k in range(kp):
        ok = g0 + k < end
        x[..., k][ok] = flat[(g0 + k)[ok]]
    jt = t0 % bps
    j0 = (jt[:, None] + np.arange(threads)[None] * kp) % bps
    if mode == "thread":
        assert not j0.any()
    seq = np.right_shift(np.uint64(ext), (2 * (j0 % bpm)).astype(np.uint64))
    k0 = np.where(j0 == 0, 0, bps - j0)
    ks = np.arange(kp)
    starts = (ks >= k0[..., None]) & ((ks - k0[..., None]) % bps == 0)
    comp = ((seq[..., None] >> (2 * ks).astype(np.uint64)) & 3) \
        .astype(np.int64)

    # each thread: x[k] the sum since its last row start; `open` before
    # the thread's first row start
    f = starts.any(-1)
    opn = np.cumsum(starts, -1) == 0
    s = np.zeros((tiles, threads, nc), np.uint32)
    for k in range(kp):
        s[starts[..., k]] = 0
        onehot = comp[..., k, None] == np.arange(nc)
        s = s + np.where(onehot, x[..., k:k + 1], 0).astype(np.uint32)
        x[..., k] = np.take_along_axis(s, comp[..., k, None], -1)[..., 0]
    if mode != "thread":
        # the warp's inclusive scan, then the exclusive one of each lane
        wf = f.reshape(tiles, -1, 32)
        ws = s.reshape(tiles, -1, 32, nc)
        d = 1
        while d < 32:
            yf = np.zeros_like(wf)
            ys = np.zeros_like(ws)
            yf[..., d:] = wf[..., :-d]
            ys[..., d:, :] = ws[..., :-d, :]
            nf, ns = _combine(yf, ys, wf, ws)
            lanes = np.arange(32) >= d
            wf = np.where(lanes, nf, wf)
            ws = np.where(lanes[:, None], ns, ws)
            d <<= 1
        bf = np.zeros_like(wf)
        bs = np.zeros_like(ws)
        bf[..., 1:] = wf[..., :-1]
        bs[..., 1:, :] = ws[..., :-1, :]
        # the CTA: each warp's aggregates before it, the tile's in the end
        rf = np.zeros(tiles, bool)
        rs = np.zeros((tiles, nc), np.uint32)
        for w in range(wf.shape[1]):
            bf[:, w], bs[:, w] = _combine(rf[:, None], rs[:, None],
                                          bf[:, w], bs[:, w])
            rf, rs = _combine(rf, rs, wf[:, w, 31], ws[:, w, 31])
        before_f = bf.reshape(tiles, threads)
        before_s = bs.reshape(tiles, threads, nc)
        if mode == "chained":
            rng = np.random.default_rng(seed)
            inc = np.zeros((tiles, nc), np.uint32)
            for t in range(tiles):
                carry = np.zeros(nc, np.uint32)
                if jt[t]:
                    hi = t
                    while True:
                        p = np.arange(hi - 1, hi - 1 - rnd, -1)
                        seen_inc = (p < 0) | rf[np.maximum(p, 0)] \
                            | (rng.random(rnd) < 0.5)
                        if seen_inc.any():
                            first = int(np.argmax(seen_inc))
                            carry += rs[p[:first]].sum(0, dtype=np.uint32)
                            carry += inc[p[first]]
                            break
                        carry += rs[p].sum(0, dtype=np.uint32)
                        hi -= rnd
                    before_s[t][~before_f[t]] += carry
                inc[t] = rs[t] if rf[t] else carry + rs[t]
        else:
            assert not jt.any()          # a tile starts a row
        add = np.take_along_axis(before_s[..., None, :], comp[..., None],
                                 -1)[..., 0]
        x += np.where(opn, add, 0).astype(np.uint32)
    # slots past a tile's end hold nothing: gather each tile's own
    keep = (np.arange(threads * kp)[None] < slots) \
        & (t0[:, None] + np.arange(threads * kp)[None] < L)
    out = x.reshape(tiles, -1)[keep]
    return out.astype(np.uint16).view(np.int16)


#: rows that end inside a tile, span tiles exactly, and span many; the
#: 8K restart-0 rows (planar 4:4:4, a scan a row; interleaved 4:2:0)
REPLAY_CASES = [(1, 3 * 8192, (0,)), (2, 8196, (0, 0, 1, 2, 3, 3)),
                (5, 3000, (0,)), (3, 4096, (0, 0, 1, 2)), (400, 7, (0,)),
                (11, 1, (0,)), (2, 40 * 2048 + 4, (0, 0, 1, 2)),
                (3, 518400, (0,)), (1, 777600, (0, 0, 0, 0, 1, 2))]


@pytest.mark.parametrize("nseg,bps,ent", FIXUP_CASES + REPLAY_CASES)
def test_tile_scheme_replay(nseg, bps, ent):
    """The kernel's schedule gives the plain version's sums, DC
    differences of the full 12-bit range (sums wrap past int16), in every
    layout: whole rows a thread, a tile of whole rows, chained tiles; and
    with the row off 16-byte alignment, where no thread takes whole
    rows."""
    x = dc_coefs(bps + nseg, nseg, bps)
    want = tdec._dc_fixup_t(x.clone(), nseg, bps,
                            fixup_plan(bps, ent).comp_slots)[0].numpy()
    for aligned in (True, False):
        got = _replay(x[0].numpy(), nseg, bps, ent, nseg + bps, aligned)
        assert np.array_equal(got, want)


def _slot_comp(bps, ent):
    return np.tile(np.asarray(ent), bps // len(ent))


@pytest.mark.parametrize("nseg,bps,ent", FIXUP_CASES[:6])
def test_port_equals_jax(nseg, bps, ent):
    """dc_fixup on the CPU equals the JAX package's _dc_fixup_t on the same
    coefficients (DC differences small enough that no sum leaves int16,
    where the two frameworks' casts are not specified alike)."""
    x = dc_coefs(nseg * 7 + bps, nseg, bps, amp=40)
    want = np.asarray(jdec._dc_fixup_t(jnp.asarray(x.numpy()),
                                       _slot_comp(bps, ent), nseg, bps))
    got = tdec.dc_fixup(x.clone(), fixup_plan(bps, ent))
    assert np.array_equal(got.numpy(), want)


def test_wrapper_refuses_bad_coefficients():
    """dc_fixup takes (64, nseg * bps) int16 coefficients, on any
    device."""
    plan = fixup_plan(8, (0,))
    for bad in (torch.zeros((64, 16), dtype=torch.int32),
                torch.zeros((63, 16), dtype=torch.int16),
                torch.zeros((64, 12), dtype=torch.int16)):
        with pytest.raises(ValueError, match="int16"):
            tdec.dc_fixup(bad, plan)


def test_layout_and_scratch():
    """fixup_layout follows the source's rule (the 8K layouts: whole rows
    a thread at 6 and 8 slots a row, chained tiles at restart interval
    0); the chained layout's records are a status word a tile padded to
    16 bytes and two 16-byte sums a tile; a plan whose tiles hold whole
    rows keeps no records."""
    for nseg, bps in ((5000, 8), (3000, 6), (7, 65), (3, 518400),
                      (1, 777600), (9, 2048), (2, 4096), (4, 16), (9, 5)):
        for aligned in (True, False):
            assert tdec.fixup_layout(nseg, bps, aligned) == \
                _layout(nseg, bps, aligned)
    assert tdec.fixup_layout(194400, 8) == (2048, 760, 1, "thread")
    assert tdec.fixup_layout(129600, 6) == (6144, 127, 3, "thread")
    assert tdec.fixup_layout(129600, 6, False) == (2040, 382, 1, "tile")
    assert tdec.fixup_layout(3, 518400) == (4096, 380, 2, "chained")
    assert tdec.fixup_scratch_words(5) == 8 + 40
    plan = fixup_plan(8, (0,))
    tdec.dc_fixup(dc_coefs(1, 4, 8), plan)
    assert plan.fixup_scratch == {}
