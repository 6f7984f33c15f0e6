"""PyTorch port, on the card: the DC fix-up's kernel (csrc/dc_fixup.cu: one
launch on every shape, tiles of whole rows or tiles chained by a
look-back over records kept on the plan) and phase A's four-set instances
(csrc/huffdec_scan.cu huffdec_scan_sets_kernel: dynamic shared memory
sized to the sets a launch loads), each against its plain version.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_fixup_scan.py -q

The tests decide inside the ``cuda`` fixture whether a card exists and
skip without one.  tests/test_torch_dc_fixup.py and
tests/test_torch_scan_sets.py replay both designs on the CPU.
"""

import ctypes

import numpy as np
import pytest
import torch

from gpujpeg_tpu_torch.models import decoder as tdec
from gpujpeg_tpu_torch.ops import _kernels
from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
from tests import scan_rows
from tests.test_torch_kernels import (  # noqa: F401 (cuda: the fixture)
    FIXUP_CASES, FOUR_SET_CASES, _four_set_rows, cuda, dc_coefs,
    fixup_plan)

# -- the DC fix-up ------------------------------------------------------------

#: slots a row from 1 to past two tiles: whole-row tiles (lcm(bps, 8) <=
#: 2048), and chained ones (1,000 slots tile whole; 1,500, 2,049 and more
#: chain)
FIXUP_BPS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 24, 40, 63, 64, 65, 127,
             255, 256, 511, 1000, 1023, 1024, 1500, 1536, 2047, 2048, 2049,
             2050, 3000, 4095, 4096, 4097, 6144, 6150]

#: every slot pattern of FIXUP_CASES, and one of four components
FIXUP_ENTS = sorted({ent for _n, _b, ent in FIXUP_CASES}
                    | {(0, 0, 1, 2, 3, 3)}, key=len)


def _fixup_check(cuda, nseg, bps, ent, seed, offset=0):
    """dc_fixup on the card (its coefficients `offset` int16 past a
    16-byte boundary) against _dc_fixup_t on the CPU, in one counted
    launch."""
    x = dc_coefs(seed, nseg, bps)
    want = tdec._dc_fixup_t(x.clone(), nseg, bps,
                            fixup_plan(bps, ent).comp_slots)
    buf = torch.zeros(x.numel() + 8, dtype=torch.int16, device=cuda)
    dev = buf[offset:offset + x.numel()].view(x.shape)
    dev.copy_(x)
    assert dev.data_ptr() % 16 == 2 * offset
    _kernels.reset_launches()
    out = tdec.dc_fixup(dev, fixup_plan(bps, ent, cuda))
    torch.cuda.synchronize()
    assert out is dev and _kernels.LAUNCHES["dc_fixup"] == 1
    assert torch.equal(out.cpu(), want)


def _nseg(bps):
    """Rows that fill three tiles and part of a fourth (whole rows a
    thread or a tile), or five rows (chained tiles)."""
    tile, _tiles, _vecs, mode = tdec.fixup_layout(1, bps)
    return 5 if mode == "chained" else 3 * (tile // bps) + 1


@pytest.mark.gpu
@pytest.mark.parametrize("bps", FIXUP_BPS)
def test_dc_fixup_every_width(cuda, bps):
    """Every width from 1 slot to past two tiles, each slot pattern whose
    MCU divides it, rows not a multiple of a tile's, differences of the
    full 12-bit range (sums wrap past int16): the plain version's DC."""
    for ent in FIXUP_ENTS:
        if bps % len(ent) == 0:
            _fixup_check(cuda, _nseg(bps), bps, ent, bps + len(ent))


@pytest.mark.gpu
@pytest.mark.parametrize("nseg,bps,ent", FIXUP_CASES + [
    (3, 518400, (0,)), (1, 777600, (0, 0, 0, 0, 1, 2))])
@pytest.mark.parametrize("offset", [1, 3, 7])
def test_dc_fixup_unaligned(cuda, nseg, bps, ent, offset):
    """The DC row off a 16-byte boundary (the kernel's scalar loads and
    stores) on every case and the 8K restart-0 rows: the plain version's
    DC."""
    _fixup_check(cuda, nseg, bps, ent, nseg * bps + offset, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("nseg,bps,ent", [
    (3, 518400, (0,)), (1, 777600, (0, 0, 0, 0, 1, 2)),
    (2, 24576, (0, 1, 2))])
def test_dc_fixup_repeated_launches(cuda, nseg, bps, ent):
    """50 launches on one plan, queued without a wait between them, on
    fresh rows each (the last ones on fewer rows than the records were
    made for): each equals the plain version, so no launch reads a record
    of the one before; the plan keeps one scratch for the stream, made
    once."""
    plan = fixup_plan(bps, ent, cuda)
    xs = [dc_coefs(i, nseg - (i >= 40 and nseg > 1), bps) for i in range(50)]
    devs = [x.to(cuda) for x in xs]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for d in devs:
        tdec.dc_fixup(d, plan)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["dc_fixup"] == 50
    assert len(plan.fixup_scratch) == 1
    ((scratch, _gens),) = plan.fixup_scratch.values()
    assert scratch.numel() == tdec.fixup_scratch_words(
        tdec.fixup_layout(nseg, bps)[1])
    for x, d in zip(xs, devs):
        n = x.shape[1] // bps
        want = tdec._dc_fixup_t(x, n, bps, fixup_plan(bps, ent).comp_slots)
        assert torch.equal(d.cpu(), want)


@pytest.mark.gpu
def test_dc_fixup_two_streams(cuda):
    """One plan on two streams at once: a scratch for each, both results
    the plain version's."""
    nseg, bps, ent = 3, 100000, (0,)
    plan = fixup_plan(bps, ent, cuda)
    xs = [dc_coefs(s, nseg, bps) for s in (1, 2)]
    devs = [x.to(cuda) for x in xs]
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    for _ in range(3):
        outs = []
        for d, st in zip(devs, streams):
            with torch.cuda.stream(st):
                outs.append(d.clone())
                tdec.dc_fixup(outs[-1], plan)
        torch.cuda.synchronize()
        for x, o in zip(xs, outs):
            assert torch.equal(o.cpu(), tdec._dc_fixup_t(
                x.clone(), nseg, bps, None))
    assert len(plan.fixup_scratch) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("nseg,bps,ent", [
    (3000, 6, (0, 0, 0, 0, 1, 2)), (3, 518400, (0,))])
def test_dc_fixup_probe_stages(cuda, nseg, bps, ent):
    """The probe's stages: the full stage gives the kernel's DC; the
    loads and stores alone, and the scan without its store, leave the
    row as it was; none is counted."""
    x = dc_coefs(9, nseg, bps).to(cuda)
    plan = fixup_plan(bps, ent, cuda)
    want = tdec.dc_fixup(x.clone(), plan)
    _kernels.reset_launches()
    for stage in ("load_store", "no_store", "full"):
        got = x.clone()
        tdec.dc_fixup_probe(got, plan, stage)
        torch.cuda.synchronize()
        assert torch.equal(got, want if stage == "full" else x), stage
    assert _kernels.LAUNCHES["dc_fixup"] == 0


# -- phase A's four-set instances ---------------------------------------------

def _scan_sets(cuda, rows_args, tab, bps, pattern, sets, offset=0):
    """The serial scan of `sets` sets (3 or 4 of tab's eight tables) and
    the plain scan on the same rows (numpy words, nbits, nblocks, dc_sel,
    ac_sel), the card's word matrix `offset` words past a 16-byte
    boundary: equal bstart and err, which are returned."""
    words, nbits, nb, dsel, asel = (torch.from_numpy(np.ascontiguousarray(
        a, np.int32)) for a in rows_args)
    buf = torch.zeros(words.numel() + 4, dtype=torch.int32, device=cuda)
    w_dev = buf[offset:offset + words.numel()].view(words.shape)
    w_dev.copy_(words)
    assert w_dev.data_ptr() % 16 == 4 * offset
    lut = torch.from_numpy(thd.scan_lut(tab.numpy())).to(cuda)
    _kernels.reset_launches()
    got = thd.scan_segments(w_dev, *(a.to(cuda) for a in (nbits, nb, dsel,
                                                           asel)),
                            tab.to(cuda), bps, pattern, lut, "serial",
                            sets=sets)
    torch.cuda.synchronize()
    assert _kernels.INSTANCES == {"huffdec_scan/serial": 1}
    want = thd.scan_segments_plain(words, nbits, nb, dsel, asel, tab, bps,
                                   pattern)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("nsets,bpm,how", FOUR_SET_CASES)
@pytest.mark.parametrize("sets", [3, 4])
def test_scan_sets_coded_rows(cuda, nsets, bpm, how, sets):
    """Coded rows of three and four sets with long codes, picked by
    selectors, 2-bit slot fields or both, through the launch of three
    sets (on rows of four, set 3's tokens through the canonical tables)
    and of four: bit for bit the plain scan, no error."""
    words, nbits, nb, dsel, asel, tab, pattern = _four_set_rows(
        80 + 10 * nsets + bpm, nsets, 240, 3 * bpm, bpm, how)
    _, err = _scan_sets(cuda, (words, nbits, nb, dsel, asel), tab,
                        3 * bpm, pattern, sets, offset=bpm % 4)
    assert not bool(err.any())


@pytest.mark.gpu
@pytest.mark.parametrize("W", list(range(1, 41)))
def test_scan_sets_widths(cuda, W):
    """Rows of W = 1 to 40 words (coded rows of three sets cut to W words
    where longer, so their last tokens overrun), each W at a word offset
    from a 16-byte boundary, through both launches: the plain scan."""
    words, nbits, nb, dsel, asel, tab, pattern = _four_set_rows(
        W, 3, 96, 6, 3, "both", long_share=0.2)
    if words.shape[1] >= W:
        words = words[:, :W]
        nbits = np.minimum(nbits, 32 * W)
    else:
        words = np.pad(words, ((0, 0), (0, W - words.shape[1])))
    for sets in (3, 4):
        _scan_sets(cuda, (words, nbits, nb, dsel, asel), tab, 6, pattern,
                   sets, offset=W % 4)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 3, 7, 20, 40])
def test_scan_sets_random_words(cuda, W):
    """Random rows (invalid codes, runs past 63, bits past nbits), random
    bit counts including 0, selectors and 2-bit fields summing past 3,
    through both launches off 16-byte alignment: the plain scan."""
    rng = np.random.default_rng(300 + W)
    nseg, bps, bpm = 700, 6, 3
    tab = _four_set_rows(W, 4, 2, 3, 3, "both")[5]
    pattern = (bpm, int(rng.integers(0, 1 << 2 * bpm)),
               int(rng.integers(0, 1 << 2 * bpm)))
    words = rng.integers(-(1 << 31), 1 << 31, (nseg, W))
    nbits = rng.integers(0, 32 * W + 1, nseg)
    nbits[::7] = 0
    rows = (words, nbits, rng.integers(0, bps + 1, nseg),
            rng.integers(0, 4, nseg), rng.integers(0, 4, nseg))
    for sets in (3, 4):
        _scan_sets(cuda, rows, tab, bps, pattern, sets, offset=1 + W % 3)


@pytest.mark.gpu
@pytest.mark.parametrize("sets", [3, 4])
def test_scan_sets_error_kinds(cuda, sets):
    """Each error kind on coded rows of three sets: an invalid code, a
    token ending past nbits, a run past coefficient 63, a segment short
    of its blocks; and empty segments, expected empty or not."""
    rng = np.random.default_rng(17)
    ak = scan_rows.annexk_tables()
    tabs = [scan_rows.long_code_tables(17), ak[1], ak[0]]
    nseg, bps, bpm = 10, 4, 2
    pattern = (bpm, 0b1001, 0b0110)
    rows, nb, dsel, asel = scan_rows.segment_rows(
        rng, nseg, bps, tabs, pattern,
        (rng.integers(0, 2, nseg), rng.integers(0, 2, nseg)), bad_run=(3,))
    words, nbits = scan_rows.word_matrix(
        rows, max(len(r) for r in rows) // 4 + 3)
    words[1, 0] = -1                    # 32 one bits: no valid code
    nbits[2] -= 9                       # the last token ends past nbits
    nb[4] = bps + 1                     # one block more than coded
    words[5], nbits[5], nb[5] = 0, 0, 0
    nbits[6], nb[6] = 0, 1
    _, err = _scan_sets(cuda, (words, nbits, nb, dsel, asel),
                        scan_rows.decode_tables(tabs), bps + 1, pattern,
                        sets)
    assert err.tolist() == [False, True, True, True, True, False, True,
                            False, False, False]


@pytest.mark.gpu
def test_scan_instances_resources(cuda):
    """The serial instances as built: the four-set ones take the two-set
    instance's 6 CTAs an SM (dynamic shared memory of 31,808 and 35,904
    bytes, at most 40 registers, nothing spilled)."""
    _kernels.build(["huffdec_scan"])
    fn = _kernels._lib("huffdec_scan").gj_huffdec_scan_resources
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    got = {}
    for sets in (2, 3, 4):
        out = (ctypes.c_int * 5)()
        assert fn(sets, ctypes.addressof(out)) == 0
        got[sets] = list(out)
    assert got[3][3] == 31808 and got[4][3] == 35904
    for sets in (3, 4):
        assert got[sets][0] <= 40 and got[sets][2] == 0, got
        assert got[sets][4] >= got[2][4], got
