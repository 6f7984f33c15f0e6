"""PyTorch port, the DC fix-up: the port's dc_fixup (its plain version on
the CPU) against the JAX package's XLA _dc_fixup_t on the same seeded
rows, and the tile scheme of csrc/dc_fixup.cu's long rows replayed in
numpy (its constants parsed from the source) against a plain cumsum.
The kernel itself runs in tests/test_torch_kernels.py on a card."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpujpeg_tpu.models import decoder as jdec
from gpujpeg_tpu_torch.models import decoder as tdec
from tests.test_torch_kernels import FIXUP_CASES, dc_coefs, fixup_plan

SOURCE = os.path.join(os.path.dirname(tdec.__file__), os.pardir, "csrc",
                      "dc_fixup.cu")


def _const(name: str) -> int:
    with open(SOURCE) as f:
        src = f.read()
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    consts = {k: _const(k) for k in ("kScanThreads", "kPer")} \
        if name == "kTile" else {}
    return int(eval(m.group(1), {}, consts))


def test_constants_match_source():
    """The wrapper's short-row limit and tile size are the kernel's."""
    assert tdec.DC_SHORT_SLOTS == _const("kShortSlots")
    assert tdec.DC_TILE == _const("kTile") \
        == _const("kScanThreads") * _const("kPer")


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


def _replay_tiles(dc: np.ndarray, bps: int, ent) -> np.ndarray:
    """csrc/dc_fixup.cu's two passes over rows longer than kShortSlots:
    tiles of kTile slots, kPer consecutive slots a thread with a running
    sum a component, each warp's inclusive scan of its threads' totals,
    the exclusive scan of the 32 warps' totals, and the totals of the
    row's earlier tiles (pass 1), all modulo 2^32, stored modulo 2^16."""
    threads, per = _const("kScanThreads"), _const("kPer")
    tile = threads * per
    nseg = dc.size // bps
    tiles = -(-bps // tile)
    v = np.zeros((nseg, tiles * tile), np.uint32)
    v[:, :bps] = dc.reshape(nseg, bps).astype(np.int64).astype(np.uint32)
    comp = np.zeros(tiles * tile, np.int64)
    comp[:bps] = _slot_comp(bps, ent)
    v = v.reshape(nseg, tiles, threads, per)
    comp = comp.reshape(tiles, threads, per)
    local = np.zeros_like(v)
    tot = np.zeros((nseg, tiles, threads, 4), np.uint32)
    for q in range(4):
        m = (comp == q)[None]
        run = np.cumsum(np.where(m, v, 0), axis=3, dtype=np.uint32)
        local = np.where(m, run, local)
        tot[..., q] = run[..., -1]
    warp = tot.reshape(nseg, tiles, threads // 32, 32, 4)
    inc = np.cumsum(warp, axis=3, dtype=np.uint32)
    wtot = inc[:, :, :, -1, :]
    wexcl = np.cumsum(wtot, axis=2, dtype=np.uint32) - wtot
    ttot = wtot.sum(axis=2, dtype=np.uint32)                  # pass 1
    carry = np.cumsum(ttot, axis=1, dtype=np.uint32) - ttot
    base = (carry[:, :, None, None, :] + wexcl[:, :, :, None, :] + inc
            - warp).reshape(nseg, tiles, threads, 4)
    out = local + np.take_along_axis(
        base, np.broadcast_to(comp[None], v.shape), axis=3)
    return out.reshape(nseg, -1)[:, :bps].astype(np.uint16) \
        .view(np.int16).reshape(-1)


@pytest.mark.parametrize("nseg,bps,ent", [
    c for c in FIXUP_CASES if c[1] > 64] + [(1, 3 * 8192, (0,)),
                                           (2, 8196, (0, 0, 1, 2, 3, 3))])
def test_tile_scheme_replay(nseg, bps, ent):
    """The kernel's tile scheme gives the plain version's sums, DC
    differences of the full 12-bit range (sums wrap past int16)."""
    x = dc_coefs(bps + nseg, nseg, bps)
    want = tdec._dc_fixup_t(x.clone(), nseg, bps,
                            fixup_plan(bps, ent).comp_slots)[0].numpy()
    assert np.array_equal(_replay_tiles(x[0].numpy(), bps, ent), want)


def test_wrapper_refuses_bad_coefficients():
    """dc_fixup takes (64, nseg * bps) int16 coefficients, on any
    device."""
    plan = fixup_plan(8, (0,))
    for bad in (torch.zeros((64, 16), dtype=torch.int32),
                torch.zeros((63, 16), dtype=torch.int16),
                torch.zeros((64, 12), dtype=torch.int16)):
        with pytest.raises(ValueError, match="int16"):
            tdec.dc_fixup(bad, plan)
