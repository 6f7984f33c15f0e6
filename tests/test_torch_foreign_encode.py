"""PyTorch port, encode with Annex-K Huffman tables and at restart
interval 0: Encoder(device="cpu") must write the JAX package's bytes for
Annex-K tables at restart interval 4 and 0 and for the tuned tables at 0,
in the four layouts of the port (planar 4:4:4 and 4:2:0, interleaved
4:4:4 and 4:2:0).  Annex-K rows go through the tokenizer and the
token-row packer (fusedpack.entropy_tokens), restart-0 scans through the
scan tokenizer and the host packer (fusedpack.scan_tokens,
native.pack_tokens), and encode_to_device's restart-0 scans through the
token-row packer over the whole scan (fusedpack.scan_rows), whose rows
assemble to the same bytes; the scan tokenizer's cut into rows and
chunks must not change a token."""

import numpy as np
import pytest
import torch

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch import native
from gpujpeg_tpu_torch.ops import fusedpack as tfp

from .test_torch_encode import _gradient
from tests import torch_threads  # noqa: F401

S420 = ((2, 2), (1, 1), (1, 1))
LAYOUTS = {"planar_444": (False, None), "planar_420": (False, S420),
           "il_444": (True, None), "il_420": (True, S420)}


def _params(mod, layout, tables, rst, quality=75):
    il, samp = LAYOUTS[layout]
    p = mod.Parameters(quality=quality, restart_interval=rst,
                       interleaved=il, huffman_tables=tables)
    return p.chroma_subsampled(samp) if samp else p


@pytest.mark.parametrize("tables,rst", [("annexk", 4), ("annexk", 0),
                                        ("tuned", 0)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_encode_matches_jax(layout, tables, rst):
    """Bytes equal gpujpeg_tpu.Encoder().encode's."""
    frame = _gradient(96, 128, 3)
    ref = gj.Encoder().encode(frame, _params(gj, layout, tables, rst))
    got = gt.Encoder(device="cpu").encode(frame,
                                          _params(gt, layout, tables, rst))
    assert got == ref


@pytest.mark.parametrize("layout", ["planar_420", "il_420"])
def test_scan_tokens_cut_changes_nothing(layout, monkeypatch):
    """A scan's tokens are the same whatever the rows it is cut into and
    the chunks they are tokenized in (each component's DC predictor
    carried across): rows of 1, 3 and 8 MCUs, chunks of one row and of
    all rows; the packed bytes equal those of the scan tokenized as one
    row."""
    enc = gt.Encoder(device="cpu")
    frame = _gradient(40, 56, 9)
    geo = enc.resolve(frame, _params(gt, layout, "annexk", 0))
    planes, classes = enc._front(frame, geo)
    if geo.interleaved:
        coefs = tfp.interleaved_rows(planes, geo, classes)
        n, st = geo.mcu_count * geo.blocks_per_mcu, \
            tfp.interleaved_slots(geo, classes)
    else:
        c = geo.components[1]
        coefs = tfp.fdct_quant(planes[c.index], classes[1], c.mcu_count)
        n, st = c.mcu_count, classes[1]
    one = tfp._as_slots(st)
    ok, cls = tfp._block_masks(1, n, one, n, None, None, coefs.device)
    bits, lens = tfp.segment_tokens(coefs.reshape(1, -1)[:, :n * 64], one,
                                    ok, cls)
    keep = lens > 0
    want = (bits[keep].to(torch.int32), lens[keep])
    for row_mcus in (1, 3, 8):
        for chunk in (1, 1 << 22):
            monkeypatch.setattr(tfp, "SCAN_ROW_MCUS", row_mcus)
            monkeypatch.setattr(tfp, "TOKEN_CHUNK_SLOTS", chunk)
            got = tfp.scan_tokens(coefs, n, st)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    assert native.pack_tokens(got[0].numpy(), got[1].numpy()) == \
        native.pack_tokens(bits.numpy(), lens.numpy())


def test_restart0_device_rows_raise():
    """encode_to_device at restart interval 0 (it raised ValueError until
    the port packed such scans on the device): each scan is one device
    row of one segment with no marker (fusedpack.scan_rows), and
    assemble turns the rows into gpujpeg_tpu.Encoder().encode's bytes in
    the four layouts; meta is the row counts, None under check=False."""
    frame = _gradient(96, 128, 3)
    enc = gt.Encoder(device="cpu")
    for layout in LAYOUTS:
        ref = gj.Encoder().encode(frame, _params(gj, layout, "tuned", 0))
        geo, res, meta = enc.encode_to_device(
            frame, _params(gt, layout, "tuned", 0))
        assert [tuple(r.shape[:1]) for r in res["rows"]] == \
            [(1,)] * geo.scan_count
        assert torch.equal(meta, res["rb"])
        assert enc.assemble(geo, res, meta) == ref, layout
        geo, res, meta = enc.encode_to_device(
            frame, _params(gt, layout, "tuned", 0), check=False)
        assert meta is None and enc.assemble(geo, res) == ref, layout


def test_pack_tokens_fallback_matches_native(monkeypatch):
    """The pure-Python packer (no native library) writes the native
    packer's bytes, stuffing and padding included."""
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 27, 4000).astype(np.int32)
    bits = rng.integers(0, 1 << 26, 4000).astype(np.uint32)
    bits[::7] = 0xFFFFFFFF          # runs of one bits: stuffed 0xFF bytes
    want = native.pack_tokens(bits, lens)
    monkeypatch.setattr(native, "lib", lambda: None)
    assert native.pack_tokens(bits, lens) == want
