"""PyTorch port, the Huffman coder's general contract against the JAX
package's entropy megakernel in interpret mode: the plain interleaved
mode (entropy_fused_u8_il: a class and a DC predictor per MCU slot) and
the plain coefficient-input mode (entropy_fused: a class flag per row, a
valid mask per block, the caller's markers); and the contract's special
cases (the CUDA kernel is held against the plain version in
test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpujpeg_tpu as gj
from gpujpeg_tpu.models import encoder as jenc
from gpujpeg_tpu.ops import fusedpack as jfp
from gpujpeg_tpu.utils import tables as jt

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import fusedpack as tfp
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre
from gpujpeg_tpu_torch.ops import tokens as ttok

from .test_torch_encode import _gradient


def _rows_bytes(rows_u32):
    r = np.asarray(rows_u32)
    return np.ascontiguousarray(r.astype(">u4")).view(np.uint8) \
        .reshape(r.shape[0], -1)


def _il(mod, quality, rst):
    return mod.Parameters(quality=quality, restart_interval=rst,
                          interleaved=True)


@pytest.mark.parametrize("kind,quality,rst", [("gradient", 75, -1),
                                              ("noise", 100, 2)])
def test_il_plain_matches_megakernel_interpret(monkeypatch, kind, quality,
                                               rst):
    """entropy_fused_u8_il's plain version equals the JAX package's
    interleaved megakernel (Pallas, interpret mode) row for row."""
    monkeypatch.setenv("GPUJPEG_TPU_FUSED", "interpret")
    frame = (np.random.default_rng(15).integers(0, 256, (40, 48, 3),
                                                dtype=np.uint8)
             if kind == "noise" else _gradient(40, 48, 15))
    geo = gj.Encoder().resolve(frame, _il(gj, quality, rst), None)
    assert jenc.mega_il_supported(geo)
    xbd_fn, info = jenc.make_rows_xbd_il_impl(geo)
    r, ob, needs = jfp.entropy_fused_u8_il(
        xbd_fn(jnp.asarray(frame)), jnp.asarray(info["valid"]),
        info["rst"], z_cap=64, w_out=1024,
        consts=jt.entropy_kernel_consts(quality), quality=quality,
        q_pat=info["q_pat"], dc_pat=info["dc_pat"], ac_pat=info["ac_pat"],
        use_bf16=info["use_bf16"], interpret=True)
    enc = gt.Encoder(device="cpu")
    tgeo = enc.resolve(frame, _il(gt, quality, rst))
    planes = tpre.preprocess_packed(torch.from_numpy(frame), tgeo,
                                    tgeo.param_image)
    rows, rb, t_needs = tfp.entropy_fused_u8_il(planes, tgeo,
                                                enc.classes(quality))
    assert rows.shape[0] == geo.segment_count
    ref_rows, ref_rb = _rows_bytes(r), np.asarray(ob)
    assert np.array_equal(rb.numpy(), ref_rb)
    for s in range(len(ref_rb)):
        n = int(ref_rb[s])
        assert np.array_equal(rows[s, :n].numpy(), ref_rows[s, :n]), s
    assert np.array_equal(t_needs.numpy(), np.asarray(needs)[-2:])


def _inputs(rng, S, B, holes):
    """The inputs of tests/test_megakernel.py's megakernel test (sparse
    blocks, an all-zero and a dense block, a partial last segment, mixed
    row classes, a zero marker mid-scan), plus `holes` interior blocks
    that do not emit."""
    coefs = rng.integers(-200, 200, (S, B, 64)).astype(np.int16)
    coefs = np.where(rng.random((S, B, 64)) < 0.85, 0, coefs)
    coefs[3, 2] = 0                                 # all-zero block
    coefs[5, B - 1] = rng.integers(-1000, 1000, 64)  # dense block
    valid = np.ones((S, B), np.int32)
    valid[S - 2, B - 3:] = 0                        # partial last segment
    coefs[S - 2, B - 3:] = 0
    for s, b in holes:
        valid[s, b] = 0                             # masked, DC still read
        coefs[s, b, 0] = 37 + s
    luma = np.zeros(S, np.int32)
    luma[:S // 2] = 1
    rstm = np.full(S, 0xD0, np.uint32)
    rstm[5] = 0
    rstm[-1] = 0
    return coefs, valid, luma, rstm


@pytest.mark.parametrize("q,S,B,holes", [
    (75, 12, 8, ((4, 3),)),                       # one interior hole
    (90, 12, 8, ((1, 0), (8, 7), (9, 4))),        # row starts and ends
    (50, 10, 6, ((2, 2), (2, 3))),                # 6 blocks, padded to 8
    (75, 10, 4, ((3, 1),)),                       # 4 blocks, padded to 8
])
def test_entropy_fused_plain_matches_megakernel(rng, q, S, B, holes):
    coefs, valid, luma, rstm = _inputs(rng, S, B, holes)
    r, ob, needs = jfp.entropy_fused(
        jnp.asarray(coefs.reshape(S, B * 64).T), jnp.asarray(valid.T),
        jnp.asarray(luma.reshape(1, S)), rstm, 64, 1024,
        jt.entropy_kernel_consts(q), interpret=True)
    classes = (tfp.class_tables(q, True, "cpu"),
               tfp.class_tables(q, False, "cpu"))
    rows, rb, t_needs = tfp.entropy_fused(
        torch.from_numpy(coefs.reshape(S, B * 64)),
        torch.from_numpy(valid != 0), torch.from_numpy(luma),
        torch.from_numpy(rstm.astype(np.int32)), classes)
    assert rows.shape == (S, max(tfp.row_stride(B, t) for t in classes))
    ref_rows, ref_rb = _rows_bytes(r), np.asarray(ob)
    assert np.array_equal(rb.numpy(), ref_rb)
    for s in range(S):
        n = int(ref_rb[s])
        assert np.array_equal(rows[s, :n].numpy(), ref_rows[s, :n]), s
    assert np.array_equal(t_needs.numpy(), np.asarray(needs)[-2:])


def test_one_slot_call_is_the_general_call(rng):
    """The one-slot call (one class, the first nblocks blocks, markers of
    one scan) is the general call with those given explicitly."""
    S, B, nblocks = 9, 8, 9 * 8 - 5
    coefs, *_ = _inputs(rng, S, B, ())
    x = torch.from_numpy(coefs.reshape(S, B * 64))
    tabs = tfp.class_tables(75, False, "cpu")
    one = tfp.huffman_segments(x, nblocks, tabs)
    valid = (torch.arange(S * B) < nblocks).reshape(S, B)
    general = tfp.huffman_segments(x, None, tfp.one_slot(tabs),
                                   tfp.segment_markers(S, "cpu"), valid)
    for a, b in zip(one, general):
        assert torch.equal(a, b)
    assert one[0].shape[1] == tfp.row_stride(B, tabs)
    assert tfp.segment_markers(S, "cpu").tolist() == \
        [0xD0 + s % 8 for s in range(S - 1)] + [0]


def test_tokenize_rows_classes_per_block(rng):
    """A class index per block picks that block's table: tokens equal the
    one-class calls, block by block; a block that is not valid emits
    nothing but still feeds the next DC difference."""
    R, B = 5, 6
    rows = torch.from_numpy(rng.integers(-60, 60, (R, B, 64)))
    luts = [tfp.class_tables(80, k == 0, "cpu").luts for k in (0, 1)]
    cls = torch.from_numpy(rng.integers(0, 2, (R, B)))
    valid = torch.from_numpy(rng.random((R, B)) < 0.7)
    bits, lens = ttok.tokenize_rows(rows, luts, valid, cls)
    for k in (0, 1):
        b, ln = ttok.tokenize_rows(rows, [luts[k]],
                                   torch.ones((R, B), dtype=torch.bool))
        pick = ((cls == k) & valid).repeat_interleave(64, dim=1)
        assert torch.equal(bits[pick], b[pick])
        assert torch.equal(lens[pick], ln[pick])
    assert not lens[~valid.repeat_interleave(64, dim=1)].any()
