"""PyTorch port, interleaved encode with subsampled chroma: the bytes equal
the JAX package's encoder (its non-megakernel path: XLA tokens, then the
token-row packer) on the CPU, through the port's slot-pattern Huffman
coder, at 4:2:0, at 4:1:1 and with subsampled chroma.  4:2:2 and 4:4:0
are in test_torch_interleaved_encode_sampling.py, interleaved 4:4:4 in
test_torch_interleaved444.py (on the card: test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import fusedpack as tfp
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre, tokens as ttok

from .test_torch_encode import _gradient

S420 = ((2, 2), (1, 1), (1, 1))

FRAMES = {
    "gradient_320x240": lambda: _gradient(240, 320, 0),
    "odd_311x233": lambda: _gradient(233, 311, 1),
    "noise_64x64": lambda: np.random.default_rng(2).integers(
        0, 256, (64, 64, 3), dtype=np.uint8),
}

#: (frame, quality, restart interval): Q75 auto (1 MCU a segment at
#: 4:2:0) and Q90 with an interval of 2 MCUs (311x233 at 4:2:0 has 20 x
#: 15 MCUs; 4:2:2 and 4:4:0 give it odd MCU counts, a ragged last
#: segment)
CASES = [("gradient_320x240", 75, -1), ("odd_311x233", 75, -1),
         ("odd_311x233", 90, 2), ("noise_64x64", 75, -1)]


def _params(mod, samp, quality, rst):
    return mod.Parameters(quality=quality, restart_interval=rst,
                          interleaved=True).chroma_subsampled(samp)


def check_bytes(samp, name, quality, rst):
    frame = FRAMES[name]()
    ref = bytes(gj.Encoder().encode(frame, _params(gj, samp, quality, rst)))
    got = gt.Encoder(device="cpu").encode(frame,
                                          _params(gt, samp, quality, rst))
    assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"
    assert got == ref
    return got


@pytest.mark.parametrize("name,quality,rst", CASES)
def test_interleaved_420_bytes_match_jax(name, quality, rst):
    check_bytes(S420, name, quality, rst)


def test_interleaved_420_token_layout():
    """Tokens of a row are MCU after MCU, each MCU's 4 Y blocks, then Cb,
    then Cr, and each component is tokenized over its own blocks (so its
    DC predictor runs over them, T.81 F.1.1.5.1)."""
    enc = gt.Encoder(device="cpu")
    frame = _gradient(48, 64, 3)
    p = _params(gt, S420, 90, 2)
    geo = enc.resolve(frame, p)
    planes = tpre.preprocess_packed(torch.from_numpy(frame), geo,
                                    geo.param_image)
    classes = enc.classes(90)
    rows = tfp.interleaved_rows(planes, geo, classes)
    st = tfp.interleaved_slots(geo, classes)
    assert tuple(rows.shape) == (6, 2 * 6 * 64)
    assert st.slot_class == (0, 0, 0, 0, 1, 1)
    assert st.slot_comp == (0, 0, 0, 0, 1, 2)
    valid = torch.ones((6, 12), dtype=torch.bool)
    cls = torch.tensor(st.slot_class * 2).expand(6, 12)
    bits, lens = tfp.segment_tokens(rows, st, valid, cls)
    assert tuple(bits.shape) == (6, 2 * 6 * 64)
    by_mcu = rows.reshape(6, 2, 6, 64)
    for c, off in zip(geo.components, (0, 4, 5)):
        n = c.samp_h * c.samp_v
        x = by_mcu[:, :, off:off + n].reshape(6, 2 * n, 64)
        b, ln = ttok.tokenize_rows(x, [classes[c.table_index].luts],
                                   valid[:, :2 * n])
        for got, ref in ((bits, b), (lens, ln)):
            part = got.reshape(6, 2, 6, 64)[:, :, off:off + n]
            assert torch.equal(part.reshape(6, -1).long(), ref.long())


@pytest.mark.parametrize("case", ["planar_411", "il_subsampled_chroma",
                                  "il_411"])
def test_outside_the_slice_raises(case):
    """Non-interleaved and interleaved 4:1:1 and an interleaved scan with
    subsampled chroma, which the port refused before it took every
    sampling: each now gives the JAX package's bytes (its non-megakernel
    path), the interleaved ones through the slot-pattern Huffman coder
    (6 and 8 blocks an MCU)."""
    frame = _gradient(32, 48, 5)
    s411 = ((4, 1), (1, 1), (1, 1))
    if case == "planar_411":
        p = {m: m.Parameters(quality=75, restart_interval=m.RESTART_AUTO)
             .chroma_subsampled(s411) for m in (gj, gt)}
        ref = bytes(gj.Encoder().encode(frame, p[gj]))
        assert gt.Encoder(device="cpu").encode(frame, p[gt]) == ref
    elif case == "il_subsampled_chroma":
        check_bytes(((2, 2), (2, 1), (2, 1)), "noise_64x64", 75, -1)
    else:
        check_bytes(s411, "noise_64x64", 75, 2)
