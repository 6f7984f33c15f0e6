"""PyTorch port, decode of non-interleaved scans with subsampled chroma
planes (planar 4:2:0, 4:2:2, 4:4:0, written by the port's encoder, which
writes the JAX package's bytes: test_torch_planar.py): Decoder(device=
"cpu") returns the JAX package's pixels and coefficients, at a size the
fused decode tail takes (64x64) and at one it does not for 4:2:0 and
4:2:2 (41x67, whose chroma planes pad to 5 block columns against luma's
9: the IDCT planes + postprocessor route)."""

import numpy as np
import pytest

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre

from .test_torch_interleaved_decode import _JDEC
from .test_torch_planar import SAMP, SIZES, _frame, _params


@pytest.mark.parametrize("samp", list(SAMP))
@pytest.mark.parametrize("size", ["64x64", "41x67"])
def test_planar_decode_matches_jax(samp, size):
    """Pixels and quantized coefficients equal the JAX package's."""
    _, _, quality, rst = SIZES[size]
    data = gt.Encoder(device="cpu").encode(_frame(size, samp),
                                           _params(gt, samp, quality, rst))
    dec = gt.Decoder(device="cpu")
    hf = dec.prepare(data)
    fused = tpre.decode_post_supported(hf.plan.geo, hf.out_pi)
    assert fused == (size == "64x64" or samp == "440")
    ref = np.asarray(_JDEC.decode(data))
    got = dec.decode(data)
    assert got.shape == ref.shape and np.array_equal(got, ref)
    ref_c = _JDEC.decode_coefficients(data)
    got_c = dec.decode_coefficients(data)
    for a, b in zip(got_c, ref_c):
        assert a.shape == b.shape and np.array_equal(a, b)
