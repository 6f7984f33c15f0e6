"""PyTorch port, the fused decode tail with subsampled chroma (dx, dy in
{1, 2}): the plain version (IDCT planes, nearest upsampling, colour)
against the JAX package's Pallas tail in interpret mode, which folds the
upsampling into its chroma IDCT matrices (_dpost_matrices).  The CUDA
kernel is held against the plain version in test_torch_kernels.py."""

import numpy as np
import pytest

import jax.numpy as jnp

from gpujpeg_tpu.ops import prepost_kernel as jppk

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre

from .test_torch_dpost import _decoded, _frame
from .test_torch_planar import SAMP


@pytest.mark.parametrize("samp", ["420", "422"])
def test_decode_post_plain_matches_fused_interpret(samp):
    data = gt.Encoder(device="cpu").encode(
        _frame(64, 64, seed=30 + len(samp)),
        gt.Parameters(quality=75, restart_interval=gt.RESTART_AUTO)
        .chroma_subsampled(SAMP[samp]))
    hf, coefs_t, geo = _decoded(data)
    assert tpre.decode_post_supported(hf.plan.geo, hf.out_pi)
    assert tpre.dpost_decimation(hf.plan.geo) == {
        "420": (2, 2), "422": (2, 1)}[samp]
    got = tpre.decode_post(coefs_t, hf.plan.qtabs, hf.plan.geo, hf.out_pi)
    ref = jppk.decode_post_fused(jnp.asarray(coefs_t.numpy()),
                                 jnp.asarray(hf.plan.qtabs.numpy()), geo,
                                 geo.param_image, interpret=True)
    assert ref is not None
    assert np.array_equal(got.numpy(), np.asarray(ref))
