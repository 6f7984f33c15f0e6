"""PyTorch port, the fused decode tail to P4444_U8_P0123 (RGBA, alpha
255), which the JAX gate (decode_post_supported) now sends to the port's
dpost kernel as it sends it to the Pallas tail: the plain version
against the JAX package's Pallas tail in interpret mode at dx = dy = 1
and 2, and the whole RGBA decode against gpujpeg_tpu.Decoder().decode,
tolerance 0.  The CUDA kernel's 4-byte store is held against the plain
version in test_torch_kernels.py."""

import numpy as np
import pytest

import jax.numpy as jnp

import gpujpeg_tpu as gj
from gpujpeg_tpu.ops import prepost_kernel as jppk

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre

from .test_torch_dpost import _decoded, _frame

SAMP = {"444": ((1, 1),) * 3, "420": ((2, 2), (1, 1), (1, 1))}


@pytest.mark.parametrize("samp", list(SAMP))
def test_decode_post_rgba_matches_fused_interpret(samp):
    data = gt.Encoder(device="cpu").encode(
        _frame(64, 64, seed=40 + len(samp)),
        gt.Parameters(quality=75, restart_interval=gt.RESTART_AUTO)
        .chroma_subsampled(SAMP[samp]))
    hf, coefs_t, geo = _decoded(data)
    pi_t = hf.out_pi.with_(pixel_format=gt.PixelFormat.P4444_U8_P0123)
    pi_j = geo.param_image.with_(pixel_format=gj.PixelFormat.P4444_U8_P0123)
    assert tpre.decode_post_supported(hf.plan.geo, pi_t)
    assert jppk.decode_post_supported(geo, pi_j)
    got = tpre.decode_post(coefs_t, hf.plan.qtabs, hf.plan.geo, pi_t)
    ref = jppk.decode_post_fused(jnp.asarray(coefs_t.numpy()),
                                 jnp.asarray(hf.plan.qtabs.numpy()), geo,
                                 pi_j, interpret=True)
    assert ref is not None
    assert got.shape == (64, 64, 4)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_rgba_decode_matches_jax():
    """The whole decode to RGBA of a 4:4:4 stream (the dpost route in both
    packages) equals the JAX package's array."""
    data = gt.Encoder(device="cpu").encode(
        _frame(48, 64, seed=44), gt.Parameters(
            quality=85, restart_interval=gt.RESTART_AUTO))
    ref = np.asarray(gj.Decoder().decode(data, gj.ImageParameters(
        color_space=gj.ColorSpace.RGB,
        pixel_format=gj.PixelFormat.P4444_U8_P0123)))
    got = gt.Decoder(device="cpu").decode(data, gt.ImageParameters(
        color_space=gt.ColorSpace.RGB,
        pixel_format=gt.PixelFormat.P4444_U8_P0123))
    assert got.shape == ref.shape == (48, 64, 4)
    assert np.array_equal(got, ref)
