"""PyTorch port, decode back half (dequantization + inverse DCT + colour +
interleaved store): the plain versions against the JAX package's XLA tail
and its fused Pallas tail in interpret mode (the CUDA kernel is held
against the plain version in test_torch_kernels.py).

The target is equality, and it holds: the JAX package's float32 products
on the CPU equal the sequential FMA chain of ops/dct.py for the inverse
transform as they do for the forward one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpujpeg_tpu.models import decoder as jdec
from gpujpeg_tpu.ops import dct as jdct
from gpujpeg_tpu.ops import prepost_kernel as jppk
from gpujpeg_tpu.stream import reader as jreader
from gpujpeg_tpu.utils import tables as jt
from gpujpeg_tpu.utils.geometry import get_geometry as jget_geometry

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.ops import dct as tdct
from gpujpeg_tpu_torch.ops import prepost_kernel as tpre


def _frame(h, w, seed, amp=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  ((xx + yy) * 255 // (w + h))], -1)
    return np.clip(f + rng.integers(-amp, amp, f.shape), 0, 255) \
        .astype(np.uint8)


def _encode(frame, quality):
    """The port's encoder writes the JAX package's bytes
    (test_torch_encode.py) and builds no XLA programs."""
    return gt.Encoder(device="cpu").encode(frame, gt.Parameters(
        quality=quality, restart_interval=gt.RESTART_AUTO))


@pytest.mark.parametrize("luma,quality", [(True, 75), (False, 50),
                                          (True, 100)])
def test_idct_plain_matches_jax(luma, quality):
    """ops/dct.dequantize_idct equals dct.dequantize_idct_traced on dense
    random coefficients (every rounding boundary of the chain)."""
    rng = np.random.default_rng(quality)
    n = 24 * 32
    coefs = rng.integers(-300, 300, (n, 64)).astype(np.int16)
    coefs[:, 0] = rng.integers(-1024, 1024, n)
    coefs[n // 2:, 20:] = 0                   # typical high-frequency zeros
    q = jt.quant_table_zz(luma, quality).astype(np.float32)
    ref = np.asarray(jdct.dequantize_idct_traced(jnp.asarray(coefs),
                                                 jnp.asarray(q), 192, 256))
    got = tdct.dequantize_idct(torch.from_numpy(coefs), q, 192, 256)
    assert np.array_equal(got.numpy(), ref)


def _decoded(data):
    """(port HostFrame, coefs_t (64, L) DC-integrated, JAX geometry)."""
    dec = gt.Decoder(device="cpu")
    hf = dec.prepare(data)
    coefs_t, _ea, _ec = dec.coefficients_t(hf)
    ps = jreader.parse(data)
    geo = jget_geometry(jreader.parsed_to_parameters(ps),
                        jdec.resolve_output(ps, None, 0)
                        .with_(width_padding=0))
    return hf, coefs_t, geo


@pytest.mark.parametrize("hw,quality", [((64, 80), 75), ((41, 67), 90),
                                        ((48, 64), 100)])
def test_decode_post_plain_matches_xla_tail(hw, quality):
    """decode_post_plain equals the JAX package's XLA tail
    (_make_idct_post_fn: dequantize_idct_traced + sample.postprocess)."""
    data = _encode(_frame(*hw, seed=hw[0]), quality)
    hf, coefs_t, geo = _decoded(data)
    got = tpre.decode_post_plain(coefs_t, hf.plan.qtabs, hf.plan.geo,
                                 hf.out_pi)
    nseg, bps = geo.segment_count, geo.max_blocks_per_seg
    rows = jnp.asarray(coefs_t.T.numpy().reshape(nseg, bps, 64))
    ref = jdec._make_idct_post_fn(geo)(rows, jnp.asarray(
        hf.plan.qtabs.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_decode_post_plain_matches_fused_interpret():
    """decode_post_plain equals the JAX package's fused Pallas tail
    (decode_post_fused, interpret mode) on a geometry it takes."""
    data = _encode(_frame(64, 64, seed=9), 75)
    hf, coefs_t, geo = _decoded(data)
    got = tpre.decode_post_plain(coefs_t, hf.plan.qtabs, hf.plan.geo,
                                 hf.out_pi)
    ref = jppk.decode_post_fused(jnp.asarray(coefs_t.numpy()),
                                 jnp.asarray(hf.plan.qtabs.numpy()), geo,
                                 geo.param_image, interpret=True)
    assert ref is not None
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_decode_post_wrapper_on_cpu_is_plain():
    """On CPU tensors decode_post is its plain version; the kernel's
    layout helpers cover every component's blocks exactly once."""
    data = _encode(_frame(40, 56, 2), 75)
    dec = gt.Decoder(device="cpu")
    hf = dec.prepare(data)
    coefs_t, _ea, _ec = dec.coefficients_t(hf)
    geo = hf.plan.geo
    cols = tpre.component_columns(geo)
    assert [n for _, n in cols] == [c.mcu_count for c in geo.components]
    assert cols[1][0] == cols[0][0] + geo.components[0].segment_count * \
        geo.max_blocks_per_seg
    assert torch.equal(
        tpre.decode_post(coefs_t, hf.plan.qtabs, geo, hf.out_pi),
        tpre.decode_post_plain(coefs_t, hf.plan.qtabs, geo, hf.out_pi))
    n = tpre.idct_matrix("cpu")
    assert n.dtype == torch.float32 and n.is_contiguous()
    assert np.array_equal(n.numpy(), jt.idct2d_matrix_zz().astype(
        np.float32))
