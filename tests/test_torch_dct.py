"""PyTorch port, forward DCT + quantization: the plain version against the
JAX package's fdct_quantize with tolerance 0 (the order of the sums decides
the result, see gpujpeg_tpu_torch/ops/dct.py).  The CUDA kernel is held
against the plain version in test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpujpeg_tpu.ops import dct as jdct
from gpujpeg_tpu.utils import tables as jt

from gpujpeg_tpu_torch.ops import dct as tdct, fusedpack as tfp
from tests import torch_threads  # noqa: F401


def _plane(kind, h, w, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = xx * 255 // w + yy * 96 // h
    return np.clip(base + rng.integers(-24, 24, (h, w)), 0, 255) \
        .astype(np.uint8)


@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("kind", ["gradient", "noise"])
def test_fdct_plain_matches_jax_exactly(kind, luma):
    plane = _plane(kind, 240, 320)
    for q in (75, 90):
        qt = jt.quant_table_zz(luma, q)
        ref = np.asarray(jdct.fdct_quantize(jnp.asarray(plane), qt))
        got = tdct.fdct_quantize(torch.from_numpy(plane), qt).numpy()
        assert got.dtype == np.int16
        assert int((got != ref).sum()) == 0


def test_fdct_quant_segment_layout():
    # 39 blocks per row, 8 blocks per segment: segments wrap block rows and
    # the last segment is short; pad blocks must be zero
    plane = _plane("gradient", 16, 312)
    tabs = tfp.class_tables(75, True, "cpu")
    # the CUDA kernel reads Mq row-major
    assert tabs.mq.is_contiguous() and tabs.bias.is_contiguous()
    assert np.array_equal(tabs.mq.numpy(),
                          jt.fdct_fused_matrix(tabs.qtab)[0])
    nblocks = 2 * 39
    nseg = -(-nblocks // 8)
    coefs = tfp.fdct_quant(torch.from_numpy(plane), tabs, 8)
    assert coefs.shape == (nseg, 8 * 64)
    blocks = jdct.fdct_quantize(jnp.asarray(plane), tabs.qtab)
    flat = coefs.reshape(-1, 64).numpy()
    assert np.array_equal(flat[:nblocks], np.asarray(blocks))
    assert not flat[nblocks:].any()
