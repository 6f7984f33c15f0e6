"""PyTorch port, preprocessor: the plain version against the JAX package's
Pallas kernel in interpret mode (the CUDA kernel is held against the plain
version in test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpujpeg_tpu.models.encoder import adjust_params as j_adjust
from gpujpeg_tpu.ops import color as jcolor
from gpujpeg_tpu.ops import prepost_kernel as jpre
from gpujpeg_tpu.types import (ColorSpace as JCS, ImageParameters as JIP,
                               Parameters as JP)
from gpujpeg_tpu.utils import geometry as jgeo

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch.models.encoder import adjust_params as t_adjust
from gpujpeg_tpu_torch.ops import color as tcolor, prepost_kernel as tpre
from gpujpeg_tpu_torch.utils import geometry as tgeo


def _geos(w, h, cs_name):
    pj = j_adjust(JP(quality=75, restart_interval=8,
                     color_space_internal=JCS[cs_name]),
                  JIP(width=w, height=h))
    gj_ = jgeo.get_geometry(pj, JIP(width=w, height=h))
    pt = t_adjust(gt.Parameters(quality=75, restart_interval=8,
                                color_space_internal=gt.ColorSpace[cs_name]),
                  gt.ImageParameters(width=w, height=h))
    gt_ = tgeo.get_geometry(pt, gt.ImageParameters(width=w, height=h))
    return gj_, gt_


@pytest.mark.parametrize("cs", ["YCBCR_BT601_256LVLS", "YCBCR_BT709"])
@pytest.mark.parametrize("hw", [(64, 128), (48, 256)])
def test_pre_plain_matches_pallas_interpret(rng, hw, cs):
    h, w = hw
    g_j, g_t = _geos(w, h, cs)
    raw = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    packed = jpre.preprocess_packed(jnp.asarray(raw), g_j, g_j.param_image,
                                    interpret=True)
    assert packed is not None
    planes = tpre.preprocess_packed(torch.from_numpy(raw), g_t,
                                    g_t.param_image)
    for c in g_t.components:
        got = planes[c.index].numpy()
        ref = np.asarray(packed[c.index])
        assert got.shape == (c.data_height, c.data_width)
        assert np.array_equal(got.view("<u4"), ref), c.index


def test_pre_plain_pads_odd_sizes(rng):
    h, w = 29, 43
    _, g_t = _geos(w, h, "YCBCR_BT601_256LVLS")
    raw = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    planes = tpre.preprocess_packed(torch.from_numpy(raw), g_t,
                                    g_t.param_image)
    ref = jcolor.convert_numpy(raw, JCS.RGB, JCS.YCBCR_BT601_256LVLS)
    for c in g_t.components:
        p = planes[c.index].numpy()
        assert p.shape == (32, 48)
        assert np.array_equal(p[:h, :w], ref[..., c.index])
        assert not p[h:].any() and not p[:, w:].any()


@pytest.mark.parametrize("cs", ["YCBCR_BT601", "YCBCR_BT601_256LVLS",
                                "YCBCR_BT709", "YUV"])
def test_convert_channels_matches_numpy_oracle(rng, cs):
    c = rng.integers(0, 256, (20000, 3))
    for src, dst in ((JCS.RGB, JCS[cs]), (JCS[cs], JCS.RGB)):
        ref = jcolor.convert_numpy(c, src, dst)
        t = torch.from_numpy(c)
        got = tcolor.convert_channels(
            t[:, 0], t[:, 1], t[:, 2], gt.ColorSpace[src.name],
            gt.ColorSpace[dst.name])
        assert np.array_equal(torch.stack(got, -1).numpy(), ref)
