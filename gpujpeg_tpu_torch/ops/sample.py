"""Pre- and postprocessor in plain PyTorch (gpujpeg_tpu.ops.sample).

Raw sample-interleaved pixels -> one zero-padded uint8 plane per component:
decimate first (subsampling is pure selection, gpujpeg_preprocessor.cu:51-64,
so it commutes with the per-pixel colour transform), then convert colour,
then zero-pad to the component's (data_height, data_width) — the reference
zeroes its device buffers (gpujpeg_common.c:941-944).

This is the plain version of the CUDA preprocessor (ops/prepost_kernel.py)
for 3-channel input.

``postprocess`` is the decode side for 3 components to interleaved
P444_U8_P012: each component's plane is upsampled nearest-neighbour to the
image (the JAX package's sample._upsample_to: every row repeated
ceil(H / height) times, every column ceil(W / width) times), then
colour-converted from the stream's internal colour space
(gpujpeg_postprocessor.cu:51-113).  It is the plain version of the CUDA
postprocessor (ops/prepost_kernel.postprocess_packed).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..types import ImageParameters, PixelFormat
from ..utils.geometry import Geometry
from . import color


def preprocess(raw: torch.Tensor, geo: Geometry,
               pi: ImageParameters) -> List[torch.Tensor]:
    """raw (H, W, 3) uint8 -> [(data_height, data_width) uint8 plane per
    component], colour-transformed from pi.color_space to
    geo.param.color_space_internal."""
    chans = raw.to(torch.int32)
    planes = []
    for c in geo.components:
        sub = chans[::geo.max_v // c.samp_v, ::geo.max_h // c.samp_h]
        val = color.convert_channels(
            sub[..., 0], sub[..., 1], sub[..., 2], pi.color_space,
            geo.param.color_space_internal)[c.index]
        planes.append(F.pad(val.to(torch.uint8),
                            (0, c.data_width - val.shape[1],
                             0, c.data_height - val.shape[0])))
    return planes


def upsample_factors(geo: Geometry, pi: ImageParameters):
    """(fy, fx) of each component: its row and column repeat counts up to
    the (H, W) image (1 for full-resolution components)."""
    out = []
    for c in geo.components:
        if geo.max_h // c.samp_h > 1 or geo.max_v // c.samp_v > 1:
            out.append((-(-pi.height // c.height), -(-pi.width // c.width)))
        else:
            out.append((1, 1))
    return out


def postprocess(planes: List[torch.Tensor], geo: Geometry,
                pi: ImageParameters) -> torch.Tensor:
    """[(data_height, data_width) integer plane per component] in
    geo.param.color_space_internal -> (H, W, 3) uint8 in pi.color_space
    (gpujpeg_tpu.ops.sample.postprocess for 3 components and
    P444_U8_P012)."""
    if pi.pixel_format != PixelFormat.P444_U8_P012 or geo.comp_count != 3:
        raise NotImplementedError(
            "the postprocessor takes 3 components to P444_U8_P012 (other "
            "formats: ROADMAP queue 1 item 6)")
    H, W = pi.height, pi.width
    full = []
    for c, (fy, fx) in zip(geo.components, upsample_factors(geo, pi)):
        p = planes[c.index][:c.height, :c.width]
        full.append(p.repeat_interleave(fy, 0).repeat_interleave(fx, 1)
                    [:H, :W])
    rgb = color.convert_channels(full[0], full[1], full[2],
                                 geo.param.color_space_internal,
                                 pi.color_space)
    return torch.stack(rgb, dim=-1).to(torch.uint8)
