"""Encode-side preprocessor in plain PyTorch (gpujpeg_tpu.ops.sample).

Raw sample-interleaved pixels -> one zero-padded uint8 plane per component:
decimate first (subsampling is pure selection, gpujpeg_preprocessor.cu:51-64,
so it commutes with the per-pixel colour transform), then convert colour,
then zero-pad to the component's (data_height, data_width) — the reference
zeroes its device buffers (gpujpeg_common.c:941-944).

This is the plain version of the CUDA preprocessor (ops/prepost_kernel.py)
for 3-channel input; it also decimates subsampled components, which that
kernel does not.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..types import ImageParameters
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
