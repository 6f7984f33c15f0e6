"""Encode preprocessor: interleaved RGB pixels -> component planes.

Wrapper of the CUDA kernel csrc/pre_rgb_to_planes.cu, the counterpart of the
JAX package's Pallas preprocessor (gpujpeg_tpu.ops.prepost_kernel:
_pre_kernel_body / preprocess_packed).  The JAX kernel emits planes of
4 samples packed per little-endian u32 word; the port emits the same bytes
as uint8 planes, which are that memory read byte by byte.

For a CPU tensor the wrapper runs the plain version
(``preprocess_packed_plain``, which is ops/sample.preprocess); for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import List

import torch

from ..types import ImageParameters, PixelFormat
from ..utils.geometry import Geometry
from . import _kernels, color, sample


def pre_supported(geo: Geometry, pi: ImageParameters) -> bool:
    """True when the kernel covers this configuration: 8-bit interleaved
    RGB-order input, 3 components at 4:4:4, no row padding."""
    return (pi.pixel_format == PixelFormat.P444_U8_P012
            and geo.comp_count == 3 and not pi.width_padding
            and all(c.samp_h == geo.max_h and c.samp_v == geo.max_v
                    for c in geo.components))


def preprocess_packed_plain(raw: torch.Tensor, geo: Geometry,
                            pi: ImageParameters) -> List[torch.Tensor]:
    """Plain version of preprocess_packed, on any device."""
    return sample.preprocess(raw, geo, pi)


def preprocess_packed(raw: torch.Tensor, geo: Geometry,
                      pi: ImageParameters) -> List[torch.Tensor]:
    """raw (H, W, 3) uint8 -> [(data_h, data_w) uint8 plane per component],
    colour-transformed from pi.color_space to
    geo.param.color_space_internal and zero-padded."""
    if not pre_supported(geo, pi):
        raise NotImplementedError(
            "the preprocessor kernel takes 3-component 4:4:4 "
            "P444_U8_P012 input (other formats: ROADMAP queue 1 item 6)")
    H, W = pi.height, pi.width
    if tuple(raw.shape) != (H, W, 3) or raw.dtype != torch.uint8:
        raise ValueError(f"expected a ({H}, {W}, 3) uint8 tensor, got "
                         f"{tuple(raw.shape)} {raw.dtype}")
    if raw.device.type == "cpu":
        return preprocess_packed_plain(raw, geo, pi)
    c0 = geo.components[0]
    out = torch.empty((3, c0.data_height, c0.data_width), dtype=torch.uint8,
                      device=raw.device)
    _kernels.require_cuda("pre_rgb_to_planes", raw, out)
    params = color.kernel_params(pi.color_space,
                                 geo.param.color_space_internal)
    _kernels.launch("pre_rgb_to_planes", raw, H, W, c0.data_height,
                    c0.data_width, params, out)
    return list(out.unbind(0))
