"""The codec's pixel ends: the encode preprocessor and the fused decode
back half.

``preprocess_packed`` (interleaved RGB pixels -> component planes) wraps
csrc/pre_rgb_to_planes.cu, the counterpart of the JAX package's Pallas
preprocessor (gpujpeg_tpu.ops.prepost_kernel: _pre_kernel_body /
preprocess_packed).  The JAX kernel emits planes of 4 samples packed per
little-endian u32 word; the port emits the same bytes as uint8 planes,
which are that memory read byte by byte.

``decode_post`` (coefficients -> RGB pixels: dequantization, inverse DCT,
colour and the interleaved store in one pass) wraps csrc/dpost_rgb.cu, the
counterpart of the JAX package's fused decode tail
(gpujpeg_tpu.ops.prepost_kernel: _dpost_kernel_body / decode_post_fused)
for 3 components at 4:4:4.  It stores 3 bytes a pixel where the TPU kernel
stores RGBX words and slices them, and it takes any block count where
the TPU kernel needs 128-lane-aligned planes.

For a CPU tensor each wrapper runs its plain version
(``preprocess_packed_plain``, which is ops/sample.preprocess;
``decode_post_plain``, which is ops/dct.dequantize_idct then
ops/sample.postprocess); for a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..types import ImageParameters, PixelFormat
from ..utils import tables
from ..utils.geometry import Geometry
from . import _kernels, color, dct, sample


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


def decode_post_supported(geo: Geometry, pi: ImageParameters) -> bool:
    """True when the dpost kernel covers this configuration: a
    non-interleaved scan of 3 components at 4:4:4 whose blocks are
    contiguous in phase C's layout (restart segments fill their rows, or
    one segment a component), P444_U8_P012 output without row padding."""
    return (pi.pixel_format == PixelFormat.P444_U8_P012
            and not pi.width_padding and geo.comp_count == 3
            and not geo.interleaved
            and all(c.samp_h == geo.max_h and c.samp_v == geo.max_v
                    and (c.segment_mcu_count == geo.max_blocks_per_seg
                         or c.segment_count == 1)
                    for c in geo.components))


def component_columns(geo: Geometry) -> List[Tuple[int, int]]:
    """(first column, block count) of each component in the (64, L)
    coefficient layout of phase C: component c's segments follow the
    earlier components' and each holds max_blocks_per_seg slots, so its
    raster block i sits at column first + i."""
    out, base = [], 0
    for c in geo.components:
        out.append((base * geo.max_blocks_per_seg, c.mcu_count))
        base += c.segment_count
    return out


def idct_matrix(device) -> torch.Tensor:
    """The (64, 64) float32 inverse-DCT matrix N of the kernel:
    N[k, s] maps zig-zag coefficient k to sample s = row * 8 + column."""
    return torch.from_numpy(np.ascontiguousarray(
        tables.idct2d_matrix_zz().astype(np.float32))).to(device)


def decode_post_plain(coefs_t: torch.Tensor, qtabs: torch.Tensor,
                      geo: Geometry, pi: ImageParameters) -> torch.Tensor:
    """Plain version of decode_post, on any device."""
    planes = []
    for c, (first, n) in zip(geo.components, component_columns(geo)):
        planes.append(dct.dequantize_idct(
            coefs_t[:, first:first + n].T, qtabs[c.index], c.data_height,
            c.data_width))
    return sample.postprocess(planes, geo, pi)


def decode_post(coefs_t: torch.Tensor, qtabs: torch.Tensor, geo: Geometry,
                pi: ImageParameters) -> torch.Tensor:
    """coefs_t (64, L) int16 zig-zag coefficients with DC integrated (phase
    C's layout), qtabs (3, 64) float32 zig-zag quant tables ->
    (H, W, 3) uint8 pixels in pi.color_space."""
    if not decode_post_supported(geo, pi):
        raise NotImplementedError(
            "the decode back half takes a non-interleaved 3-component "
            "4:4:4 scan to P444_U8_P012 (other layouts: ROADMAP queue 1 "
            "items 6 and 8)")
    cols = component_columns(geo)
    L = cols[-1][0] + geo.components[-1].segment_count * \
        geo.max_blocks_per_seg
    if coefs_t.dtype != torch.int16 or tuple(coefs_t.shape) != (64, L):
        raise ValueError(f"expected (64, {L}) int16 coefficients, got "
                         f"{tuple(coefs_t.shape)} {coefs_t.dtype}")
    if qtabs.dtype != torch.float32 or tuple(qtabs.shape) != (3, 64):
        raise ValueError("expected (3, 64) float32 quant tables")
    if coefs_t.device.type == "cpu":
        return decode_post_plain(coefs_t, qtabs, geo, pi)
    out = torch.empty((pi.height, pi.width, 3), dtype=torch.uint8,
                      device=coefs_t.device)
    nmat = idct_matrix(coefs_t.device)
    _kernels.require_cuda("dpost_rgb", coefs_t, qtabs, nmat, out)
    c0 = geo.components[0]
    offs = np.asarray([f for f, _ in cols], np.int64)
    params = color.kernel_params(geo.param.color_space_internal,
                                 pi.color_space)
    _kernels.launch("dpost_rgb", coefs_t, L, offs, c0.mcu_count,
                    c0.data_width // 8, pi.height, pi.width, qtabs, nmat,
                    params, out)
    return out
