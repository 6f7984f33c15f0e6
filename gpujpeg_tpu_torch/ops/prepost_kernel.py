"""The codec's pixel ends: the encode preprocessor and the decode back
halves.

``preprocess_packed`` (interleaved RGB pixels -> component planes, chroma
decimated) wraps csrc/pre_rgb_to_planes.cu, the counterpart of the JAX
package's Pallas preprocessor (gpujpeg_tpu.ops.prepost_kernel:
_pre_kernel_body / preprocess_packed).  The JAX kernel emits planes of 4
samples packed per little-endian u32 word, one launch a decimation group;
the port emits the same bytes as uint8 planes, which are that memory read
byte by byte, all three in one launch (``pre_vector`` picks the kernel's
vector or generic instance).

``decode_post`` (coefficients -> RGB pixels: dequantization, inverse DCT,
colour and the interleaved store in one pass) wraps csrc/dpost_rgb.cu, the
counterpart of the JAX package's fused decode tail
(gpujpeg_tpu.ops.prepost_kernel: _dpost_kernel_body / decode_post_fused)
for 3 components with chroma decimated by dx, dy in {1, 2}.  It stores 3
bytes a pixel where the TPU kernel stores RGBX words and slices them, and
it takes any block count where the TPU kernel needs 128-lane-aligned
planes.

Interleaved scans (and any other stream dpost does not take) decode in two
steps: ``idct_planes`` (coefficients of every component -> a uint8 sample
plane each, one launch) wraps csrc/idct_planes.cu, whose JAX counterpart
is XLA (gpujpeg_tpu.models.decoder._make_idct_post_fn_t_il);
``postprocess_packed`` (planes -> RGB pixels: chroma upsampling, colour,
the interleaved store) wraps csrc/post_rgb.cu, the counterpart of the JAX package's Pallas
postprocessor (_post_kernel_body / postprocess_packed), with no RGBX words
and no width alignment.

For a CPU tensor each wrapper runs its plain version
(``preprocess_packed_plain``, which is ops/sample.preprocess;
``decode_post_plain``, which is ops/dct.dequantize_idct then
ops/sample.postprocess; ``idct_planes_plain``, one component, which the
CPU path calls for each; ``postprocess_packed_plain``,
which is ops/sample.postprocess); for a CUDA tensor it launches its kernel
or raises.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..types import ImageParameters, PixelFormat
from ..utils import tables
from ..utils.geometry import Geometry
from . import _kernels, color, dct, sample


def pre_supported(geo: Geometry, pi: ImageParameters) -> bool:
    """True when the kernel covers this configuration: 8-bit interleaved
    RGB-order input, 3 components at any sampling, no row padding."""
    return (pi.pixel_format == PixelFormat.P444_U8_P012
            and geo.comp_count == 3 and not pi.width_padding)



def preprocess_packed_plain(raw: torch.Tensor, geo: Geometry,
                            pi: ImageParameters) -> List[torch.Tensor]:
    """Plain version of preprocess_packed, on any device."""
    return sample.preprocess(raw, geo, pi)


def preprocess_packed(raw: torch.Tensor, geo: Geometry,
                      pi: ImageParameters) -> List[torch.Tensor]:
    """raw (H, W, 3) uint8 -> [(data_h, data_w) uint8 plane per component],
    colour-transformed from pi.color_space to
    geo.param.color_space_internal, component c sampled at (y * dy, x *
    dx) with (dx, dy) its decimation, and zero-padded.  On CUDA one launch
    writes every plane."""
    if not pre_supported(geo, pi):
        raise NotImplementedError(
            "the preprocessor kernel takes 3-component P444_U8_P012 input "
            "(other formats: ROADMAP queue 1 item 6)")
    H, W = pi.height, pi.width
    if tuple(raw.shape) != (H, W, 3) or raw.dtype != torch.uint8:
        raise ValueError(f"expected a ({H}, {W}, 3) uint8 tensor, got "
                         f"{tuple(raw.shape)} {raw.dtype}")
    if raw.device.type == "cpu":
        return preprocess_packed_plain(raw, geo, pi)
    params = color.kernel_params(pi.color_space,
                                 geo.param.color_space_internal)
    # one launch for every plane: views of one buffer (each plane's bytes
    # are a multiple of 64, so every view starts 16-byte aligned)
    sizes = [c.data_height * c.data_width for c in geo.components]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=raw.device)
    planes = [p.view(c.data_height, c.data_width) for c, p in
              zip(geo.components, torch.split(buf, sizes))]
    _kernels.require_cuda("pre_rgb_to_planes", raw, buf)
    g = pre_geometry(geo)
    _kernels.launch("pre_rgb_to_planes", raw, H, W, g, params, *planes,
                    int(pre_vector(raw, planes, g)))
    return planes


def pre_geometry(geo: Geometry) -> np.ndarray:
    """(dx, dy, data_h, data_w) of each component's plane, flattened
    (int32[12]): the preprocessor kernel's geometry argument."""
    return np.asarray([(geo.max_h // c.samp_h, geo.max_v // c.samp_v,
                        c.data_height, c.data_width)
                       for c in geo.components], np.int32).reshape(-1)


def pre_vector(raw: torch.Tensor, planes: List[torch.Tensor],
               geo_i: np.ndarray) -> bool:
    """True when the preprocessor's vector instance takes these tensors
    (csrc/pre_rgb_to_planes.cu): plane 0 at (dx, dy) = (1, 1), planes 1
    and 2 of one shape at one (dx, dy) in {1, 2}^2, the image 16-byte
    aligned with W % 16 == 0, and every plane's width and address a
    multiple of its 16 / dx bytes; else the generic instance runs.
    geo_i: pre_geometry's array."""
    g = np.asarray(geo_i).reshape(3, 4)
    dx, dy = g[1, 0], g[1, 1]
    if (tuple(g[0, :2]) != (1, 1) or tuple(g[2]) != tuple(g[1])
            or dx not in (1, 2) or dy not in (1, 2)
            or raw.shape[1] % 16 or raw.data_ptr() % 16):
        return False
    return all(int(w) % (16 // int(x)) == 0
               and p.data_ptr() % (16 // int(x)) == 0
               for (x, _, _, w), p in zip(g, planes))


def dpost_decimation(geo: Geometry) -> Tuple[int, int]:
    """(dx, dy): the chroma planes' decimation against luma."""
    cb = geo.components[1]
    return geo.max_h // cb.samp_h, geo.max_v // cb.samp_v


def decode_post_supported(geo: Geometry, pi: ImageParameters) -> bool:
    """True when the dpost kernel covers this configuration (the JAX
    package's gate, gpujpeg_tpu.ops.prepost_kernel.decode_post_supported):
    a non-interleaved scan of 3 components, luma at the largest sampling,
    both chroma planes decimated by one (dx, dy) in {1, 2}^2 and covering
    exactly 1/dx by 1/dy of luma's block grid; P444_U8_P012 output
    without row padding.  Blocks must be contiguous in phase C's layout
    (restart segments fill their rows, or one segment a component); the
    kernel takes any block count, so a ragged last segment, which the JAX
    gate refuses, is allowed."""
    if (pi.pixel_format != PixelFormat.P444_U8_P012 or pi.width_padding
            or geo.comp_count != 3 or geo.interleaved):
        return False
    if not all(c.segment_mcu_count == geo.max_blocks_per_seg
               or c.segment_count == 1 for c in geo.components):
        return False
    y, cb, cr = geo.components
    if ((y.samp_h, y.samp_v) != (geo.max_h, geo.max_v)
            or (cb.samp_h, cb.samp_v) != (cr.samp_h, cr.samp_v)):
        return False
    dx, dy = dpost_decimation(geo)
    return (dx in (1, 2) and dy in (1, 2)
            and all(c.data_width // 8 * dx == y.data_width // 8
                    and c.data_height // 8 * dy == y.data_height // 8
                    for c in (cb, cr)))


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


def block_layout(geo: Geometry, c) -> Tuple[int, int, int, int, int]:
    """(bpm, off, sh, sv, mcux) of component c in the (64, L) layout of
    phase C: raster block (by, bx) sits at column
        m * bpm + off + (by % sv) * sh + bx % sh,
        m = (by // sv) * mcux + bx // sh.
    An interleaved scan's segment row holds whole MCUs of bpm blocks, the
    component's sv x sh blocks of an MCU at slots off, off + 1, ... (T.81
    A.2.3); a non-interleaved one holds the component's raster blocks from
    column off on (component_columns)."""
    if not geo.interleaved:
        return 1, component_columns(geo)[c.index][0], 1, 1, c.data_width // 8
    off = sum(k.samp_h * k.samp_v for k in geo.components[:c.index])
    return geo.blocks_per_mcu, off, c.samp_h, c.samp_v, c.mcu_count_x


def block_columns(geo: Geometry, c, device="cpu") -> torch.Tensor:
    """(data_h/8 * data_w/8,) int64 column of each raster block of
    component c (block_layout)."""
    bpm, off, sh, sv, mcux = block_layout(geo, c)
    by = torch.arange(c.data_height // 8, device=device)[:, None]
    bx = torch.arange(c.data_width // 8, device=device)[None, :]
    m = (by // sv) * mcux + bx // sh
    return (m * bpm + off + (by % sv) * sh + bx % sh).reshape(-1)


@functools.lru_cache(maxsize=None)
def idct_matrix(device) -> torch.Tensor:
    """The (64, 64) float32 inverse-DCT matrix N of the kernels:
    N[k, s] maps zig-zag coefficient k to sample s = row * 8 + column.
    Uploaded once per device and shared: read it, never write it."""
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
    (H, W, 3) uint8 pixels in pi.color_space, chroma upsampled
    nearest-neighbour (the pixel of luma block (by, bx), sample (r, c)
    takes chroma block (by / dy, bx / dx), sample ((by % dy) 8 + r) / dy,
    ((bx % dx) 8 + c) / dx: sample.postprocess's rule for these
    layouts)."""
    _dpost_check(coefs_t, qtabs, geo, pi)
    if coefs_t.device.type == "cpu":
        return decode_post_plain(coefs_t, qtabs, geo, pi)
    out, args = _dpost_args(coefs_t, qtabs, geo, pi)
    _kernels.launch("dpost_rgb", *args)
    return out


def _dpost_check(coefs_t, qtabs, geo, pi) -> None:
    """Raise unless decode_post takes these inputs."""
    if not decode_post_supported(geo, pi):
        raise NotImplementedError(
            "the fused decode back half takes non-interleaved 3-component "
            "scans whose chroma planes tile luma's at dx, dy in {1, 2}, to "
            "P444_U8_P012 (other layouts: idct_planes + postprocess_packed;"
            " other outputs: ROADMAP queue 1 item 6)")
    cols = component_columns(geo)
    L = cols[-1][0] + geo.components[-1].segment_count * \
        geo.max_blocks_per_seg
    if coefs_t.dtype != torch.int16 or tuple(coefs_t.shape) != (64, L):
        raise ValueError(f"expected (64, {L}) int16 coefficients, got "
                         f"{tuple(coefs_t.shape)} {coefs_t.dtype}")
    if qtabs.dtype != torch.float32 or tuple(qtabs.shape) != (3, 64):
        raise ValueError("expected (3, 64) float32 quant tables")


def _dpost_args(coefs_t, qtabs, geo, pi):
    """The output and the C arguments of csrc/dpost_rgb.cu."""
    out = torch.empty((pi.height, pi.width, 3), dtype=torch.uint8,
                      device=coefs_t.device)
    nmat = idct_matrix(coefs_t.device)
    _kernels.require_cuda("dpost_rgb", coefs_t, qtabs, nmat, out)
    c0 = geo.components[0]
    offs = np.asarray([f for f, _ in component_columns(geo)], np.int64)
    params = color.kernel_params(geo.param.color_space_internal,
                                 pi.color_space)
    dx, dy = dpost_decimation(geo)
    return out, (coefs_t, coefs_t.shape[1], offs, c0.mcu_count,
                 c0.data_width // 8, dx, dy, pi.height, pi.width, qtabs,
                 nmat, params, out)


def decode_post_probe(coefs_t: torch.Tensor, qtabs: torch.Tensor,
                      geo: Geometry, pi: ImageParameters,
                      stage: str) -> torch.Tensor:
    """decode_post's kernel cut to a decomposition stage
    (_kernels.PROBE_STAGES; dx = dy = 1 or 2) for chip_smoke.py's probe;
    no codec path calls it.  Only the "full" stage's output is the
    pixels."""
    _dpost_check(coefs_t, qtabs, geo, pi)
    out, args = _dpost_args(coefs_t, qtabs, geo, pi)
    _kernels.probe("dpost_rgb", stage, *args)
    return out


def idct_planes_plain(coefs_t: torch.Tensor, qtab: torch.Tensor,
                      geo: Geometry, c) -> torch.Tensor:
    """Plain version of idct_planes, on any device."""
    cols = block_columns(geo, c, coefs_t.device)
    return dct.dequantize_idct(coefs_t[:, cols].T, qtab, c.data_height,
                               c.data_width).to(torch.uint8)


def idct_planes(coefs_t: torch.Tensor, qtabs: torch.Tensor,
                geo: Geometry) -> List[torch.Tensor]:
    """Every component's blocks of coefs_t (64, L) int16 zig-zag
    coefficients with DC integrated (phase C's layout, block_layout), qtabs
    (components, 64) float32 zig-zag quant tables -> [(data_h, data_w)
    uint8 sample plane per component], in one launch on CUDA."""
    L = geo.segment_count * geo.max_blocks_per_seg
    if coefs_t.dtype != torch.int16 or tuple(coefs_t.shape) != (64, L):
        raise ValueError(f"expected (64, {L}) int16 coefficients, got "
                         f"{tuple(coefs_t.shape)} {coefs_t.dtype}")
    n = geo.comp_count
    if qtabs.dtype != torch.float32 or tuple(qtabs.shape) != (n, 64):
        raise ValueError(f"expected ({n}, 64) float32 quant tables")
    if coefs_t.device.type == "cpu":
        return [idct_planes_plain(coefs_t, qtabs[c.index], geo, c)
                for c in geo.components]
    if n > 4 or geo.blocks_per_mcu > 16:
        raise NotImplementedError(
            "the IDCT-planes kernel takes at most 4 components and 16 "
            "blocks an MCU")
    # the planes are views of one buffer; the kernel takes, per component,
    # its first column (a non-interleaved scan) or first MCU slot, its
    # sampling, MCU grid and width (block_layout)
    sizes = [c.data_height * c.data_width for c in geo.components]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=coefs_t.device)
    planes = [p.view(c.data_height, c.data_width) for c, p in
              zip(geo.components, torch.split(buf, sizes))]
    nmat = idct_matrix(coefs_t.device)
    _kernels.require_cuda("idct_planes", coefs_t, qtabs, nmat, buf)
    g = np.zeros(2 + 6 * 4, np.int64)
    g[:2] = n, int(geo.interleaved)
    for c in geo.components:
        _, first, sh, sv, _ = block_layout(geo, c)
        if geo.interleaved:
            mcux, mcuy = c.mcu_count_x, c.mcu_count_y
        else:
            mcux, mcuy = c.data_width // 8, c.data_height // 8
        g[2 + 6 * c.index:8 + 6 * c.index] = (first, sh, sv, mcux, mcuy,
                                              c.data_width)
    _kernels.launch("idct_planes", coefs_t, L, g, qtabs, nmat, *planes,
                    *[None] * (4 - n))
    return planes


def postprocess_packed_plain(planes: List[torch.Tensor], geo: Geometry,
                             pi: ImageParameters) -> torch.Tensor:
    """Plain version of postprocess_packed, on any device."""
    return sample.postprocess(planes, geo, pi)


def postprocess_packed(planes: List[torch.Tensor], geo: Geometry,
                       pi: ImageParameters) -> torch.Tensor:
    """[(data_h, data_w) uint8 plane per component] in
    geo.param.color_space_internal -> (H, W, 3) uint8 pixels in
    pi.color_space, chroma upsampled nearest-neighbour
    (sample.upsample_factors)."""
    if (pi.pixel_format != PixelFormat.P444_U8_P012 or pi.width_padding
            or geo.comp_count != 3):
        raise NotImplementedError(
            "the postprocessor takes 3 components to P444_U8_P012 (other "
            "formats: ROADMAP queue 1 item 6)")
    for c, p in zip(geo.components, planes):
        if p.dtype != torch.uint8 or tuple(p.shape) != (c.data_height,
                                                        c.data_width):
            raise ValueError(f"component {c.index}: expected a "
                             f"({c.data_height}, {c.data_width}) uint8 "
                             f"plane, got {tuple(p.shape)} {p.dtype}")
    if planes[0].device.type == "cpu":
        return postprocess_packed_plain(planes, geo, pi)
    out = torch.empty((pi.height, pi.width, 3), dtype=torch.uint8,
                      device=planes[0].device)
    _kernels.require_cuda("post_rgb", *planes, out)
    fac = sample.upsample_factors(geo, pi)
    geo_i = np.asarray([c.data_width for c in geo.components]
                       + [f[0] for f in fac] + [f[1] for f in fac], np.int32)
    params = color.kernel_params(geo.param.color_space_internal,
                                 pi.color_space)
    _kernels.launch("post_rgb", *planes, geo_i, pi.height, pi.width, params,
                    out)
    return out
