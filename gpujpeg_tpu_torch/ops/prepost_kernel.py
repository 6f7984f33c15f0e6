"""The codec's pixel ends: the encode preprocessor and the decode back
halves, for every pixel format, 1 to 4 components and any sampling.

``preprocess_packed`` (a raw image -> component planes, chroma decimated)
wraps csrc/pre_rgb_to_planes.cu, the counterpart of the JAX package's
Pallas preprocessor (gpujpeg_tpu.ops.prepost_kernel: _pre_kernel_body /
preprocess_packed), which takes 3-component P444_U8_P012 and leaves every
other input to XLA (sample.preprocess); the port's kernel takes them all
(``check_raw``: interleaved channels at any row pitch, UYVY, the three
planar formats; ``pre_source`` describes the input to the kernel).  The
JAX kernel emits planes of 4 samples packed per little-endian u32 word,
one launch a decimation group; the port emits the same bytes as uint8
planes, which are that memory read byte by byte, all of them in one
launch (``pre_instance`` picks the kernel's instance: RGB vector,
``pre_vector``; a vector instance of another input kind; or generic).

``decode_post`` (coefficients -> RGB or RGBA pixels: dequantization,
inverse DCT, colour and the interleaved store in one pass) wraps
csrc/dpost_rgb.cu, the counterpart of the JAX package's fused decode tail
(gpujpeg_tpu.ops.prepost_kernel: _dpost_kernel_body / decode_post_fused)
for 3 components with chroma decimated by dx, dy in {1, 2}.  It stores 3
bytes a pixel (4 for P4444_U8_P0123) where the TPU kernel stores RGBX
words and slices them, and it takes any block count where the TPU kernel
needs 128-lane-aligned planes.

Interleaved scans (and any other stream or output dpost does not take)
decode in two steps: ``idct_planes`` (coefficients of every component ->
a uint8 sample plane each, one launch) wraps csrc/idct_planes.cu, whose
JAX counterpart is XLA (gpujpeg_tpu.models.decoder.
_make_idct_post_fn_t_il); ``postprocess_packed`` (planes -> the raw image
of any output format: chroma upsampling, colour, the store) wraps
csrc/post_rgb.cu, the counterpart of the JAX package's Pallas
postprocessor (_post_kernel_body / postprocess_packed, RGB and RGBA from
3 components; XLA's sample.postprocess for the rest), with no RGBX words
and no width alignment (``post_target`` describes the output,
``post_instance`` picks the kernel's instance).

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

from ..types import (ImageParameters, PixelFormat, image_size_bytes,
                     pixel_format_sampling, pixel_format_unit_size)
from ..utils import tables
from ..utils.geometry import Geometry
from . import _kernels, color, dct, sample


def check_raw(raw: torch.Tensor, pi: ImageParameters) -> None:
    """Raise unless raw is an image the preprocessor takes for pi, by the
    JAX package's unpack_to_channels: a uint8 (H, W, C) tensor of any C
    or an (H, W) one, whatever the pixel format; or a flat buffer of the
    format, rows padded by pi.width_padding bytes for the packed formats
    (ValueError for a planar one, as there), UYVY at an even width only;
    a flat buffer of another size or UYVY at an odd width raise
    TypeError, the JAX package's reshape error."""
    H, W = pi.height, pi.width
    if raw.dtype != torch.uint8:
        raise ValueError(f"expected a uint8 image, got {raw.dtype}")
    if raw.dim() in (2, 3):
        if tuple(raw.shape[:2]) != (H, W) or 0 in raw.shape:
            raise ValueError(f"expected an ({H}, {W}[, C]) image, got "
                             f"{tuple(raw.shape)}")
        return
    if raw.dim() != 1:
        raise ValueError(f"expected an image or a flat buffer, got "
                         f"{tuple(raw.shape)}")
    pf = pi.pixel_format
    unit = pixel_format_unit_size(pf)
    if pi.width_padding and unit == 0:
        raise ValueError(
            "width_padding is only supported for packed pixel formats")
    if pf == PixelFormat.P422_U8_P1020 and W % 2:
        raise TypeError(f"cannot unpack UYVY rows of odd width {W}")
    n = H * (W * unit + pi.width_padding) if unit else \
        image_size_bytes(W, H, pf)
    if raw.numel() != n:      # TypeError: the JAX package's reshape error
        raise TypeError(f"a {pf.name} buffer of {W}x{H} holds {n} bytes, "
                        f"got {raw.numel()}")


def pre_source(raw: torch.Tensor, geo: Geometry,
               pi: ImageParameters) -> np.ndarray:
    """The preprocessor kernel's description of its input (int64[16]):
    kind (0 sample-interleaved channels, 1 UYVY, 2 three planes),
    channels of an interleaved input, row pitch in bytes, components,
    then for planar input each plane's first byte, width, row repeat
    factor and column repeat factor (sample.repeat_factors).  raw passed
    check_raw."""
    src = np.zeros(16, np.int64)
    H, W, pf = pi.height, pi.width, pi.pixel_format
    src[3] = geo.comp_count
    if raw.dim() > 1:
        nin = raw.shape[2] if raw.dim() == 3 else 1
        src[:3] = 0, nin, W * nin
    elif pf == PixelFormat.P422_U8_P1020:
        src[:3] = 1, 3, 2 * W + pi.width_padding
    elif pf in sample.PLANAR:
        src[:2] = 2, 3
        off = 0
        for k, (ch, cw) in enumerate(sample.plane_sizes(pf, W, H)):
            fy, fx = sample.repeat_factors(ch, cw, W, H)
            src[4 + k], src[7 + k], src[10 + k], src[13 + k] = (off, cw,
                                                                fy, fx)
            off += ch * cw
    else:
        unit = pixel_format_unit_size(pf)
        src[:3] = 0, unit, W * unit + pi.width_padding
    return src


def preprocess_packed_plain(raw: torch.Tensor, geo: Geometry,
                            pi: ImageParameters) -> List[torch.Tensor]:
    """Plain version of preprocess_packed, on any device."""
    return sample.preprocess(raw, geo, pi)


def preprocess_packed(raw: torch.Tensor, geo: Geometry,
                      pi: ImageParameters) -> List[torch.Tensor]:
    """A raw image in any pixel format (check_raw) -> [(data_h, data_w)
    uint8 plane per component], components 0-2 of a 3- or 4-component
    image colour-transformed from pi.color_space to
    geo.param.color_space_internal, component c sampled at (y * dy, x *
    dx) with (dx, dy) its decimation, and zero-padded (sample.preprocess).
    On CUDA one launch writes every plane."""
    check_raw(raw, pi)
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
    src = pre_source(raw, geo, pi)
    inst = pre_instance(raw, planes, g, src)
    _kernels.launch("pre_rgb_to_planes", raw, pi.height, pi.width, g, src,
                    params, *planes, *[None] * (4 - len(planes)), inst,
                    instance=INSTANCES[inst])
    return planes


def pre_geometry(geo: Geometry) -> np.ndarray:
    """(dx, dy, data_h, data_w) of each component's plane, flattened and
    zero past the last component (int32[16]): the preprocessor kernel's
    geometry argument."""
    g = np.zeros((4, 4), np.int32)
    for c in geo.components:
        g[c.index] = (geo.max_h // c.samp_h, geo.max_v // c.samp_v,
                      c.data_height, c.data_width)
    return g.reshape(-1)


def pre_vector(raw: torch.Tensor, planes: List[torch.Tensor],
               geo_i: np.ndarray) -> bool:
    """True when the preprocessor's RGB vector instance takes these tensors
    (csrc/pre_rgb_to_planes.cu): an (H, W, 3) image to 3 planes, plane 0
    at (dx, dy) = (1, 1), planes 1 and 2 of one shape at one (dx, dy) in
    {1, 2}^2, the image 16-byte aligned with W % 16 == 0, and every
    plane's width and address a multiple of its 16 / dx bytes
    (pre_instance tries the other instances where it is False).  geo_i:
    pre_geometry's array."""
    if raw.dim() != 3 or raw.shape[2] != 3 or len(planes) != 3:
        return False
    g = np.asarray(geo_i).reshape(-1, 4)[:3]
    dx, dy = g[1, 0], g[1, 1]
    if (tuple(g[0, :2]) != (1, 1) or tuple(g[2]) != tuple(g[1])
            or dx not in (1, 2) or dy not in (1, 2)
            or raw.shape[1] % 16 or raw.data_ptr() % 16):
        return False
    return all(int(w) % (16 // int(x)) == 0
               and p.data_ptr() % (16 // int(x)) == 0
               for (x, _, _, w), p in zip(g, planes))


#: the pixel kinds of the vector instances, in the order of
#: csrc/pre_rgb_to_planes.cu's VecSource (the input) and csrc/post_rgb.cu's
#: VecTarget (the output): interleaved pixels of 1, 3 and 4 bytes, UYVY,
#: three planes whose chroma repeats or steps 1 or 2 columns
VECTOR_KINDS = ("u8", "rgb", "rgba", "uyvy", "planar", "planar_half")
#: log2 of the chroma steps the vector instances take
_SHIFT = {1: 0, 2: 1, 4: 2}
#: pre_instance's and post_instance's ids -> names (_kernels.INSTANCES
#: counts them): 0 the generic instance, 1 the RGB vector instance, 2 + 3
#: kind + log2(chroma step) a vector instance
INSTANCES = ("generic", "rgb_vector") + tuple(
    f"{k}_dx{1 << s}" for k in VECTOR_KINDS for s in range(3))


def _vector_source(raw: torch.Tensor, src: np.ndarray):
    """The index in VECTOR_KINDS of an input the vector instances
    read with 16-byte loads, or None: interleaved rows of 1, 3 or 4
    channels or UYVY rows, 16-byte aligned with a pitch a multiple of 16;
    or three planes, plane 0 the image at a width a multiple of 16, the
    chroma planes alike at a column repeat of 1 or 2 and a row repeat of
    1, 2 or 4, each plane's first byte and width a multiple of its 16 or 8
    bytes a group."""
    kind, nin, pitch = (int(v) for v in src[:3])
    if raw.data_ptr() % 16:
        return None
    if kind == 0:
        return None if nin not in (1, 3, 4) or pitch % 16 else \
            (1, 3, 4).index(nin)
    if kind == 1:
        return None if pitch % 16 else 3
    off, pw = [int(v) for v in src[4:7]], [int(v) for v in src[7:10]]
    fy, fx = [int(v) for v in src[10:13]], [int(v) for v in src[13:16]]
    if ((fy[0], fx[0]) != (1, 1) or fx[1] not in (1, 2)
            or (fy[2], fx[2], pw[2]) != (fy[1], fx[1], pw[1])
            or fy[1] not in _SHIFT or pw[0] % 16 or off[0] % 16):
        return None
    cb = 16 // fx[1]
    if pw[1] % cb or off[1] % cb or off[2] % cb:
        return None
    return 4 if fx[1] == 1 else 5


def pre_instance(raw: torch.Tensor, planes: List[torch.Tensor],
                 geo_i: np.ndarray, src: np.ndarray) -> int:
    """The preprocessor's instance for these tensors
    (csrc/pre_rgb_to_planes.cu; INSTANCES names them): 1, the RGB vector
    instance, where pre_vector takes them; else 2 + 3 s + log2(dx) a
    vector instance of input kind VECTOR_KINDS[s] (_vector_source)
    where plane 0 (and a 4th) is at (dx, dy) = (1, 1), planes 1 and 2
    alike at dx and dy in {1, 2, 4} (dx 1 for one component), and every
    plane's width and address are multiples of 8; else 0, the generic
    instance.  geo_i: pre_geometry's array; src: pre_source's."""
    if pre_vector(raw, planes, geo_i):
        return 1
    src = np.asarray(src)
    s = _vector_source(raw, src)
    ncomp = int(src[3])
    g = np.asarray(geo_i).reshape(-1, 4)[:ncomp]
    if (s is None or tuple(g[0, :2]) != (1, 1)
            or (ncomp == 4 and tuple(g[3, :2]) != (1, 1))):
        return 0
    sx = 0
    if ncomp >= 2:
        dx, dy = int(g[1, 0]), int(g[1, 1])
        if dx not in _SHIFT or dy not in _SHIFT or (
                ncomp >= 3 and tuple(g[2]) != tuple(g[1])):
            return 0
        sx = _SHIFT[dx]
    if any(int(w) % 8 or p.data_ptr() % 8
           for (_, _, _, w), p in zip(g, planes)):
        return 0
    return 2 + 3 * s + sx


def dpost_decimation(geo: Geometry) -> Tuple[int, int]:
    """(dx, dy): the chroma planes' decimation against luma."""
    cb = geo.components[1]
    return geo.max_h // cb.samp_h, geo.max_v // cb.samp_v


def decode_post_supported(geo: Geometry, pi: ImageParameters) -> bool:
    """True when the dpost kernel covers this configuration (the JAX
    package's gate, gpujpeg_tpu.ops.prepost_kernel.decode_post_supported):
    a non-interleaved scan of 3 components, luma at the largest sampling,
    both chroma planes decimated by one (dx, dy) in {1, 2}^2 and covering
    exactly 1/dx by 1/dy of luma's block grid; P444_U8_P012 or
    P4444_U8_P0123 (alpha 255) output.  Blocks must be contiguous in
    phase C's layout (restart segments fill their rows, or one segment a
    component); the kernel takes any block count, so a ragged last
    segment, which the JAX gate refuses, is allowed.  Row padding is the
    decoder's, after this stage, as in the JAX package."""
    if (pi.pixel_format not in (PixelFormat.P444_U8_P012,
                                PixelFormat.P4444_U8_P0123)
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
    (H, W, 3) uint8 pixels in pi.color_space ((H, W, 4) with alpha 255
    for P4444_U8_P0123), chroma upsampled
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
            "P444_U8_P012 or P4444_U8_P0123 (every other stream and "
            "output: idct_planes + postprocess_packed)")
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
    ob = 4 if pi.pixel_format == PixelFormat.P4444_U8_P0123 else 3
    out = torch.empty((pi.height, pi.width, ob), dtype=torch.uint8,
                      device=coefs_t.device)
    nmat = idct_matrix(coefs_t.device)
    _kernels.require_cuda("dpost_rgb", coefs_t, qtabs, nmat, out)
    c0 = geo.components[0]
    offs = np.asarray([f for f, _ in component_columns(geo)], np.int64)
    params = color.kernel_params(geo.param.color_space_internal,
                                 pi.color_space)
    dx, dy = dpost_decimation(geo)
    return out, (coefs_t, coefs_t.shape[1], offs, c0.mcu_count,
                 c0.data_width // 8, dx, dy, pi.height, pi.width, ob, qtabs,
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


def post_target(geo: Geometry, pi: ImageParameters):
    """(output shape, geo int32[16], target int64[16]) of the
    postprocessor kernel for this geometry and output (the shapes of
    sample.pack_channels): geo = components, store kind (0 interleaved,
    1 UYVY, 2 planar), bytes a pixel of an interleaved output, channels
    before packing (sample.output_channels), then each plane's data_w,
    row and column repeat factors (sample.upsample_factors); target = a
    planar output's planes: first byte, width, row step, column step.
    UYVY at an odd width raises ValueError, as the JAX package's stack
    of unequal halves does."""
    H, W, pf = pi.height, pi.width, pi.pixel_format
    n = geo.comp_count
    nch = sample.output_channels(pf, n)
    g = np.zeros(16, np.int32)
    dst = np.zeros(16, np.int64)
    if pf == PixelFormat.U8:
        shape, kind, unit = (H, W), 0, 1
    elif pf == PixelFormat.P444_U8_P012:
        unit = min(nch, 3)
        shape, kind = (H, W, unit), 0
    elif pf == PixelFormat.P4444_U8_P0123:
        unit = nch if nch >= 4 else nch + 1
        shape, kind = (H, W, unit), 0
    elif pf == PixelFormat.P422_U8_P1020:
        if W % 2:
            raise ValueError(f"UYVY output needs an even width, got {W}")
        shape, kind, unit = (2 * H * W,), 1, 2
    elif pf in sample.PLANAR:
        shape, kind, unit = (image_size_bytes(W, H, pf),), 2, 1
        sampling = pixel_format_sampling(pf)
        max_h = max(sh for sh, _ in sampling)
        max_v = max(sv for _, sv in sampling)
        off = 0
        for k, ((ch, cw), (sh, sv)) in enumerate(
                zip(sample.plane_sizes(pf, W, H), sampling)):
            dh, dw = max_v // sv, max_h // sh
            if (ch, cw) != (-(-H // dh), -(-W // dw)):
                raise ValueError(f"plane {k} of {pf.name} is not the "
                                 "image sampled at its steps")
            dst[[k, 3 + k, 6 + k, 9 + k]] = off, cw, dh, dw
            off += ch * cw
    else:
        raise ValueError(f"unsupported pixel format {pf}")
    fac = sample.upsample_factors(geo, pi)
    g[:4] = n, kind, unit, nch
    for c, (fy, fx) in zip(geo.components, fac):
        g[4 + c.index], g[8 + c.index], g[12 + c.index] = (c.data_width,
                                                           fy, fx)
    return shape, g, dst


def postprocess_packed(planes: List[torch.Tensor], geo: Geometry,
                       pi: ImageParameters) -> torch.Tensor:
    """[(data_h, data_w) uint8 plane per component] in
    geo.param.color_space_internal -> the raw image of pi.pixel_format in
    pi.color_space (sample.postprocess: chroma upsampled
    nearest-neighbour by sample.upsample_factors, one component filled to
    three with 128 unless the output is U8, a 4th component raw; the
    shapes of post_target).  On CUDA one launch of csrc/post_rgb.cu."""
    if len(planes) != geo.comp_count:
        raise ValueError(f"expected {geo.comp_count} planes, got "
                         f"{len(planes)}")
    for c, p in zip(geo.components, planes):
        if p.dtype != torch.uint8 or tuple(p.shape) != (c.data_height,
                                                        c.data_width):
            raise ValueError(f"component {c.index}: expected a "
                             f"({c.data_height}, {c.data_width}) uint8 "
                             f"plane, got {tuple(p.shape)} {p.dtype}")
    if planes[0].device.type == "cpu":
        return postprocess_packed_plain(planes, geo, pi)
    shape, g, dst = post_target(geo, pi)
    out = torch.empty(shape, dtype=torch.uint8, device=planes[0].device)
    _kernels.require_cuda("post_rgb", *planes, out)
    params = color.kernel_params(geo.param.color_space_internal,
                                 pi.color_space)
    inst = post_instance(planes, g, dst, out, pi.width)
    _kernels.launch("post_rgb", *planes, *[None] * (4 - len(planes)), g,
                    pi.height, pi.width, dst, params, out, inst,
                    instance=INSTANCES[inst])
    return out


def post_instance(planes: List[torch.Tensor], g: np.ndarray,
                  dst: np.ndarray, out: torch.Tensor, W: int) -> int:
    """The postprocessor's instance for these tensors (csrc/post_rgb.cu;
    INSTANCES names them), from post_target's g and dst: 1, the RGB
    instance, for 3 planes to 3-byte pixels with plane 0 at (fy, fx) =
    (1, 1), planes 1 and 2 alike in {1, 2}^2 and every plane's address and
    width multiples of 8; else 2 + 3 t + log2(fx) a vector instance of
    output kind VECTOR_KINDS[t] for 1, 3 or 4 planes with those
    multiples of 8, plane 0 (and a 4th) at (1, 1), planes 1 and 2 alike
    with fy, fx in {1, 2, 4}, and out 16-byte aligned: interleaved pixels
    of 1, 3 or 4 bytes whose rows hold whole 16-byte vectors, UYVY at W %
    8 == 0, or three planes with plane 0 the image, planes 1 and 2 alike
    at column and row steps in {1, 2}, every plane's first byte and width
    a multiple of 16; else 0, the generic instance."""
    ncomp, kind, unit, nch = (int(v) for v in g[:4])
    stride = [int(v) for v in g[4:8]]
    fy, fx = [int(v) for v in g[8:12]], [int(v) for v in g[12:16]]
    al8 = all(p.data_ptr() % 8 == 0 and w % 8 == 0
              for p, w in zip(planes, stride))
    if (kind == 0 and ncomp == nch == unit == 3 and al8
            and (fy[0], fx[0]) == (1, 1) and (fy[2], fx[2]) == (fy[1], fx[1])
            and fy[1] in (1, 2) and fx[1] in (1, 2)):
        return 1
    if (not al8 or out.data_ptr() % 16 or ncomp == 2
            or (fy[0], fx[0]) != (1, 1)
            or (ncomp == 4 and (fy[3], fx[3]) != (1, 1))):
        return 0
    sx = 0
    if ncomp >= 3:
        if (fy[1] not in _SHIFT or fx[1] not in _SHIFT
                or (fy[2], fx[2], stride[2]) != (fy[1], fx[1], stride[1])):
            return 0
        sx = _SHIFT[fx[1]]
    if kind == 0:
        if unit not in (1, 3, 4) or W * unit % 16:
            return 0
        t = (1, 3, 4).index(unit)
    elif kind == 1:
        if W % 8:
            return 0
        t = 3
    else:
        off, pw = [int(v) for v in dst[0:3]], [int(v) for v in dst[3:6]]
        dh, dw = [int(v) for v in dst[6:9]], [int(v) for v in dst[9:12]]
        if ((dh[0], dw[0]) != (1, 1) or (dh[2], dw[2]) != (dh[1], dw[1])
                or dh[1] not in (1, 2) or dw[1] not in (1, 2)
                or any(o % 16 or w % 16 for o, w in zip(off, pw))):
            return 0
        t = 4 if dw[1] == 1 else 5
    return 2 + 3 * t + sx
