"""Pre- and postprocessor in plain PyTorch (gpujpeg_tpu.ops.sample).

Encode side: a raw image in any of the seven pixel formats -> its
full-resolution channels (unpack_to_channels) -> one zero-padded uint8
plane per component (preprocess): chroma filled with 128 where the input
has fewer channels than components (gpujpeg_preprocessor.cu:95-98),
decimated first (subsampling is pure selection,
gpujpeg_preprocessor.cu:51-64, so it commutes with the per-pixel colour
transform), colour-converted for components 0-2 of an image of three or
more components (any 4th raw), then zero-padded to the component's
(data_height, data_width) — the reference zeroes its device buffers
(gpujpeg_common.c:941-944).

Decode side (postprocess): each component's plane is upsampled
nearest-neighbour to the image (_upsample_to: every row repeated
ceil(H / height) times, every column ceil(W / width) times), a single
component is filled to three with 128 unless the output is U8
(gpujpeg_postprocessor.cu:128-168), the first three channels are
colour-converted from the stream's internal colour space
(gpujpeg_postprocessor.cu:51-113), and the channels are packed for the
output format (pack_channels): (H, W) for U8, (H, W, C) for the
interleaved formats, a flat (N,) buffer for UYVY and the planar formats
(libyuv plane sizes, types.image_size_bytes).

These are the plain versions of the CUDA pre- and postprocessor
(ops/prepost_kernel.preprocess_packed, postprocess_packed), and the
second half of the fused decode tail's (decode_post_plain).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..types import (ImageParameters, PixelFormat, pixel_format_sampling,
                     pixel_format_unit_size)
from ..utils.geometry import Geometry
from . import color

PLANAR = (PixelFormat.P444_U8_P0P1P2, PixelFormat.P422_U8_P0P1P2,
          PixelFormat.P420_U8_P0P1P2)


def plane_sizes(pf: PixelFormat, width: int,
                height: int) -> List[Tuple[int, int]]:
    """(height, width) of each plane of a planar format (libyuv sizing,
    types.image_size_bytes)."""
    sampling = pixel_format_sampling(pf)
    max_h = max(s[0] for s in sampling)
    max_v = max(s[1] for s in sampling)
    return [((height * sv + max_v - 1) // max_v,
             (width * sh + max_h - 1) // max_h) for sh, sv in sampling]


def _split_planar(raw: torch.Tensor, pf: PixelFormat, width: int,
                  height: int) -> List[torch.Tensor]:
    """A flat planar buffer -> its planes as 2-D views."""
    planes, off = [], 0
    for ch, cw in plane_sizes(pf, width, height):
        planes.append(raw[off:off + cw * ch].reshape(ch, cw))
        off += cw * ch
    return planes


def repeat_factors(ph: int, pw: int, width: int,
                   height: int) -> Tuple[int, int]:
    """(fy, fx): the row and column repeat counts that take a (ph, pw)
    plane up to (height, width) (_upsample_to)."""
    return -(-height // ph), -(-width // pw)


def _upsample_to(plane: torch.Tensor, width: int,
                 height: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of a plane to (height, width)
    (gpujpeg_tpu.ops.sample._upsample_to)."""
    fy, fx = repeat_factors(plane.shape[0], plane.shape[1], width, height)
    if fy == 1 and fx == 1:
        return plane[:height, :width]
    return plane.repeat_interleave(fy, 0).repeat_interleave(fx, 1)[
        :height, :width]


def unpack_to_channels(raw: torch.Tensor,
                       pi: ImageParameters) -> torch.Tensor:
    """A raw image -> (H, W, C) int32 full-resolution channels.  A 3-D
    tensor is taken as (H, W, C) channels and a 2-D one as one channel,
    whatever pi.pixel_format says; a flat buffer (image_size_bytes long,
    rows padded by pi.width_padding bytes for the packed formats) is
    unpacked by the format."""
    W, H = pi.width, pi.height
    pf = pi.pixel_format
    if raw.dim() == 3:
        return raw.to(torch.int32)
    if raw.dim() == 2:
        return raw.to(torch.int32)[..., None]
    raw = raw.reshape(-1)
    if pi.width_padding:
        # rows padded to W * unit + width_padding bytes
        # (gpujpeg_common.h:283-294, preprocessor.cu:189)
        unit = pixel_format_unit_size(pf)
        if unit == 0:
            raise ValueError(
                "width_padding is only supported for packed pixel formats")
        raw = raw.reshape(H, W * unit + pi.width_padding)[:, :W * unit]
    if pf == PixelFormat.U8:
        return raw.reshape(H, W, 1).to(torch.int32)
    if pf == PixelFormat.P444_U8_P012:
        return raw.reshape(H, W, 3).to(torch.int32)
    if pf == PixelFormat.P4444_U8_P0123:
        return raw.reshape(H, W, 4).to(torch.int32)
    if pf == PixelFormat.P422_U8_P1020:
        # UYVY: u y0 v y1 (gpujpeg_preprocessor.cu
        # raw_to_comp_load<422_U8_P1020>); an odd width raises TypeError,
        # the JAX package's reshape error
        if W % 2:
            raise TypeError(f"cannot unpack UYVY rows of odd width {W}")
        b = raw.reshape(H, W // 2, 4).to(torch.int32)
        y = b[:, :, 1::2].reshape(H, W)
        u = b[:, :, 0].repeat_interleave(2, 1)
        v = b[:, :, 2].repeat_interleave(2, 1)
        return torch.stack([y, u, v], dim=-1)
    if pf in PLANAR:
        return torch.stack([_upsample_to(p, W, H).to(torch.int32)
                            for p in _split_planar(raw, pf, W, H)], dim=-1)
    raise ValueError(f"unsupported pixel format {pf}")


def preprocess(raw: torch.Tensor, geo: Geometry,
               pi: ImageParameters) -> List[torch.Tensor]:
    """A raw image -> [(data_height, data_width) uint8 plane per
    component], components 0-2 of a 3- or 4-component image converted
    from pi.color_space to geo.param.color_space_internal, component c
    sampled at (y * dy, x * dx) with (dx, dy) its decimation."""
    chans = unpack_to_channels(raw, pi)
    ncomp = geo.comp_count
    if chans.shape[-1] < ncomp:
        # greyscale encoded as more components: chroma = 128
        fill = torch.full(chans.shape[:-1] + (ncomp - chans.shape[-1],),
                          128, dtype=torch.int32, device=chans.device)
        chans = torch.cat([chans, fill], dim=-1)
    planes = []
    for c in geo.components:
        sub = chans[::geo.max_v // c.samp_v, ::geo.max_h // c.samp_h]
        if ncomp >= 3 and c.index < 3:
            val = color.convert_channels(
                sub[..., 0], sub[..., 1], sub[..., 2], pi.color_space,
                geo.param.color_space_internal)[c.index]
        else:
            val = sub[..., c.index]
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
            out.append(repeat_factors(c.height, c.width, pi.width,
                                      pi.height))
        else:
            out.append((1, 1))
    return out


def output_channels(pf: PixelFormat, ncomp: int) -> int:
    """Channels of the converted image before packing: the components,
    or 3 for one component packed to anything but U8."""
    return 3 if ncomp == 1 and pf != PixelFormat.U8 else ncomp


def pack_channels(chans: torch.Tensor, pi: ImageParameters) -> torch.Tensor:
    """(H, W, C) integer channels -> the raw buffer of pi.pixel_format:
    (H, W) uint8 for U8, (H, W, C) for the interleaved formats, flat (N,)
    for UYVY and the planar formats."""
    W, H = pi.width, pi.height
    pf = pi.pixel_format
    if pf == PixelFormat.U8:
        return chans[..., 0].to(torch.uint8)
    if pf == PixelFormat.P444_U8_P012:
        return chans[..., :3].to(torch.uint8)
    if pf == PixelFormat.P4444_U8_P0123:
        if chans.shape[-1] < 4:
            alpha = torch.full(chans.shape[:-1] + (1,), 255,
                               dtype=chans.dtype, device=chans.device)
            chans = torch.cat([chans, alpha], dim=-1)
        return chans.to(torch.uint8)
    if pf == PixelFormat.P422_U8_P1020:
        if W % 2:      # the JAX package's stack of unequal halves
            raise ValueError(f"UYVY output needs an even width, got {W}")
        y = chans[..., 0]
        out = torch.stack([chans[:, ::2, 1], y[:, ::2], chans[:, ::2, 2],
                           y[:, 1::2]], dim=-1)
        return out.reshape(H, W * 2).to(torch.uint8).reshape(-1)
    if pf in PLANAR:
        sampling = pixel_format_sampling(pf)
        max_h = max(s[0] for s in sampling)
        max_v = max(s[1] for s in sampling)
        parts = []
        for i, ((ch, cw), (sh, sv)) in enumerate(
                zip(plane_sizes(pf, W, H), sampling)):
            p = chans[::max_v // sv, ::max_h // sh, i][:ch, :cw]
            p = F.pad(p, (0, cw - p.shape[1], 0, ch - p.shape[0]))
            parts.append(p.reshape(-1))
        return torch.cat(parts).to(torch.uint8)
    raise ValueError(f"unsupported pixel format {pf}")


def flip_remap(x: torch.Tensor, flipped: bool, remap) -> torch.Tensor:
    """The sessions' flip and channel-remap options on an image, as torch
    ops on its device (the JAX package's apply_pre_transform on encode and
    Decoder._apply_output_options on decode, the reference's
    preprocessor and postprocessor options, gpujpeg_preprocessor.cu:
    456-559): a vertical flip of an image of 2 or more dimensions (never
    of a flat buffer), then a remap of an (H, W, C) image only, remap a
    string like '210F' (a digit is a source channel, F all ones, Z all
    zeros)."""
    if flipped and x.dim() >= 2:
        x = x.flip(0)
    if remap and x.dim() == 3:
        chans = []
        for ch in remap:
            if ch in "Ff":
                chans.append(torch.full(x.shape[:2], 255, dtype=x.dtype,
                                        device=x.device))
            elif ch in "Zz":
                chans.append(torch.zeros(x.shape[:2], dtype=x.dtype,
                                         device=x.device))
            else:
                chans.append(x[:, :, int(ch)])
        x = torch.stack(chans, dim=-1)
    return x


def postprocess(planes: Sequence[torch.Tensor], geo: Geometry,
                pi: ImageParameters) -> torch.Tensor:
    """[(data_height, data_width) integer plane per component] in
    geo.param.color_space_internal -> the uint8 raw image of
    pi.pixel_format in pi.color_space (pack_channels' shapes)."""
    H, W = pi.height, pi.width
    full = []
    for c, (fy, fx) in zip(geo.components, upsample_factors(geo, pi)):
        p = planes[c.index][:c.height, :c.width]
        full.append(p.repeat_interleave(fy, 0).repeat_interleave(fx, 1)
                    [:H, :W].to(torch.int32))
    if output_channels(pi.pixel_format, geo.comp_count) > geo.comp_count:
        full += [torch.full_like(full[0], 128)] * 2
    if len(full) >= 3:
        full[:3] = color.convert_channels(full[0], full[1], full[2],
                                          geo.param.color_space_internal,
                                          pi.color_space)
    return pack_channels(torch.stack(full, dim=-1), pi)
