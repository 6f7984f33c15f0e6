"""Public parameter types of the baseline-JPEG engine (PyTorch port).

Mirrors the capability surface of GPUJPEG's public headers
(reference: libgpujpeg/gpujpeg_type.h:85-134, libgpujpeg/gpujpeg_common.h:176-294)
re-expressed as Python enums/dataclasses.  A copy of gpujpeg_tpu.types plus
from_reference().  These are *static* configuration objects: everything
derived from them (geometry, tables, kernel arguments) is fixed per
configuration.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class ColorSpace(enum.Enum):
    """Color spaces supported by the codec (gpujpeg_type.h:85-94)."""

    NONE = 0
    RGB = 1
    YCBCR_BT601 = 2          # limited-range BT.601
    YCBCR_BT601_256LVLS = 3  # full-range BT.601 (JPEG internal default)
    YCBCR_BT709 = 4          # limited-range BT.709
    YUV = 5                  # deprecated legacy YUV

    @property
    def is_ycbcr(self) -> bool:
        return self in (
            ColorSpace.YCBCR_BT601,
            ColorSpace.YCBCR_BT601_256LVLS,
            ColorSpace.YCBCR_BT709,
            ColorSpace.YUV,
        )


# Aliases matching the reference naming
CS_DEFAULT = ColorSpace.NONE
YCBCR_JPEG = ColorSpace.YCBCR_BT601_256LVLS


class PixelFormat(enum.Enum):
    """Pixel formats for raw input/output images (gpujpeg_type.h:108-134)."""

    NONE = -1
    U8 = 0              # grayscale
    P444_U8_P012 = 1    # interleaved RGB / 444
    P444_U8_P0P1P2 = 2  # planar 444
    P422_U8_P1020 = 3   # UYVY packed
    P422_U8_P0P1P2 = 4  # planar 422
    P420_U8_P0P1P2 = 5  # planar 420
    P4444_U8_P0123 = 6  # interleaved, 4 channels (RGBA / padded)


# Pseudo pixel formats the decoder accepts as an output request
# (gpujpeg_decoder.h:233-246).
class PixelFormatRequest(enum.Enum):
    AUTODETECT = 100
    NO_ALPHA = 101
    STD = 102
    NATIVE = 103


#: comp count, bytes per pixel (0 = planar/fractional), implied subsampling
_PF_INFO = {
    PixelFormat.U8: (1, 1, ((1, 1),)),
    PixelFormat.P444_U8_P012: (3, 3, ((1, 1), (1, 1), (1, 1))),
    PixelFormat.P444_U8_P0P1P2: (3, 0, ((1, 1), (1, 1), (1, 1))),
    PixelFormat.P422_U8_P1020: (3, 2, ((2, 1), (1, 1), (1, 1))),
    PixelFormat.P422_U8_P0P1P2: (3, 0, ((2, 1), (1, 1), (1, 1))),
    PixelFormat.P420_U8_P0P1P2: (3, 0, ((2, 2), (1, 1), (1, 1))),
    PixelFormat.P4444_U8_P0123: (4, 4, ((1, 1), (1, 1), (1, 1), (1, 1))),
}


def pixel_format_comp_count(pf: PixelFormat) -> int:
    return _PF_INFO[pf][0]


def pixel_format_sampling(pf: PixelFormat) -> Tuple[Tuple[int, int], ...]:
    return _PF_INFO[pf][2]


def pixel_format_unit_size(pf: PixelFormat) -> int:
    """Bytes per pixel for packed formats, 0 for planar
    (gpujpeg_pixel_format_get_unit_size)."""
    return _PF_INFO[pf][1]


def pixel_format_is_planar(pf: PixelFormat) -> bool:
    return pf in (
        PixelFormat.P444_U8_P0P1P2,
        PixelFormat.P422_U8_P0P1P2,
        PixelFormat.P420_U8_P0P1P2,
        PixelFormat.U8,
    )


def pixel_format_is_interleaved(pf: PixelFormat) -> bool:
    """Sample-interleaved packed formats (not to be confused with
    Parameters.interleaved which refers to JPEG scan interleaving)."""
    return pf in (
        PixelFormat.P444_U8_P012,
        PixelFormat.P422_U8_P1020,
        PixelFormat.P4444_U8_P0123,
    )


def image_size_bytes(width: int, height: int, pf: PixelFormat) -> int:
    """Raw image byte size (reference: gpujpeg_common.c:1179-1205)."""
    comp_count, bpp, samp = _PF_INFO[pf]
    if bpp:
        return width * height * bpp
    # planar: per-plane size with rounded-up subsampled dims (libyuv style,
    # gpujpeg_common.c:700-710)
    max_h = max(s[0] for s in samp)
    max_v = max(s[1] for s in samp)
    total = 0
    for (sh, sv) in samp:
        cw = (width * sh + max_h - 1) // max_h
        ch = (height * sv + max_v - 1) // max_v
        total += cw * ch
    return total


class HeaderType(enum.IntFlag):
    """JPEG application header selection (gpujpeg_type.h:96-103)."""

    DEFAULT = 0
    JFIF = 1
    SPIFF = 2
    ADOBE = 4
    EXIF = 8


#: restart_interval sentinel values (gpujpeg_common.h:157-160)
RESTART_AUTO = -1
RESTART_NONE = 0

BLOCK_SIZE = 8


@dataclasses.dataclass(frozen=True)
class SamplingFactor:
    horizontal: int = 1
    vertical: int = 1


def subsampling_name(comp_count: int, sampling) -> str:
    """J:a:b[:alpha] name for a sampling-factor set
    (gpujpeg_subsampling_get_name, src/gpujpeg_common.c:1905-1951;
    golden-tested against the reference unit test's pairs).

    sampling: sequence of (h, v) pairs or SamplingFactor."""
    sf = [(s.horizontal, s.vertical) if isinstance(s, SamplingFactor)
          else tuple(s) for s in sampling][:comp_count]
    if comp_count == 1:
        return "4:0:0"
    if comp_count == 2 and sf[0][1] == sf[1][1]:
        return f"4:0:0:{4 // sf[0][0] * sf[1][0]}"
    if (comp_count >= 3 and sf[1][0] == sf[2][0] and sf[1][1] == sf[2][0]
            and (comp_count == 3
                 or (comp_count == 4 and sf[0][1] == sf[3][1]))):
        a = 4 // sf[0][0] * sf[1][0]
        vert_change = (2 // sf[0][1] * sf[1][1]) == 2
        b = a if vert_change else 0
        name = f"4:{a}:{b}"
        if comp_count == 4:
            name += f":{4 // sf[0][0] * sf[3][0]}"
        return name
    # non-standard named rates (gpujpeg_common.h:251-253)
    if sf == [(1, 2), (1, 2), (1, 1)]:
        return "4:4:2"
    if sf == [(2, 2), (2, 1), (1, 1)]:
        return "4:2:1"
    return ":".join(f"{h}-{v}" for h, v in sf)


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Encoding/decoding parameters (gpujpeg_common.h:176-215).

    Frozen so instances can key geometry caches.
    """

    quality: int = 75
    restart_interval: int = 8
    interleaved: bool = False
    segment_info: bool = False
    comp_count: int = 0  # 0 = derive from pixel format
    sampling_factor: Tuple[SamplingFactor, ...] = (
        SamplingFactor(1, 1),
        SamplingFactor(1, 1),
        SamplingFactor(1, 1),
        SamplingFactor(1, 1),
    )
    color_space_internal: ColorSpace = ColorSpace.YCBCR_BT601_256LVLS
    header_type: HeaderType = HeaderType.DEFAULT
    verbose: int = 0
    perf_stats: bool = False
    #: AC Huffman table family: 'tuned' = per-quality computable canonical
    #: tables (smaller streams AND the fast arithmetic tokenizer path;
    #: utils/tables.py AFFINE_AC_PARAMS), 'annexk' = the T.81 Annex-K
    #: defaults the reference always uses (gpujpeg_table.c:189-256).
    #: Either family produces standard baseline JPEG (tables ride in DHT).
    huffman_tables: str = "tuned"

    def with_(self, **kw) -> "Parameters":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def default() -> "Parameters":
        """Defaults per gpujpeg_set_default_parameters (gpujpeg_common.c:291-306)."""
        return Parameters()

    def chroma_subsampled(self, sampling: Tuple[Tuple[int, int], ...]) -> "Parameters":
        sf = tuple(SamplingFactor(h, v) for (h, v) in sampling)
        sf = sf + (SamplingFactor(1, 1),) * (4 - len(sf))
        return dataclasses.replace(self, sampling_factor=sf, comp_count=len(sampling))


@dataclasses.dataclass(frozen=True)
class ImageParameters:
    """Raw image description (gpujpeg_common.h:283-294)."""

    width: int = 0
    height: int = 0
    color_space: ColorSpace = ColorSpace.RGB
    pixel_format: PixelFormat = PixelFormat.P444_U8_P012
    width_padding: int = 0

    def with_(self, **kw) -> "ImageParameters":
        return dataclasses.replace(self, **kw)

    @property
    def pixels(self) -> int:
        return self.width * self.height

    @property
    def comp_count(self) -> int:
        return pixel_format_comp_count(self.pixel_format)


class GpujpegError(Exception):
    """Base error type."""


class RestartChangeError(GpujpegError):
    """Restart interval changed mid-stream (GPUJPEG_ERR_RESTART_CHANGE,
    gpujpeg_type.h:74-77)."""


class UnsupportedStreamError(GpujpegError):
    """Progressive/lossless/arithmetic or otherwise unsupported SOF
    (reference: gpujpeg_reader.c:1437-1469)."""


class CorruptStreamError(GpujpegError):
    """Malformed codestream."""


@dataclasses.dataclass
class Orientation:
    """SPIFF-style orientation metadata (gpujpeg_type.h:145-163)."""

    rotation: int = 0  # multiples of 90° clockwise
    flip: bool = False


@dataclasses.dataclass
class ImageInfo:
    """Probe result (gpujpeg_decoder.h:267-291)."""

    width: int = 0
    height: int = 0
    comp_count: int = 0
    color_space: ColorSpace = ColorSpace.NONE
    pixel_format: PixelFormat = PixelFormat.NONE
    interleaved: bool = False
    restart_interval: int = 0
    segment_count: int = 0
    header_type: HeaderType = HeaderType.DEFAULT
    quality: Optional[int] = None
    comment: Optional[str] = None
    orientation: Optional[Orientation] = None
    #: per-component (h, v) sampling factors from SOF0
    sampling: Tuple = ()


def default_parameters() -> Parameters:
    return Parameters.default()


def default_image_parameters() -> ImageParameters:
    return ImageParameters()


def _port_value(value, like):
    """Map one field value of a foreign instance onto the port's type of
    `like` (the port's default for that field): enums by member name
    (a pixel format may also be a decoder request), sampling factors by
    their fields, nested dataclasses field by field, everything else as
    is."""
    if isinstance(like, enum.Enum):
        cls = type(like)
        name = getattr(value, "name", None)
        if name in cls.__members__:
            return cls[name]
        if cls is PixelFormat and name in PixelFormatRequest.__members__:
            return PixelFormatRequest[name]
        return cls(int(value))
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return from_reference(value)
    if isinstance(like, tuple) and like and isinstance(like[0],
                                                        SamplingFactor):
        return tuple(SamplingFactor(int(s.horizontal), int(s.vertical))
                     for s in value)
    return value


def from_reference(obj):
    """Build the port's Parameters, ImageParameters, ImageInfo or
    Orientation from any object with the same dataclass fields (for
    example one of the JAX package's instances).  Duck-typed: the class is
    picked by the object's class name, enums are mapped by member name."""
    kinds = {"Parameters": Parameters, "ImageParameters": ImageParameters,
             "ImageInfo": ImageInfo, "Orientation": Orientation}
    cls = kinds.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"cannot convert {type(obj).__name__!r}: expected "
                        "Parameters, ImageParameters, ImageInfo or "
                        "Orientation")
    default = cls()
    kw = {f.name: _port_value(getattr(obj, f.name), getattr(default, f.name))
          for f in dataclasses.fields(cls)}
    return cls(**kw)
