"""Image file formats: extension map, name maps, implied parameters.

Re-expresses the reference's format dispatch
(src/gpujpeg_common.c:402-495 extension table and implied color spaces,
src/gpujpeg_common.c:2031-2083 name maps).

The port's copy of gpujpeg_tpu.io.formats.
"""

from __future__ import annotations

import enum
import os
from typing import Optional

from ..types import ColorSpace, ImageParameters, PixelFormat


class FileFormat(enum.Enum):
    UNKNOWN = 0
    RAW = 1
    RGB = 2
    RGBA = 3
    YUV = 4
    YUVA = 5
    UYVY = 6
    I420 = 7
    GRAY = 8
    JPEG = 9
    BMP = 10
    GIF = 11
    PNG = 12
    TGA = 13
    PNM = 14
    PGM = 15
    PPM = 16
    PAM = 17
    Y4M = 18
    TST = 19


#: extension -> format (gpujpeg_common.c:406-433)
_EXT_MAP = {
    "raw": FileFormat.RAW,
    "rgb": FileFormat.RGB,
    "rgba": FileFormat.RGBA,
    "yuv": FileFormat.YUV,
    "yuva": FileFormat.YUVA,
    "uyvy": FileFormat.UYVY,
    "i420": FileFormat.I420,
    "r": FileFormat.GRAY,
    "jpg": FileFormat.JPEG,
    "jpeg": FileFormat.JPEG,
    "jfif": FileFormat.JPEG,
    "bmp": FileFormat.BMP,
    "gif": FileFormat.GIF,
    "png": FileFormat.PNG,
    "tga": FileFormat.TGA,
    "pnm": FileFormat.PNM,
    "pgm": FileFormat.PGM,
    "ppm": FileFormat.PPM,
    "pam": FileFormat.PAM,
    "y4m": FileFormat.Y4M,
    "tst": FileFormat.TST,
    "xxx": FileFormat.RAW,
}


def get_file_format(filename: str) -> FileFormat:
    ext = os.path.splitext(filename)[1].lstrip(".").lower()
    return _EXT_MAP.get(ext, FileFormat.UNKNOWN)


#: pixel-format names (gpujpeg_print_pixel_formats, gpujpeg_common.c:2040-2047)
PIXEL_FORMAT_NAMES = {
    "u8": PixelFormat.U8,
    "444-u8-p012": PixelFormat.P444_U8_P012,
    "444-u8-p0p1p2": PixelFormat.P444_U8_P0P1P2,
    "422-u8-p1020": PixelFormat.P422_U8_P1020,
    "422-u8-p0p1p2": PixelFormat.P422_U8_P0P1P2,
    "420-u8-p0p1p2": PixelFormat.P420_U8_P0P1P2,
    "4444-u8-p0123": PixelFormat.P4444_U8_P0123,
}

PIXEL_FORMAT_BY_VALUE = {v: k for k, v in PIXEL_FORMAT_NAMES.items()}


def pixel_format_by_name(name: str) -> Optional[PixelFormat]:
    return PIXEL_FORMAT_NAMES.get(name)


#: color-space names (gpujpeg_color_space_by_name, gpujpeg_common.c:2054-2079)
COLOR_SPACE_NAMES = {
    "rgb": ColorSpace.RGB,
    "yuv": ColorSpace.YUV,
    "ycbcr": ColorSpace.YCBCR_BT709,
    "ycbcr-jpeg": ColorSpace.YCBCR_BT601_256LVLS,
    "ycbcr-bt601": ColorSpace.YCBCR_BT601,
    "ycbcr-bt709": ColorSpace.YCBCR_BT709,
}

COLOR_SPACE_DISPLAY = {
    ColorSpace.NONE: "(default CS)",
    ColorSpace.RGB: "RGB",
    ColorSpace.YUV: "YUV",
    ColorSpace.YCBCR_BT601: "YCbCr BT.601 (limited range)",
    ColorSpace.YCBCR_BT601_256LVLS: "YCbCr BT.601 256 Levels (YCbCr JPEG)",
    ColorSpace.YCBCR_BT709: "YCbCr BT.709 (limited range)",
}


def color_space_by_name(name: str) -> Optional[ColorSpace]:
    return COLOR_SPACE_NAMES.get(name)


def implied_parameters(fmt: FileFormat) -> ImageParameters:
    """Color space / pixel format implied by a raw file extension
    (gpujpeg_image_get_properties, gpujpeg_common.c:1312-1370)."""
    cs = ColorSpace.NONE
    pf = PixelFormat.NONE
    if fmt in (FileFormat.GRAY, FileFormat.Y4M, FileFormat.YUV,
               FileFormat.YUVA, FileFormat.UYVY, FileFormat.I420):
        cs = ColorSpace.YCBCR_BT601_256LVLS
    elif fmt in (FileFormat.RGB, FileFormat.RGBA, FileFormat.BMP,
                 FileFormat.GIF, FileFormat.PNG, FileFormat.TGA,
                 FileFormat.PGM, FileFormat.PPM, FileFormat.PNM,
                 FileFormat.PAM):
        cs = ColorSpace.RGB
    pf = {
        FileFormat.GRAY: PixelFormat.U8,
        FileFormat.RGB: PixelFormat.P444_U8_P012,
        FileFormat.YUV: PixelFormat.P444_U8_P012,
        FileFormat.RGBA: PixelFormat.P4444_U8_P0123,
        FileFormat.YUVA: PixelFormat.P4444_U8_P0123,
        FileFormat.UYVY: PixelFormat.P422_U8_P1020,
        FileFormat.I420: PixelFormat.P420_U8_P0P1P2,
    }.get(fmt, PixelFormat.NONE)
    return ImageParameters(color_space=cs, pixel_format=pf)
