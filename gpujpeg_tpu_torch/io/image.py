"""Image file load/save/probe dispatch.

Equivalent of the reference's delegate layer (src/utils/image_delegate.c,
gpujpeg_image_load_from_file / _save_to_file / _get_properties in
src/gpujpeg_common.c:1216-1370): extension decides the handler; raw formats
carry implied color space / pixel format; BMP/PNG/TGA/GIF go through PIL
(standing in for the vendored stb_image/fpnge).

The port's copy of gpujpeg_tpu.io.image.
"""

from __future__ import annotations

import io as _io
import os
from typing import Optional, Tuple

import numpy as np

from ..types import (ColorSpace, ImageParameters, PixelFormat,
                     image_size_bytes, pixel_format_comp_count)
from . import formats, pnm, tst, y4m
from .formats import FileFormat


def _pil_load(data: bytes) -> Tuple[np.ndarray, ImageParameters]:
    from PIL import Image

    img = Image.open(_io.BytesIO(data))
    if img.mode == "P":
        img = img.convert("RGBA" if "transparency" in img.info else "RGB")
    if img.mode == "LA":
        img = img.convert("RGBA")
    if img.mode not in ("L", "RGB", "RGBA"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    depth = 1 if arr.ndim == 2 else arr.shape[2]
    pf = {1: PixelFormat.U8, 3: PixelFormat.P444_U8_P012,
          4: PixelFormat.P4444_U8_P0123}[depth]
    # 1-channel files treated as full-range luma (image_delegate.c:541-549)
    cs = (ColorSpace.YCBCR_BT601_256LVLS if depth == 1 else ColorSpace.RGB)
    return arr, ImageParameters(width=arr.shape[1], height=arr.shape[0],
                                color_space=cs, pixel_format=pf)


#: TGA RLE compression toggle (reference dec_opt_tga_rle,
#: image_delegate.c:470-474)
TGA_RLE = True


def _pil_save(path: str, pi: ImageParameters, arr: np.ndarray) -> None:
    from PIL import Image

    img = Image.fromarray(arr)
    if path.lower().endswith(".tga"):
        img.save(path, rle=TGA_RLE)
    else:
        img.save(path)


def load(filename: str):
    """Load a raw image file -> (array, ImageParameters).

    Interleaved formats return (H, W[, C]) arrays; planar formats return a
    flat (N,) uint8 buffer (plane-ordered, like the reference's raw loads).
    """
    fmt = formats.get_file_format(filename)
    if fmt == FileFormat.TST:
        return tst.generate(filename)
    with open(filename, "rb") as f:
        data = f.read()
    if fmt in (FileFormat.PNM, FileFormat.PGM, FileFormat.PPM,
               FileFormat.PAM):
        return pnm.load_pnm(data)
    if fmt == FileFormat.Y4M:
        return y4m.load_y4m(data)
    if fmt in (FileFormat.BMP, FileFormat.GIF, FileFormat.PNG,
               FileFormat.TGA):
        return _pil_load(data)
    if fmt in (FileFormat.RAW, FileFormat.RGB, FileFormat.RGBA,
               FileFormat.YUV, FileFormat.YUVA, FileFormat.UYVY,
               FileFormat.I420, FileFormat.GRAY):
        pi = formats.implied_parameters(fmt)
        return np.frombuffer(data, np.uint8).copy(), pi
    raise ValueError(f"unrecognized image extension: {filename}")


def probe(filename: str, file_exists: bool = True) -> ImageParameters:
    """Image properties without a full decode
    (gpujpeg_image_get_properties, gpujpeg_common.c:1312-1370)."""
    fmt = formats.get_file_format(filename)
    if fmt == FileFormat.TST:
        pi, _ = tst.parse_tst_filename(filename)
        return pi
    if not file_exists or not os.path.exists(filename):
        return formats.implied_parameters(fmt)
    if fmt in (FileFormat.PNM, FileFormat.PGM, FileFormat.PPM,
               FileFormat.PAM, FileFormat.Y4M, FileFormat.BMP,
               FileFormat.GIF, FileFormat.PNG, FileFormat.TGA):
        arr, pi = load(filename)
        return pi
    return formats.implied_parameters(fmt)


def save(filename: str, pi: ImageParameters, arr: np.ndarray) -> None:
    """Save a raw/decoded image; format chosen by extension
    (gpujpeg_image_save_to_file, gpujpeg_common.c:1276-1310)."""
    fmt = formats.get_file_format(filename)
    if fmt in (FileFormat.PNM, FileFormat.PGM, FileFormat.PPM):
        payload = pnm.save_pnm(pi, arr, pam=False)
    elif fmt == FileFormat.PAM:
        payload = pnm.save_pnm(pi, arr, pam=True)
    elif fmt == FileFormat.Y4M:
        payload = y4m.save_y4m(pi, arr)
    elif fmt in (FileFormat.BMP, FileFormat.PNG, FileFormat.TGA):
        _pil_save(filename, pi, arr)
        return
    elif fmt in (FileFormat.RAW, FileFormat.RGB, FileFormat.RGBA,
                 FileFormat.YUV, FileFormat.YUVA, FileFormat.UYVY,
                 FileFormat.I420, FileFormat.GRAY):
        payload = np.ascontiguousarray(arr).tobytes()
    else:
        raise ValueError(f"cannot save to extension of {filename}")
    with open(filename, "wb") as f:
        f.write(payload if isinstance(payload, bytes) else bytes(payload))


def calculate_size(pi: ImageParameters) -> int:
    return image_size_bytes(pi.width, pi.height, pi.pixel_format)
