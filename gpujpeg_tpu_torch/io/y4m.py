"""Y4M (YUV4MPEG2) reader/writer (numpy, 8-bit).

Behavioral superset of the reference's src/utils/y4m.c, copied from
gpujpeg_tpu.io.y4m: the reference reads exactly one frame (y4m.c
single-frame read/write); here the multi-frame generator load_y4m_frames
additionally feeds the CLI's video-sequence batch encode (-B).  C420/C422/C444/mono chroma types, XCOLORRANGE=FULL/LIMITED
(limited -> BT.601 limited, full -> JPEG full range).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..types import ColorSpace, ImageParameters, PixelFormat


_SUBS_TO_PF = {
    "mono": PixelFormat.U8,
    "420": PixelFormat.P420_U8_P0P1P2,
    "422": PixelFormat.P422_U8_P0P1P2,
    "444": PixelFormat.P444_U8_P0P1P2,
    "444alpha": PixelFormat.P4444_U8_P0123,
}

_PF_TO_SUBS = {
    PixelFormat.U8: "mono",
    PixelFormat.P420_U8_P0P1P2: "420jpeg",
    PixelFormat.P422_U8_P0P1P2: "422",
    PixelFormat.P444_U8_P0P1P2: "444",
}


def _parse_stream_header(data: bytes) -> Tuple[ImageParameters, int]:
    """Parse the YUV4MPEG2 stream header -> (params, offset past it)."""
    nl = data.index(b"\n")
    header = data[:nl].decode("ascii", errors="replace")
    fields = header.split()
    if not fields or fields[0] != "YUV4MPEG2":
        raise ValueError("not a Y4M stream")
    w = h = 0
    subs = "420"
    full_range = True
    for f in fields[1:]:
        if f.startswith("W"):
            w = int(f[1:])
        elif f.startswith("H"):
            h = int(f[1:])
        elif f.startswith("C"):
            c = f[1:]
            if c.startswith("mono"):
                subs = "mono"
            elif c == "444alpha":
                subs = "444alpha"
            else:
                # e.g. 420jpeg, 420mpeg2, 420p10, 422, 444
                import re

                m = re.match(r"^(\d{3})(?:p(\d+))?", c)
                if not m:
                    raise ValueError(f"Y4M chroma type C{c} unsupported")
                subs = m.group(1)
                if m.group(2) and int(m.group(2)) != 8:
                    raise ValueError(
                        f"Y4M bit depth {m.group(2)} unsupported")
        elif f == "XCOLORRANGE=LIMITED":
            full_range = False
        elif f == "XCOLORRANGE=FULL":
            full_range = True
    pf = _SUBS_TO_PF.get(subs)
    if pf is None:
        raise ValueError(f"Y4M subsampling C{subs} unsupported")
    cs = (ColorSpace.YCBCR_BT601_256LVLS if full_range
          else ColorSpace.YCBCR_BT601)
    return (ImageParameters(width=w, height=h, color_space=cs,
                            pixel_format=pf), nl + 1)


def _frames_from(data: bytes, pi: ImageParameters,
                 pos: int) -> Iterator[np.ndarray]:
    from ..types import image_size_bytes

    size = image_size_bytes(pi.width, pi.height, pi.pixel_format)
    while pos < len(data):
        if data[pos:pos + 5] != b"FRAME":
            raise ValueError("Y4M FRAME marker missing")
        pos = data.index(b"\n", pos) + 1
        if pos + size > len(data):
            raise ValueError("truncated Y4M frame")
        yield np.frombuffer(data, np.uint8, count=size, offset=pos).copy()
        pos += size


def load_y4m_frames(data: bytes):
    """(params, frame iterator) over EVERY frame of a Y4M stream.

    Each yielded frame is a flat planar uint8 array shaped exactly like
    the single-frame load_y4m result; the iterator feeds the CLI's
    video-batch encode (--batch, through Encoder.encode_pipelined)."""
    pi, pos = _parse_stream_header(data)
    return pi, _frames_from(data, pi, pos)


def load_y4m(data: bytes) -> Tuple[np.ndarray, ImageParameters]:
    """Parse the first frame of a Y4M stream -> (flat planar array,
    params) — the reference-equivalent single-frame read (y4m.c)."""
    pi, frames = load_y4m_frames(data)
    return next(frames), pi


def save_y4m(pi: ImageParameters, arr: np.ndarray) -> bytes:
    """Serialize one frame (reference writes F25:1 Ip A0:0,
    src/utils/y4m.c:195)."""
    return save_y4m_frames(pi, [arr])


def save_y4m_frames(pi: ImageParameters, arrs) -> bytes:
    """Serialize a frame sequence into one Y4M stream."""
    subs = _PF_TO_SUBS.get(pi.pixel_format)
    if subs is None:
        raise ValueError(f"cannot store {pi.pixel_format} in Y4M")
    crange = ("LIMITED" if pi.color_space == ColorSpace.YCBCR_BT601
              else "FULL")
    out = bytearray(
        (f"YUV4MPEG2 W{pi.width} H{pi.height} F25:1 Ip A0:0 "
         f"C{subs} XCOLORRANGE={crange}\n").encode())
    for arr in arrs:
        out += b"FRAME\n"
        out += np.ascontiguousarray(arr).tobytes()
    return bytes(out)
