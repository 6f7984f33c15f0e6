"""JPEG codestream header writer (CPU, bytes-level).

Python re-implementation of the reference writer (src/gpujpeg_writer.c):
JFIF / SPIFF / Adobe APP14 / Exif headers, DQT, SOF0, DHT, DRI, COM,
APP13 segment-info, SOS.  Byte-exact field layouts follow the cited lines.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..types import ColorSpace, HeaderType, Orientation, Parameters
from ..utils import tables
from ..utils.geometry import Geometry
from . import markers


class Writer:
    def __init__(self) -> None:
        self.buf = bytearray()

    def marker(self, m: int) -> None:
        self.buf += bytes((0xFF, m))

    def byte(self, b: int) -> None:
        self.buf.append(b & 0xFF)

    def u16(self, v: int) -> None:
        self.buf += struct.pack(">H", v & 0xFFFF)

    def u32(self, v: int) -> None:
        self.buf += struct.pack(">I", v & 0xFFFFFFFF)

    def raw(self, data: bytes) -> None:
        self.buf += data


def component_id(index: int, cs: ColorSpace) -> int:
    """Component IDs: 1..N for YCbCr, 'R','G','B','A' for RGB
    (gpujpeg_writer.c:303-311)."""
    if cs == ColorSpace.RGB:
        return b"RGBA"[index]
    return index + 1


def write_app0_jfif(w: Writer) -> None:
    """JFIF APP0 (gpujpeg_writer.c:120-156): v1.01, 300x300 dpi, no thumb."""
    w.marker(markers.APP0)
    w.u16(16)
    w.raw(b"JFIF\x00")
    w.byte(1)
    w.byte(1)
    w.byte(1)
    w.u16(300)
    w.u16(300)
    w.byte(0)
    w.byte(0)


def write_app14_adobe(w: Writer) -> None:
    """Adobe APP14 for RGB streams (gpujpeg_writer.c:255-273)."""
    w.marker(markers.APP14)
    w.u16(markers.APP14_ADOBE_MARKER_LEN)
    w.raw(b"Adobe")
    w.u16(100)  # version
    w.u16(0)    # flags0
    w.u16(0)    # flags1
    w.byte(0)   # color transform: 0 = RGB/CMYK


def spiff_color_space(cs: ColorSpace, comp_count: int) -> int:
    """SPIFF color-space code (gpujpeg_writer.c:185-205)."""
    if comp_count == 1:
        return 8
    return {
        ColorSpace.YCBCR_BT709: 1,
        ColorSpace.YCBCR_BT601_256LVLS: 3,
        ColorSpace.YCBCR_BT601: 4,
        ColorSpace.RGB: 10,
    }.get(cs, 2)


def write_spiff(w: Writer, param: Parameters, width: int, height: int,
                orientation: Optional[Orientation]) -> None:
    """SPIFF header + directory + nested SOI (gpujpeg_writer.c:171-245)."""
    w.marker(markers.APP8)
    w.u16(markers.SPIFF_MARKER_LEN)
    w.raw(b"SPIFF\x00")
    cs_code = spiff_color_space(param.color_space_internal, param.comp_count)
    profile = 1 if cs_code in (3, 8) else 0
    w.u16(markers.SPIFF_VERSION)
    w.byte(profile)
    w.byte(param.comp_count)
    w.u32(height)
    w.u32(width)
    w.byte(cs_code)
    w.byte(8)  # bits per sample
    w.byte(markers.SPIFF_COMPRESSION_JPEG)
    w.byte(0)  # resolution units
    w.u32(1)
    w.u32(1)
    if orientation is not None:
        w.marker(markers.APP8)
        w.u16(10)
        w.u32(markers.SPIFF_ENTRY_TAG_ORIENTATION)
        w.byte(orientation.rotation)
        w.byte(1 if orientation.flip else 0)
        w.u16(0)
    # EOD entry (must be last; length covers the following SOI)
    w.marker(markers.APP8)
    w.u16(markers.SPIFF_ENTRY_TAG_EOD_LENGTH)
    w.u32(markers.SPIFF_ENTRY_TAG_EOD)
    w.marker(markers.SOI)


def write_dqt(w: Writer, table_index: int, qtab_zz: np.ndarray) -> None:
    """DQT, 8-bit precision, zig-zag order (gpujpeg_writer.c:282-301)."""
    w.marker(markers.DQT)
    w.u16(67)
    w.byte(table_index)  # (0 << 4) | index
    w.raw(bytes(int(x) for x in qtab_zz))


def write_sof0(w: Writer, geo: Geometry) -> None:
    """Baseline SOF0 (gpujpeg_writer.c:319-356)."""
    param = geo.param
    w.marker(markers.SOF0)
    w.u16(8 + 3 * geo.comp_count)
    w.byte(8)
    w.u16(geo.param_image.height)
    w.u16(geo.param_image.width)
    w.byte(geo.comp_count)
    for c in geo.components:
        w.byte(component_id(c.index, param.color_space_internal))
        w.byte((c.samp_h << 4) | c.samp_v)
        w.byte(c.table_index)


def write_dht(w: Writer, table_class: int, table_index: int,
              bits: np.ndarray, values: np.ndarray) -> None:
    """DHT (gpujpeg_writer.c:366-406)."""
    w.marker(markers.DHT)
    nval = int(np.sum(bits[1:17]))
    w.u16(2 + 1 + 16 + nval)
    w.byte((table_class << 4) | table_index)
    w.raw(bytes(int(x) for x in bits[1:17]))
    w.raw(bytes(int(x) for x in values[:nval]))


def write_dri(w: Writer, restart_interval: int) -> None:
    w.marker(markers.DRI)
    w.u16(4)
    w.u16(restart_interval)


def write_com(w: Writer, text: str) -> None:
    """COM with terminating NUL (gpujpeg_writer.c:427-437)."""
    data = text.encode() + b"\x00"
    w.marker(markers.COM)
    w.u16(2 + len(data))
    w.raw(data)


def resolve_header_type(param: Parameters,
                        orientation: Optional[Orientation]) -> HeaderType:
    """Auto header selection (gpujpeg_writer.c:457-489)."""
    ht = param.header_type
    if ht != HeaderType.DEFAULT:
        return ht
    if param.comp_count == 4 or orientation is not None:
        return HeaderType.SPIFF
    if param.color_space_internal in (ColorSpace.YCBCR_BT601,
                                      ColorSpace.YCBCR_BT709):
        return HeaderType.SPIFF
    if param.color_space_internal == ColorSpace.RGB:
        return HeaderType.ADOBE
    return HeaderType.JFIF


def write_header(geo: Geometry,
                 orientation: Optional[Orientation] = None,
                 exif_tags: Optional[list] = None,
                 header_type: Optional[HeaderType] = None) -> bytes:
    """Everything from SOI up to (not including) the first scan header
    (gpujpeg_writer_write_header, gpujpeg_writer.c:450-518)."""
    param = geo.param
    w = Writer()
    w.marker(markers.SOI)

    ht = header_type if header_type is not None else \
        resolve_header_type(param, orientation)
    if ht & HeaderType.SPIFF:
        write_spiff(w, param, geo.param_image.width, geo.param_image.height,
                    orientation)
    elif ht & HeaderType.ADOBE:
        write_app14_adobe(w)
    elif ht & HeaderType.EXIF:
        from . import exif
        exif.write_exif(w, geo, orientation, exif_tags or [])
    else:
        write_app0_jfif(w)

    # DQT per used component type (luma idx 0 / chroma idx 1)
    emitted = set()
    for c in geo.components:
        if c.table_index not in emitted:
            write_dqt(w, c.table_index,
                      tables.quant_table_zz(c.is_luma, param.quality))
            emitted.add(c.table_index)

    write_sof0(w, geo)

    emitted = set()
    for c in geo.components:
        if c.table_index not in emitted:
            bits_dc, vals_dc = tables.huffman_spec_for("dc", c.is_luma)
            bits_ac, vals_ac = tables.ac_spec(
                c.is_luma, param.quality,
                getattr(param, "huffman_tables", "tuned"))
            write_dht(w, 0, c.table_index, bits_dc, vals_dc)
            write_dht(w, 1, c.table_index, bits_ac, vals_ac)
            emitted.add(c.table_index)

    write_dri(w, param.restart_interval)
    write_com(w, f"CREATOR: GPUJPEG, quality = {min(max(param.quality, 1), 100)}")
    if param.color_space_internal == ColorSpace.YCBCR_BT601:
        write_com(w, "CS=ITU601")
    return bytes(w.buf)


def write_scan_header(geo: Geometry, scan_index: int) -> bytes:
    """SOS for one scan (gpujpeg_writer.c:548-658), without segment-info
    headers (those are back-patched during host assembly, which knows offsets)."""
    param = geo.param
    w = Writer()
    w.marker(markers.SOS)
    if param.interleaved:
        w.u16(6 + 2 * geo.comp_count)
        w.byte(geo.comp_count)
        for c in geo.components:
            w.byte(component_id(c.index, param.color_space_internal))
            w.byte(0x00 if c.is_luma else 0x11)
    else:
        c = geo.components[scan_index]
        w.u16(8)
        w.byte(1)
        w.byte(component_id(c.index, param.color_space_internal))
        w.byte(0x00 if c.is_luma else 0x11)
    w.byte(0)     # Ss
    w.byte(0x3F)  # Se
    w.byte(0)     # Ah/Al
    return bytes(w.buf)


def write_segment_info_headers(scan_index: int, offsets: np.ndarray) -> bytes:
    """APP13 segment-info headers for a scan (gpujpeg_writer.c:520-600).

    offsets: (segment_count + 1,) int array of byte offsets of each segment
    start (and the scan end) relative to the first byte after the LAST
    segment-info header (== start of entropy data).
    """
    payload = np.asarray(offsets, dtype=">u4").tobytes()
    out = bytearray()
    off = 0
    while off < len(payload):
        chunk = payload[off:off + markers.MAX_HEADER_SIZE]
        out += bytes((0xFF, markers.SEGMENT_INFO))
        out += struct.pack(">H", 3 + len(chunk))
        out.append(scan_index)
        out += chunk
        off += len(chunk)
    return bytes(out)
