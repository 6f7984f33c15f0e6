"""Exif APP1 write/parse (subset; cf. src/gpujpeg_exif.c).

Supports the orientation tag plus user tags of the form
"<key>:TYPE=<value>" with SHORT/LONG/ASCII/RATIONAL types
(gpujpeg_exif.c:392,494).  Parsing extracts orientation into metadata
(gpujpeg_exif.c:709).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from ..types import Orientation

TAG_ORIENTATION = 0x0112
TAG_EXIF_IFD = 0x8769

TYPE_BYTE, TYPE_ASCII, TYPE_SHORT, TYPE_LONG, TYPE_RATIONAL = 1, 2, 3, 4, 5
_TYPE_SIZE = {TYPE_BYTE: 1, TYPE_ASCII: 1, TYPE_SHORT: 2, TYPE_LONG: 4,
              TYPE_RATIONAL: 8}
_TYPE_NAMES = {"BYTE": TYPE_BYTE, "ASCII": TYPE_ASCII, "SHORT": TYPE_SHORT,
               "LONG": TYPE_LONG, "RATIONAL": TYPE_RATIONAL}

#: SPIFF (rotation, flip) -> Exif orientation value 1..8
_SPIFF_TO_EXIF = {
    (0, False): 1, (0, True): 2, (2, False): 3, (2, True): 4,
    (1, True): 5, (1, False): 6, (3, True): 7, (3, False): 8,
}
_EXIF_TO_SPIFF = {v: k for k, v in _SPIFF_TO_EXIF.items()}


def _ifd_entry(tag: int, typ: int, count: int, value: int) -> bytes:
    return struct.pack(">HHI", tag, typ, count) + struct.pack(">I", value)


def build_exif_payload(orientation: Optional[Orientation],
                       user_tags: Optional[List[str]] = None) -> bytes:
    """TIFF header + IFD0 (+ external data area)."""
    entries: List[Tuple[int, int, int, bytes]] = []  # tag, type, count, data
    if orientation is not None:
        val = _SPIFF_TO_EXIF.get(
            (orientation.rotation, bool(orientation.flip)), 1)
        entries.append((TAG_ORIENTATION, TYPE_SHORT, 1,
                        struct.pack(">H", val) + b"\x00\x00"))
    for spec in user_tags or []:
        # "<key>:TYPE=<value>"  key may be numeric tag id
        try:
            key, rest = spec.split(":", 1)
            typ_name, value = rest.split("=", 1)
            tag = int(key, 0)
            typ = _TYPE_NAMES[typ_name.upper()]
        except (ValueError, KeyError):
            continue
        if typ == TYPE_ASCII:
            data = value.encode() + b"\x00"
            entries.append((tag, typ, len(data), data))
        elif typ in (TYPE_SHORT,):
            entries.append((tag, typ, 1,
                            struct.pack(">H", int(value, 0)) + b"\x00\x00"))
        elif typ in (TYPE_LONG, TYPE_BYTE):
            entries.append((tag, typ, 1, struct.pack(">I", int(value, 0))))
        elif typ == TYPE_RATIONAL:
            num, den = (value.split("/") + ["1"])[:2]
            entries.append((tag, typ, 1,
                            struct.pack(">II", int(num), int(den))))
    entries.sort(key=lambda e: e[0])

    tiff = b"MM\x00\x2a" + struct.pack(">I", 8)
    ifd_off = 8
    n = len(entries)
    data_off = ifd_off + 2 + n * 12 + 4
    body = struct.pack(">H", n)
    extra = b""
    for tag, typ, count, data in entries:
        size = _TYPE_SIZE[typ] * count
        if size <= 4:
            body += struct.pack(">HHI", tag, typ, count) + data[:4].ljust(4, b"\x00")
        else:
            body += struct.pack(">HHI", tag, typ, count) + struct.pack(
                ">I", data_off + len(extra))
            extra += data
    body += struct.pack(">I", 0)  # next IFD
    return tiff + body + extra


def write_exif(w, geo, orientation: Optional[Orientation],
               user_tags: Optional[List[str]] = None) -> None:
    from . import markers
    payload = b"Exif\x00\x00" + build_exif_payload(orientation, user_tags)
    w.marker(markers.APP1)
    w.u16(2 + len(payload))
    w.raw(payload)


def parse_exif(body: bytes) -> Dict:
    """Parse an APP1 Exif body; returns {'orientation': Orientation|None,
    'tags': {tag: value}}."""
    out: Dict = {"orientation": None, "tags": {}}
    if body[:6] != b"Exif\x00\x00":
        return out
    t = body[6:]
    if len(t) < 8:
        return out
    if t[:2] == b"MM":
        endian = ">"
    elif t[:2] == b"II":
        endian = "<"
    else:
        return out
    (ifd_off,) = struct.unpack_from(endian + "I", t, 4)
    pos = ifd_off
    if pos + 2 > len(t):
        return out
    (n,) = struct.unpack_from(endian + "H", t, pos)
    pos += 2
    for _ in range(n):
        if pos + 12 > len(t):
            break
        tag, typ, count = struct.unpack_from(endian + "HHI", t, pos)
        raw = t[pos + 8: pos + 12]
        if tag == TAG_ORIENTATION and typ == TYPE_SHORT:
            (val,) = struct.unpack_from(endian + "H", raw, 0)
            rot_flip = _EXIF_TO_SPIFF.get(val)
            if rot_flip:
                out["orientation"] = Orientation(rotation=rot_flip[0],
                                                 flip=rot_flip[1])
        out["tags"][tag] = (typ, count, raw)
        pos += 12
    return out
