"""JPEG codestream parser (CPU, numpy-vectorized scan splitting).

A copy of gpujpeg_tpu.stream.reader for the port (numpy only; its native
helpers come from the port's own gpujpeg_tpu_torch.native).

Python re-implementation of the reference reader (src/gpujpeg_reader.c):
marker loop, SOF0/DHT/DQT/DRI/SOS parsing, colorspace deduction from
component IDs / Adobe APP14 / "CS=ITU601" COM quirk, APP13 segment-info fast
path, RST-sequence verification with resync recovery, and 0xFF-stuffing
removal.  The scan splitter is a vectorized memchr equivalent
(gpujpeg_reader.c:1038-1155 -> numpy flatnonzero over 0xFF positions).
"""

from __future__ import annotations

import dataclasses
import logging
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..types import (ColorSpace, CorruptStreamError, HeaderType, ImageInfo,
                     Orientation, Parameters, RestartChangeError,
                     SamplingFactor, UnsupportedStreamError)
from . import markers

log = logging.getLogger("gpujpeg_tpu_torch")


class ScanInfo:
    """Per-scan table assignment + segment layout.

    Segment layout comes in one of two forms:
      * ``offsets`` — (n+1,) int64 ABSOLUTE stream positions: segment k
        spans [offsets[k], offsets[k+1] - 2) (2 trailing RST marker
        bytes), the last spans [offsets[n-1], offsets[n]).  Set by the
        O(1) APP13 segment-info path; the compact form the decoder's
        host prep consumes directly (no (n, 2) materialization — the
        build + concat cost ~10 ms per 8K Q100 frame at 1.55 M
        segments).
      * ``segments`` — (n, 2) int64 [start, end) entropy byte ranges
        (RST markers excluded).  Set by the marker-scan splitter;
        lazily derived from ``offsets`` on first access otherwise.
    """

    def __init__(self, comp_indices: List[int], dc_table: List[int],
                 ac_table: List[int]):
        self.comp_indices = comp_indices
        self.dc_table = dc_table        # per scan component
        self.ac_table = ac_table
        self._segments: Optional[np.ndarray] = None
        self.offsets: Optional[np.ndarray] = None
        self.sos_pos = -1        # offset of the 0xFF of this scan's SOS
        self.data_start = -1     # offset of the first entropy byte

    @property
    def segments(self) -> np.ndarray:
        if self._segments is None:
            if self.offsets is not None and len(self.offsets) >= 2:
                o = self.offsets
                seg = np.empty((len(o) - 1, 2), np.int64)
                seg[:, 0] = o[:-1]
                seg[:, 1] = o[1:] - 2
                seg[-1, 1] = o[-1]
                self._segments = seg
            else:
                self._segments = np.zeros((0, 2), np.int64)
        return self._segments

    @segments.setter
    def segments(self, v: np.ndarray) -> None:
        self._segments = v

    @property
    def segment_count(self) -> int:
        if self._segments is not None:
            return len(self._segments)
        if self.offsets is not None:
            return max(len(self.offsets) - 1, 0)
        return 0

    def segment_bounds(self):
        """(starts, ends) int64 1-D arrays — the copy-light form (views
        of ``offsets`` plus one subtract when available)."""
        if self._segments is None and self.offsets is not None \
                and len(self.offsets) >= 2:
            o = self.offsets
            ends = o[1:] - 2
            ends[-1] += 2
            return o[:-1], ends
        segs = self.segments
        return np.ascontiguousarray(segs[:, 0]), \
            np.ascontiguousarray(segs[:, 1])


@dataclasses.dataclass
class ParsedStream:
    width: int = 0
    height: int = 0
    comp_count: int = 0
    comp_ids: List[int] = dataclasses.field(default_factory=list)
    sampling: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    quant_map: List[int] = dataclasses.field(default_factory=list)
    quant_tables: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    huff_dc: Dict[int, Tuple[np.ndarray, np.ndarray]] = dataclasses.field(default_factory=dict)
    huff_ac: Dict[int, Tuple[np.ndarray, np.ndarray]] = dataclasses.field(default_factory=dict)
    restart_interval: int = 0
    interleaved: bool = False
    color_space: ColorSpace = ColorSpace.YCBCR_BT601_256LVLS
    header_type: HeaderType = HeaderType.DEFAULT
    comment: Optional[str] = None
    orientation: Optional[Orientation] = None
    scans: List[ScanInfo] = dataclasses.field(default_factory=list)
    #: per-scan list of raw APP13 offset chunks (big-endian u32 arrays)
    segment_info: Dict[int, list] = dataclasses.field(default_factory=dict)
    adobe_transform: Optional[int] = None
    data: Optional[np.ndarray] = None  # uint8 view of the input


def _u16(data: bytes, off: int) -> int:
    try:
        return struct.unpack_from(">H", data, off)[0]
    except struct.error as e:
        raise CorruptStreamError(
            f"truncated stream: need 2 bytes at {off}, have "
            f"{len(data) - off}") from e


def _deduce_color_space(ps: ParsedStream) -> None:
    """Colorspace from component IDs and auxiliary markers
    (gpujpeg_reader.c:746-886, Adobe :558-639, COM quirk :641-672)."""
    ids = ps.comp_ids
    if ps.comp_count >= 3 and ids[:3] == [ord("R"), ord("G"), ord("B")]:
        ps.color_space = ColorSpace.RGB
        return
    if ps.adobe_transform == 0 and ps.comp_count == 3:
        ps.color_space = ColorSpace.RGB
        return
    if ps.comment == "CS=ITU601":
        ps.color_space = ColorSpace.YCBCR_BT601
        return
    # SPIFF header (if present) already set color_space; else JFIF default
    # full-range BT.601 for IDs 1..3


def _read_segment_body(data: np.ndarray, start: int,
                       n_expected: Optional[int]):
    """Split scan entropy data at RST markers from `start` (vectorized
    memchr-style splitter, cf. gpujpeg_reader.c:1038-1155).

    Returns (segments, end_pos) where segments is an (n, 2) int64 array of
    [st, en) ranges excluding RST markers.  The RST0-7 modulo sequence is
    verified; on mismatch a warning is logged (the reference additionally
    resyncs mid-stream, reader.c:1071-1104 — our recovery keeps all
    segments and realigns).  Empty segments between consecutive RSTs are
    dropped (FFmpeg quirk, reader.c:1131-1134).
    """
    n = len(data)
    from .. import native

    nat = native.scan_split(data, start, max(4, n // 2))
    if nat is not None:
        segments, end_pos, bad = nat
        if not bad:
            return segments, end_pos
        # fall through to the numpy path, which resyncs

    ff = np.flatnonzero(data[start:n - 1] == 0xFF) + start
    nxt = data[ff + 1]
    significant = (nxt != 0x00) & (nxt != 0xFF)
    sig_pos = ff[significant]
    sig_nxt = nxt[significant]
    is_rst = (sig_nxt >= markers.RST0) & (sig_nxt <= markers.RST0 + 7)
    non_rst = np.flatnonzero(~is_rst)
    if len(non_rst):
        cut = non_rst[0]
        end_pos = int(sig_pos[cut])
        rst_pos = sig_pos[:cut]
        rst_vals = sig_nxt[:cut]
    else:
        end_pos = n
        rst_pos = sig_pos
        rst_vals = sig_nxt
    expected = (np.arange(len(rst_vals)) % 8) + markers.RST0
    bad = rst_vals != expected
    if bad.any():
        # skip-to-expected-marker resync (gpujpeg_reader.c:1071-1104): a
        # marker that is not the expected RST(n mod 8) is treated as data
        # — the current segment absorbs it and everything up to the
        # expected marker.  Sequential walk; only runs on corrupt streams.
        keep_idx = []
        exp = 0
        skipped_from = None
        for i, v in enumerate(rst_vals.tolist()):
            if v - markers.RST0 == exp % 8:
                if skipped_from is not None:
                    log.warning(
                        "[Recovery] Skipping %d bytes of data until marker "
                        "0x%X was found",
                        int(rst_pos[i] - rst_pos[skipped_from]),
                        markers.RST0 + exp % 8)
                    skipped_from = None
                keep_idx.append(i)
                exp += 1
            else:
                log.warning("[Recovery] Expected marker 0x%X but 0x%X "
                            "was presented", markers.RST0 + exp % 8, v)
                if skipped_from is None:
                    skipped_from = i
        rst_pos = rst_pos[keep_idx]
    starts = np.concatenate([[start], rst_pos + 2])
    ends = np.concatenate([rst_pos, [end_pos]])
    keep = ends > starts
    segments = np.stack([starts[keep], ends[keep]], axis=1) \
        .astype(np.int64)
    return segments, end_pos


#: sentinel returned by _decode_seg_offsets for non-monotonic indices
_BAD_OFFSETS = np.zeros(0, np.int64)


def _decode_seg_offsets(arr: np.ndarray, chunks, base: int):
    """APP13 chunk list ((offset, byte_len) pairs) -> ABSOLUTE (n+1,)
    int64 positions, or the _BAD_OFFSETS sentinel when the index is
    non-monotonic (caller falls back to marker parsing).  Native
    single-pass decoder with a numpy fallback."""
    from .. import native

    nat = native.parse_offsets(arr, chunks, base)
    if nat is not None:
        off, bad = nat
        return _BAD_OFFSETS if bad else off
    parts = []
    for off_b, ln in chunks:
        if ln % 4:
            return _BAD_OFFSETS
        parts.append(np.frombuffer(arr, ">u4", count=ln // 4,
                                   offset=off_b))
    out = np.concatenate(parts).astype(np.int64)
    if len(out) and bool((out[1:] < out[:-1]).any()):
        return _BAD_OFFSETS
    out += base
    return out


def parse(data: bytes) -> ParsedStream:
    """Parse a full JPEG codestream (gpujpeg_reader_read_image,
    gpujpeg_reader.c:1619-1736)."""
    ps = ParsedStream()
    arr = np.frombuffer(data, dtype=np.uint8)
    ps.data = arr
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != markers.SOI:
        raise CorruptStreamError("missing SOI")
    pos = 2
    while pos < n:
        if data[pos] != 0xFF:
            raise CorruptStreamError(f"expected marker at {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == markers.SOI:
            continue  # nested SOI after SPIFF directory
        if marker == markers.EOI:
            break
        if markers.is_rst(marker):
            continue
        length = _u16(data, pos)
        body = data[pos + 2: pos + length]

        if marker == markers.APP0:
            if body[:5] == b"JFIF\x00":
                # version check mirrors gpujpeg_reader_read_jfif
                # (gpujpeg_reader.c:176-207): major must be 1, minor 0-2
                ps.header_type = HeaderType.JFIF
                if len(body) >= 7:
                    vmaj, vmin = body[5], body[6]
                    if vmaj != 1 or vmin > 2:
                        log.warning(
                            "JFIF marker version should be 1.00 to 1.02 "
                            "but %d.%02d was presented", vmaj, vmin)
            elif body[:5] == b"JFXX\x00":
                # JFXX extension (thumbnail) APP0: recognized and skipped
                # (gpujpeg_reader_skip_jfxx, gpujpeg_reader.c:211-218);
                # it follows a JFIF APP0, so header_type is already set
                log.debug("APP0 JFXX extension (%d bytes) skipped",
                          length - 2)
            elif len(body) >= 5:
                log.warning("APP0 marker identifier is not supported %r!",
                            bytes(body[:4]))
        elif marker == markers.APP8:
            if body[:6] == b"SPIFF\x00":
                ps.header_type = HeaderType.SPIFF
                cs_code = body[12]
                ps.color_space = {
                    1: ColorSpace.YCBCR_BT709,
                    3: ColorSpace.YCBCR_BT601_256LVLS,
                    4: ColorSpace.YCBCR_BT601,
                    8: ColorSpace.YCBCR_BT601_256LVLS,  # grayscale
                    10: ColorSpace.RGB,
                }.get(cs_code, ColorSpace.YCBCR_BT601_256LVLS)
            elif len(body) >= 4:
                tag = struct.unpack_from(">I", body, 0)[0]
                if tag == markers.SPIFF_ENTRY_TAG_ORIENTATION and len(body) >= 6:
                    ps.orientation = Orientation(rotation=body[4] & 3,
                                                 flip=bool(body[5] & 1))
                # EOD entry includes a following SOI inside its length
                if tag == markers.SPIFF_ENTRY_TAG_EOD:
                    pos += length
                    continue
        elif marker == markers.APP1:
            from . import exif
            try:
                meta = exif.parse_exif(bytes(body))
                if meta.get("orientation") is not None:
                    ps.orientation = meta["orientation"]
            except Exception:
                log.debug("unparseable Exif APP1")
            ps.header_type = HeaderType.EXIF
        elif marker == markers.APP13:
            # GPUJPEG segment-info (gpujpeg_reader.c:347-390); chunks are
            # recorded as (offset, byte_len) into the original buffer —
            # no payload copies; the native decoder (gj_parse_offsets)
            # converts all chunks to absolute int64 positions in one
            # parallel pass at SOS (the numpy concat + byteswapping
            # astype chain cost ~5-9 ms per 8K Q100 frame)
            if length >= 3:
                scan_index = body[0]
                ps.segment_info.setdefault(scan_index, []).append(
                    (pos + 3, length - 3))
        elif marker == markers.APP14:
            if body[:5] == b"Adobe" and len(body) >= 12:
                ps.adobe_transform = body[11]
                ps.header_type = HeaderType.ADOBE
        elif marker == markers.COM:
            text = bytes(body).split(b"\x00")[0].decode("latin1",
                                                        errors="replace")
            if ps.comment is None or text.startswith("CS="):
                if text == "CS=ITU601":
                    ps.color_space = ColorSpace.YCBCR_BT601
                if ps.comment is None:
                    ps.comment = text
        elif marker == markers.DQT:
            off = 0
            while off < len(body):
                pq_tq = body[off]
                if pq_tq >> 4 != 0:
                    raise UnsupportedStreamError("16-bit quant tables")
                idx = pq_tq & 0x0F
                ps.quant_tables[idx] = np.frombuffer(
                    bytes(body[off + 1:off + 65]), dtype=np.uint8
                ).astype(np.int32)
                if log.isEnabledFor(logging.DEBUG):
                    # DEBUG2 table dump (gpujpeg_reader.c:725-728)
                    rows = ps.quant_tables[idx].reshape(8, 8)
                    log.debug("DQT table %d (zig-zag):\n%s", idx,
                              "\n".join(" ".join(f"{v:3d}" for v in r)
                                         for r in rows))
                off += 65
        elif marker in (markers.SOF0, markers.SOF1):
            precision = body[0]
            if precision != 8:
                raise UnsupportedStreamError(f"{precision}-bit precision")
            ps.height = _u16(body, 1)
            ps.width = _u16(body, 3)
            ps.comp_count = body[5]
            for i in range(ps.comp_count):
                cid = body[6 + 3 * i]
                samp = body[7 + 3 * i]
                tq = body[8 + 3 * i]
                ps.comp_ids.append(cid)
                ps.sampling.append((samp >> 4, samp & 0x0F))
                ps.quant_map.append(tq)
                log.debug("SOF0 comp %d: id=%d sampling=%dx%d qtable=%d",
                          i, cid, samp >> 4, samp & 0x0F, tq)
            log.debug("SOF0: %dx%d, %d components, 8-bit",
                      ps.width, ps.height, ps.comp_count)
        elif marker in (markers.SOF2, markers.SOF3, markers.SOF5,
                        markers.SOF6, markers.SOF7, markers.SOF9,
                        markers.SOF10, markers.SOF11, markers.SOF13,
                        markers.SOF14, markers.SOF15, markers.DAC):
            raise UnsupportedStreamError(
                f"unsupported SOF/DAC marker 0xFF{marker:02X} "
                "(progressive/lossless/arithmetic)")
        elif marker == markers.DHT:
            off = 0
            while off < len(body):
                tc_th = body[off]
                tc, th = tc_th >> 4, tc_th & 0x0F
                bits = np.zeros(17, np.int32)
                bits[1:] = np.frombuffer(bytes(body[off + 1:off + 17]),
                                         np.uint8)
                nval = int(bits.sum())
                vals = np.frombuffer(
                    bytes(body[off + 17:off + 17 + nval]), np.uint8
                ).astype(np.int32)
                (ps.huff_dc if tc == 0 else ps.huff_ac)[th] = (bits, vals)
                if log.isEnabledFor(logging.DEBUG):
                    # DEBUG2 Huffman dump (gpujpeg_reader.c:888-911)
                    log.debug(
                        "DHT %s table %d: bits=%s\nvalues=%s",
                        "DC" if tc == 0 else "AC", th,
                        " ".join(str(int(b)) for b in bits[1:]),
                        " ".join(f"{int(v):02x}" for v in vals))
                off += 17 + nval
        elif marker == markers.DRI:
            ri = _u16(body, 0)
            if ps.scans and ri != ps.restart_interval:
                # mid-stream DRI change (GPUJPEG_ERR_RESTART_CHANGE,
                # gpujpeg_reader.c:996-1026)
                raise RestartChangeError(
                    f"restart interval changed mid-stream "
                    f"({ps.restart_interval} -> {ri})")
            ps.restart_interval = ri
        elif marker == markers.SOS:
            ns = body[0]
            scan = ScanInfo(comp_indices=[], dc_table=[], ac_table=[])
            for i in range(ns):
                cid = body[1 + 2 * i]
                tabs = body[2 + 2 * i]
                try:
                    ci = ps.comp_ids.index(cid)
                except ValueError:
                    raise CorruptStreamError(f"SOS component id {cid} "
                                             "not in SOF")
                scan.comp_indices.append(ci)
                scan.dc_table.append(tabs >> 4)
                scan.ac_table.append(tabs & 0x0F)
            scan_data_start = pos + length
            scan.sos_pos = pos - 2
            scan.data_start = scan_data_start
            si = ps.segment_info.get(len(ps.scans))
            off = _decode_seg_offsets(arr, si, scan_data_start) \
                if si else None
            if off is not None and (
                    len(off) < 2
                    or off is _BAD_OFFSETS
                    or int(off[-1]) > len(arr)):
                # corrupt segment-info index (non-monotonic or out of
                # range): ignore it and fall back to marker parsing
                log.warning("scan %d: invalid APP13 segment-info offsets; "
                            "falling back to scan parsing", len(ps.scans))
                off = None
            if off is not None:
                # O(1) segment split from APP13 offsets
                # (reader.c:1167-1232); stored in the compact (n+1,)
                # absolute-offset form — ScanInfo derives [start, end)
                # ranges lazily, and the decoder's host prep consumes
                # the offsets directly
                scan.offsets = off
                end_pos = int(off[-1])
            else:
                scan.segments, end_pos = _read_segment_body(
                    arr, scan_data_start, None)
            ps.scans.append(scan)
            ps.interleaved = ns > 1
            pos = end_pos
            continue
        pos += length
    _deduce_color_space(ps)
    return ps


def unstuff(arr: np.ndarray) -> np.ndarray:
    """Remove 0x00 bytes following 0xFF (vectorized)."""
    if len(arr) == 0:
        return arr
    is_stuff = np.zeros(len(arr), dtype=bool)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    is_stuff[ff + 1] = arr[ff + 1] == 0
    # consecutive FF00 FF00: the 0 after a stuffed 0? A stuffed 0x00 can't be
    # 0xFF so no chaining issue.
    return arr[~is_stuff]


def parsed_to_parameters(ps: ParsedStream) -> Parameters:
    """Build encode-style Parameters describing the parsed stream."""
    sf = tuple(SamplingFactor(h, v) for (h, v) in ps.sampling)
    sf = sf + (SamplingFactor(1, 1),) * (4 - len(sf))
    return Parameters(
        quality=0,
        restart_interval=ps.restart_interval,
        interleaved=ps.interleaved,
        comp_count=ps.comp_count,
        sampling_factor=sf,
        color_space_internal=ps.color_space,
    )


def get_image_info(data: bytes) -> ImageInfo:
    """Lightweight probe (gpujpeg_reader_get_image_info,
    gpujpeg_reader.c:1739-1870)."""
    ps = parse(data)
    from ..types import PixelFormat
    if ps.comp_count == 1:
        pf = PixelFormat.U8
    elif ps.comp_count == 4:
        pf = PixelFormat.P4444_U8_P0123
    else:
        samp = ps.sampling
        if all(s == (1, 1) for s in samp):
            pf = PixelFormat.P444_U8_P012
        elif samp[0] == (2, 2):
            pf = PixelFormat.P420_U8_P0P1P2
        elif samp[0] == (2, 1):
            pf = PixelFormat.P422_U8_P0P1P2
        else:
            pf = PixelFormat.NONE
    quality = None
    if ps.comment and "quality = " in ps.comment:
        try:
            quality = int(ps.comment.split("quality = ")[1])
        except ValueError:
            pass
    return ImageInfo(
        width=ps.width, height=ps.height, comp_count=ps.comp_count,
        color_space=ps.color_space, pixel_format=pf,
        interleaved=ps.interleaved, restart_interval=ps.restart_interval,
        segment_count=sum(s.segment_count for s in ps.scans),
        header_type=ps.header_type, quality=quality, comment=ps.comment,
        orientation=ps.orientation, sampling=tuple(ps.sampling),
    )
