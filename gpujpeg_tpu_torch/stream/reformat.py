"""Rewrite a JPEG to inject APP13 segment-info headers for fast decoding.

Equivalent of the reference's standalone gpujpeg_reformat tool
(test/decoder_gltex/gpujpeg_reformat.c, 663 LoC), copied from
gpujpeg_tpu.stream.reformat: parses the stream, splits
every scan at its restart markers, and re-emits the stream with the
GPUJPEG-style APP13 segment-offset index in front of each SOS so decoders
can split scans in O(segments) instead of O(bytes)
(gpujpeg_writer.c:520-600, gpujpeg_reader.c:1167-1232).
"""

from __future__ import annotations

import numpy as np

from ..types import CorruptStreamError
from . import markers, reader, writer as jwriter


def add_segment_info(data: bytes) -> bytes:
    """Return a new JPEG byte string with APP13 segment-info headers."""
    ps = reader.parse(data)
    if not ps.scans:
        raise CorruptStreamError("no scan found")
    if ps.restart_interval == 0:
        raise CorruptStreamError(
            "stream has no restart markers; segment info is pointless")

    arr = ps.data
    out = bytearray()
    # copy everything before the first SOS, dropping any existing APP13
    # segment-info markers
    pos = 2
    out += data[:2]
    n = len(data)
    first_scan_hdr = None
    while pos < n:
        if data[pos] != 0xFF:
            raise CorruptStreamError(f"expected marker at {pos}")
        marker = data[pos + 1]
        if marker == markers.SOS:
            first_scan_hdr = pos
            break
        if marker in (markers.SOI, markers.EOI) or markers.is_rst(marker):
            out += data[pos:pos + 2]
            pos += 2
            continue
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker != markers.SEGMENT_INFO:
            out += data[pos:pos + 2 + length]
        pos += 2 + length

    def copy_markers(lo: int, hi: int) -> bytes:
        """Copy marker segments in data[lo:hi] (e.g. a DHT or DRI between
        scans of a non-interleaved stream), stripping old APP13
        segment-info markers; tables before a later SOS are load-bearing."""
        res = bytearray()
        p = lo
        while p < hi - 1:
            if data[p] != 0xFF:
                break  # stray bytes; drop them
            m = data[p + 1]
            if m in (markers.SOI, markers.EOI) or markers.is_rst(m):
                res += data[p:p + 2]
                p += 2
                continue
            ln = int.from_bytes(data[p + 2:p + 4], "big")
            if m != markers.SEGMENT_INFO:
                res += data[p:p + 2 + ln]
            p += 2 + ln
        return bytes(res)

    # emit each scan with a fresh segment-info index
    prev_end = None
    for scan_index, scan in enumerate(ps.scans):
        # scan header: from the SOS marker to the start of entropy data
        sos_pos = scan.sos_pos
        if prev_end is not None and sos_pos > prev_end:
            out += copy_markers(prev_end, sos_pos)
        # rebuild offsets relative to entropy start; segment ranges exclude
        # RST markers, so re-derive the on-wire extents
        segs = scan.segments
        ent_start = scan.data_start
        offsets = [st - ent_start for st, en in segs]
        # the final entry = end of the scan's entropy data (incl. final seg)
        scan_end = segs[-1][1]
        offsets.append(scan_end - ent_start)
        out += jwriter.write_segment_info_headers(
            scan_index, np.asarray(offsets, dtype=np.int64))
        out += bytes(data[sos_pos:ent_start])
        out += bytes(data[ent_start:scan_end])
        prev_end = scan_end
    out += bytes((0xFF, markers.EOI))
    return bytes(out)


def main(argv=None) -> int:
    """CLI: python -m gpujpeg_tpu_torch.stream.reformat in.jpg out.jpg
    (the reference's standalone gpujpeg_reformat tool)."""
    import sys

    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 2:
        print("usage: reformat <in.jpg> <out.jpg>", file=sys.stderr)
        return 1
    with open(args[0], "rb") as f:
        data = f.read()
    out = add_segment_info(data)
    with open(args[1], "wb") as f:
        f.write(out)
    print(f"{args[0]} -> {args[1]}: +segment info "
          f"({len(data)} -> {len(out)} bytes)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
