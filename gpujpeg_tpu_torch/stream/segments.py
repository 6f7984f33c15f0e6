"""Vectorized host prep of entropy segments for device decode.

A copy of gpujpeg_tpu.stream.segments for the port.

Unstuffs (0xFF 0x00 -> 0xFF) and packs all segments of a stream into one
padded (nseg, words) uint32 matrix in a handful of numpy passes — the
decode-side counterpart of the encoder's host assembly.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def pack_segments_matrix(data: np.ndarray,
                         ranges: List[Tuple[int, int]],
                         max_words: int, out=None):
    """Build the decoder input matrix.

    data:   (N,) uint8 full codestream
    ranges: (nseg, 2) int64 [start, end) byte ranges of entropy segments
            (stuffed); a list of pairs or a (starts, ends) tuple of
            int64 1-D arrays (the copy-free fast-path form) is also
            accepted
    max_words: row width in 32-bit words (unstuffed payload must fit)
    out:    optional (nseg, (max_words + 1) * 4) uint8 buffer the matrix
            is written into, by the native unstuffer and by the numpy
            version alike (native.unstuff_rows)

    Returns (words, nbits): (nseg, max_words+1) uint32 rows (+1 guard
    word) and per-segment unstuffed bit counts.  Words are HOST-ORDER
    views of the stream bytes (byte k of the stream is byte k of the
    word); the decode kernels byteswap each word as they load it.
    """
    from .. import native

    nat = native.unstuff_rows(data, ranges, max_words + 1, out=out)
    if nat is not None:
        return nat

    if isinstance(ranges, tuple):
        starts, ends = (np.asarray(a, np.int64) for a in ranges)
        nseg = len(starts)
    else:
        r = np.asarray(ranges, np.int64).reshape(-1, 2)
        nseg = len(r)
        starts = r[:, 0]
        ends = r[:, 1]
    lens = ends - starts

    # stuffed-zero mask over the whole buffer (a stuffed 0x00 follows 0xFF;
    # segment ranges never start right after an in-segment 0xFF)
    stuffed = np.zeros(len(data), dtype=bool)
    ff = np.flatnonzero(data[:-1] == 0xFF)
    stuffed[ff + 1] = data[ff + 1] == 0
    # exclusive cumsum: cumstuff[i] = number of stuffed positions < i
    cumstuff = np.zeros(len(data) + 1, dtype=np.int64)
    np.cumsum(stuffed, out=cumstuff[1:])

    # global index arrays over all segment bytes
    total = int(lens.sum())
    seg_of = np.repeat(np.arange(nseg, dtype=np.int64), lens)
    base = np.zeros(nseg + 1, dtype=np.int64)
    np.cumsum(lens, out=base[1:])
    local = np.arange(total, dtype=np.int64) - base[seg_of]
    pos = starts[seg_of] + local

    keep = ~stuffed[pos]
    # rank of each kept byte within its segment
    rank = local - (cumstuff[pos] - cumstuff[starts[seg_of]])

    shape = (nseg, (max_words + 1) * 4)
    if native._fits(out, shape):
        mat = out
        mat.fill(0)
    else:
        mat = np.zeros(shape, dtype=np.uint8)
    mat[seg_of[keep], rank[keep]] = data[pos[keep]]

    # per-seg unstuffed byte counts
    sb = np.bincount(seg_of[keep], minlength=nseg).astype(np.int64)
    nbits = (sb * 8).astype(np.int32)
    words = np.ascontiguousarray(mat).view(np.uint32)
    return words, nbits
