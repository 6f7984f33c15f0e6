"""PyTorch port, the row kernels' partition (csrc/relayout.cu
pair_sum_rows and pack_u8_quads): the launch plan of rows_entry (the
resident grid, a band of output rows a CTA) and the walk of
rows_vec_kernel (thread t taking the band's 16-byte output chunks t, t +
256, ... stepped by (dr, dq) in rounds of kUnroll chunks, every load of a
round issued before its stores) replayed in Python with the kernel's own
constants, read from its source.  The replay checks that every output
word is written exactly once, that each chunk a thread folds is read from
the F input rows behind it, inside its CTA's band and on 16 bytes, and
that no round of a thread holds more than kUnroll chunks.  It replays the
partition, not the arithmetic: the fold is held against the plain
versions in tests/test_torch_relayout.py, and the kernels against them on
the card (tests/test_torch_kernels.py)."""

import os
import re

import numpy as np
import pytest
from tests import torch_threads  # noqa: F401

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gpujpeg_tpu_torch", "csrc", "relayout.cu")


def _constants():
    with open(_SRC) as f:
        text = f.read()
    return {name: int(v) for name, v in re.findall(
        r"^constexpr int (kRowThreads|kUnroll) = (\d+);", text, re.M)}


K = _constants()
T = K["kRowThreads"]


def plan(rows, C, ctas):
    """rows_entry's launch: (band, grid), or None when it launches
    nothing."""
    if rows == 0 or C == 0:
        return None
    band = -(-rows // ctas)
    return band, -(-rows // band)


def replay_cta(b, rows, C, F, band, written):
    """rows_vec_kernel for CTA b, its threads side by side: returns the
    rounds the CTA's threads ran."""
    w4 = C >> 2
    dr, dq = T // w4, T % w4
    lo = b * band
    hi = min(rows, lo + band)
    t = np.arange(T)
    r, q = lo + t // w4, t % w4
    rounds = 0
    while (r < hi).any():
        chunks = []                     # (row, chunk) of each live load
        for _u in range(K["kUnroll"]):
            live = r < hi
            for k in range(F):          # the loads of a chunk
                word = (r[live] * F + k) * C + 4 * q[live]
                assert (word % 4 == 0).all()
                assert (word >= lo * F * C).all()
                assert (word + 4 <= hi * F * C).all()
                assert np.array_equal(word // C, r[live] * F + k)
                assert np.array_equal(word % C, 4 * q[live])
            chunks.append((r[live], q[live]))
            r, q = r + dr, q + dq
            wrap = q >= w4
            q[wrap] -= w4
            r[wrap] += 1
        for rr, qq in chunks:           # then the round's stores
            np.add.at(written, (np.repeat(rr, 4),
                                (4 * qq[:, None] + np.arange(4)).ravel()), 1)
        rounds += 1
    return rounds


#: (rows, C, F, resident CTAs, what the shape exercises)
SHAPES = [
    (11520, 128, 2, 1056, "pair at the tools' 8K shape, a H100's grid"),
    (5760, 128, 4, 264, "pack at the tools' 8K shape"),
    (46080, 128, 2, 528, "several rounds a thread"),
    (100, 128, 2, 1, "one CTA, 4 rounds, the last ragged"),
    (37, 12, 4, 5, "rows off the band, dr 85, dq 1"),
    (9, 4, 2, 2, "C = 4: 256 rows a round of the CTA"),
    (3, 2052, 2, 2, "rows of 513 chunks, across threads and rounds"),
    (5, 516, 4, 3, "rows of 129 chunks"),
    (2, 1024, 2, 7, "rows of exactly 256 chunks"),
    (1, 128, 4, 1056, "one output row, one CTA"),
    (0, 128, 2, 1056, "no rows: nothing launched"),
]


@pytest.mark.parametrize("rows,C,F,ctas,what", SHAPES,
                         ids=[s[4] for s in SHAPES])
def test_vector_partition_writes_each_word_once(rows, C, F, ctas, what):
    p = plan(rows, C, ctas)
    written = np.zeros((rows, C), np.int64)
    if p is None:
        assert rows == 0
        return
    band, grid = p
    assert grid <= ctas and (grid - 1) * band < rows <= grid * band
    rounds = [replay_cta(b, rows, C, F, band, written) for b in range(grid)]
    assert (written == 1).all()
    if what.startswith("several"):
        assert max(rounds) > 1


@pytest.mark.parametrize("rows,C,F,ctas", [(37, 7, 2, 5), (6, 300, 4, 1),
                                           (2, 5, 4, 1056)])
def test_word_partition_writes_each_word_once(rows, C, F, ctas):
    """The generic instance: the same bands, a row at a time, thread t
    the words t, t + 256, ... of the row."""
    band, grid = plan(rows, C, ctas)
    written = np.zeros((rows, C), np.int64)
    for b in range(grid):
        for i in range(b * band, min(rows, b * band + band)):
            for t in range(T):
                written[i, t:C:T] += 1
    assert (written == 1).all()
