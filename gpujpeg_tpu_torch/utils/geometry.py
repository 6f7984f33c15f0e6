"""Static image geometry: components, MCUs, segments, stream block order.

TPU-native re-expression of the reference's coder-state computation
(gpujpeg_coder_init_image, src/gpujpeg_common.c:628-1106).  Where the
reference materializes a device-resident uint64 "block list" walked by
kernels, we precompute *static numpy index arrays* that become gather maps
baked into jit-compiled programs — the block list becomes index math.

All arrays here are host-side numpy and deterministic functions of
(Parameters, ImageParameters); a Geometry object is hashable via its key and
used to key jit caches.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from ..types import BLOCK_SIZE, ImageParameters, Parameters


def div_round_up(a: int, b: int) -> int:
    return (a + b - 1) // b


@dataclasses.dataclass(frozen=True)
class ComponentGeometry:
    index: int
    samp_h: int
    samp_v: int
    is_luma: bool          # component "type" (reference: luminance vs chrominance)
    width: int             # real sample dims (gpujpeg_common.c:700-710)
    height: int
    data_width: int        # padded to MCU multiple
    data_height: int
    mcu_size_x: int
    mcu_size_y: int
    mcu_count_x: int
    mcu_count_y: int
    mcu_count: int
    segment_mcu_count: int
    segment_count: int

    @property
    def block_count_x(self) -> int:
        return self.data_width // BLOCK_SIZE

    @property
    def block_count_y(self) -> int:
        return self.data_height // BLOCK_SIZE

    @property
    def block_count(self) -> int:
        return self.block_count_x * self.block_count_y

    @property
    def table_index(self) -> int:
        """Quant/Huffman table slot (gpujpeg_writer.c:347-355)."""
        return 0 if self.is_luma else 1


class Geometry:
    """Derived static geometry for one (Parameters, ImageParameters) pair."""

    def __init__(self, param: Parameters, param_image: ImageParameters):
        if param.comp_count == 0:
            raise ValueError("comp_count must be resolved before Geometry")
        self.param = param
        self.param_image = param_image
        self.comp_count = param.comp_count
        self.interleaved = bool(param.interleaved)

        # max sampling factor across components
        sf = param.sampling_factor[: self.comp_count]
        self.max_h = max(s.horizontal for s in sf)
        self.max_v = max(s.vertical for s in sf)

        comps = []
        for c in range(self.comp_count):
            samp_h, samp_v = sf[c].horizontal, sf[c].vertical
            # real dims (gpujpeg_common.c:700-710): round image dims up to a
            # multiple of the divisor, then scale by the component factor
            div_h = self.max_h // samp_h
            div_v = self.max_v // samp_v
            width = div_round_up(param_image.width, div_h) * div_h
            height = div_round_up(param_image.height, div_v) * div_v
            cw = width * samp_h // self.max_h
            ch = height * samp_v // self.max_v

            mcu_size_x = BLOCK_SIZE * (samp_h if self.interleaved else 1)
            mcu_size_y = BLOCK_SIZE * (samp_v if self.interleaved else 1)
            data_width = div_round_up(cw, mcu_size_x) * mcu_size_x
            data_height = div_round_up(ch, mcu_size_y) * mcu_size_y
            mcu_count_x = data_width // mcu_size_x
            mcu_count_y = data_height // mcu_size_y
            mcu_count = mcu_count_x * mcu_count_y
            seg_mcu = param.restart_interval if param.restart_interval else mcu_count
            is_luma = (
                param.color_space_internal.name == "RGB" or c == 0 or c == 3
            )
            comps.append(ComponentGeometry(
                index=c, samp_h=samp_h, samp_v=samp_v, is_luma=is_luma,
                width=cw, height=ch,
                data_width=data_width, data_height=data_height,
                mcu_size_x=mcu_size_x, mcu_size_y=mcu_size_y,
                mcu_count_x=mcu_count_x, mcu_count_y=mcu_count_y,
                mcu_count=mcu_count,
                segment_mcu_count=seg_mcu,
                segment_count=div_round_up(mcu_count, seg_mcu),
            ))
        self.components: Tuple[ComponentGeometry, ...] = tuple(comps)

        if self.interleaved:
            mc = comps[0].mcu_count
            for comp in comps:
                assert comp.mcu_count == mc, "interleaved comps must share MCU grid"
            self.mcu_count = mc
            self.segment_count = comps[0].segment_count
            self.segment_mcu_count = comps[0].segment_mcu_count
            self.blocks_per_mcu = sum(c.samp_h * c.samp_v for c in comps)
            self.scan_count = 1
        else:
            self.mcu_count = sum(c.mcu_count for c in comps)
            self.segment_count = sum(c.segment_count for c in comps)
            self.segment_mcu_count = param.restart_interval
            self.blocks_per_mcu = 1
            self.scan_count = self.comp_count

        self.total_blocks = sum(c.block_count for c in comps)
        self._build_stream_maps()

    # -- static index maps ---------------------------------------------------

    def _build_stream_maps(self) -> None:
        """Build stream-order block maps.

        Stream order = the order blocks appear in the entropy-coded scan(s)
        (ITU-T T.81 A.2).  Replaces the reference's device block list
        (gpujpeg_common.c:1031-1088) with host-side numpy index arrays.
        """
        comps = self.components
        # per-component flat block base offsets into the concatenated
        # per-component block storage (raster order per component)
        self.comp_block_base = np.zeros(self.comp_count + 1, dtype=np.int64)
        for c in comps:
            self.comp_block_base[c.index + 1] = (
                self.comp_block_base[c.index] + c.block_count
            )

        if not self.interleaved:
            # one scan per component; MCU == one block in raster order; the
            # concatenated storage order IS stream order.
            B = self.total_blocks
            order = np.arange(B, dtype=np.int64)
            comp_of = np.concatenate([
                np.full(c.block_count, c.index, dtype=np.int32) for c in comps
            ])
            seg_of = np.concatenate([
                np.minimum(
                    np.arange(c.block_count, dtype=np.int64) // c.segment_mcu_count,
                    c.segment_count - 1,
                ) + sum(cc.segment_count for cc in comps[: c.index])
                for c in comps
            ]).astype(np.int32)
            slot_of = np.concatenate([
                np.arange(c.block_count, dtype=np.int64) % c.segment_mcu_count
                for c in comps
            ]).astype(np.int32)
        else:
            # single interleaved scan: per MCU (raster), per comp, per
            # (v, h) subsampled block position
            mcux = comps[0].mcu_count_x
            entries = []  # (comp, block_y, block_x) template within one MCU
            for c in comps:
                for v in range(c.samp_v):
                    for h in range(c.samp_h):
                        entries.append((c.index, v, h))
            entries = np.asarray(entries, dtype=np.int64)  # (bpm, 3)
            bpm = len(entries)
            m = np.arange(self.mcu_count, dtype=np.int64)
            my, mx = m // mcux, m % mcux
            comp_of = np.broadcast_to(
                entries[:, 0][None, :], (self.mcu_count, bpm)
            ).reshape(-1).astype(np.int32)
            samp_h = np.array([c.samp_h for c in comps], dtype=np.int64)
            samp_v = np.array([c.samp_v for c in comps], dtype=np.int64)
            bcx = np.array([c.block_count_x for c in comps], dtype=np.int64)
            ce = entries[:, 0]
            by = my[:, None] * samp_v[ce][None, :] + entries[:, 1][None, :]
            bx = mx[:, None] * samp_h[ce][None, :] + entries[:, 2][None, :]
            flat_in_comp = by * bcx[ce][None, :] + bx
            order = (self.comp_block_base[comp_of.reshape(-1)]
                     + flat_in_comp.reshape(-1))
            seg_of = np.minimum(
                m // self.segment_mcu_count, self.segment_count - 1
            ).astype(np.int32)
            seg_of = np.broadcast_to(
                seg_of[:, None], (self.mcu_count, bpm)
            ).reshape(-1)
            slot_of = (
                (m % self.segment_mcu_count)[:, None] * bpm
                + np.arange(bpm, dtype=np.int64)[None, :]
            ).reshape(-1).astype(np.int32)

        #: stream position -> index into concatenated per-comp raster storage
        self.stream_to_storage = order.astype(np.int32)
        #: stream position -> component
        self.stream_comp = comp_of
        #: stream position -> global segment id
        self.stream_seg = seg_of.astype(np.int32)
        #: stream position -> block slot within its segment
        self.stream_slot = slot_of

        # DC predictor: previous stream block of the same component within the
        # same segment (JPEG resets prediction at restart markers, F.1.1.5.1)
        B = self.total_blocks
        dc_prev = np.full(B, -1, dtype=np.int32)
        # vectorized: group stream positions by (comp, seg); within a group,
        # stream order is increasing, so prev = preceding element
        key = self.stream_seg.astype(np.int64) * (self.comp_count + 1) + self.stream_comp
        pos = np.arange(B, dtype=np.int64)
        sort_idx = np.lexsort((pos, key))
        sorted_key = key[sort_idx]
        same = np.zeros(B, dtype=bool)
        same[1:] = sorted_key[1:] == sorted_key[:-1]
        prev_sorted = np.full(B, -1, dtype=np.int64)
        prev_sorted[1:][same[1:]] = sort_idx[:-1][same[1:]]
        dc_prev[sort_idx] = prev_sorted
        #: stream position -> stream position of DC predictor block (-1 = none)
        self.stream_dc_prev = dc_prev

        # segment-row layout: (segment_count, max_blocks_per_segment)
        self.max_blocks_per_seg = int(slot_of.max()) + 1 if B else 0
        rows = np.full(
            (self.segment_count, self.max_blocks_per_seg), -1, dtype=np.int32
        )
        rows[self.stream_seg, self.stream_slot] = np.arange(B, dtype=np.int32)
        #: (nseg, max_bps) -> stream block position, -1 = padding slot
        self.seg_rows = rows

        # per-stream-block static attributes
        tbl = np.array([c.table_index for c in comps], dtype=np.int32)
        self.stream_table_idx = tbl[self.stream_comp]

        # inverse map: storage index -> (seg, slot) flattened row position,
        # used by the decoder to gather per-component planes out of the
        # (nseg, max_bps, 64) decode layout
        inv = np.full(B, -1, dtype=np.int32)
        flat_rowpos = (self.stream_seg.astype(np.int64)
                       * self.max_blocks_per_seg + self.stream_slot)
        inv[self.stream_to_storage] = flat_rowpos
        self.storage_to_rowpos = inv

        # segments per scan (for stream assembly / RST placement):
        if self.interleaved:
            self.scan_segment_counts = (self.segment_count,)
        else:
            self.scan_segment_counts = tuple(
                c.segment_count for c in self.components
            )

        # static restart-marker placement (gpujpeg_encoder.c:566-624: RST(i%8)
        # after each segment, final RST of every scan dropped)
        use_rst = self.param.restart_interval > 0
        present, marker = [], []
        for nsc in self.scan_segment_counts:
            for i in range(nsc):
                p = use_rst and (i < nsc - 1)
                present.append(p)
                marker.append(0xD0 + (i % 8) if p else 0)
        #: (nseg,) bool: RST marker follows this segment in the stream
        self.rst_present = np.asarray(present, dtype=bool)
        #: (nseg,) uint8: second byte of that RST marker (0xD0 + i%8)
        self.rst_marker = np.asarray(marker, dtype=np.uint8)
        #: (nseg,) int32: 2*(number of RST markers before this segment)
        self.rst_shift = np.zeros(self.segment_count, dtype=np.int32)
        if self.segment_count > 1:
            self.rst_shift[1:] = 2 * np.cumsum(
                self.rst_present[:-1].astype(np.int32))
        #: (scan_count+1,) segment-index boundaries of each scan
        self.scan_seg_bounds = np.concatenate(
            [[0], np.cumsum(self.scan_segment_counts)]).astype(np.int64)

    # -- misc ------------------------------------------------------------------

    @property
    def key(self):
        return (self.param, self.param_image)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, Geometry) and self.key == other.key


@functools.lru_cache(maxsize=64)
def get_geometry(param: Parameters, param_image: ImageParameters) -> Geometry:
    return Geometry(param, param_image)


def suggest_restart_interval(
    param_image: ImageParameters, comp_count: int,
    subsampled: bool, interleaved: bool,
    blocks_per_mcu: int = 0, quality: int = 75,
) -> int:
    """TPU-tuned auto restart interval.

    The reference scales its interval with megapixels for GPU warp
    occupancy (gpujpeg_encoder.c:290-317, available below as
    suggest_restart_interval_gpujpeg).  On TPU the packer is a merge tree
    whose depth and deep-level buffer widths grow with tokens per segment,
    so SHORTER segments win: ~8 blocks per segment costs ~7% stream size
    in extra restart markers but runs the 8K encode 1.7x faster (and
    shrinks the decoder's per-segment scan the same way).

    QUALITY-aware: at very high quality the per-segment byte count grows
    ~6x (Q75 -> Q100), pushing the decoder's per-segment word window past
    the Pallas scan kernel's W <= 64 budget and onto the XLA fallback
    (measured 88 ms for an 8K Q100 decode vs 12.5 at Q75).  Halving the
    interval restores the kernel path for ~1% extra marker overhead.

    At quality >= 97 (non-interleaved) the interval drops to ONE block
    per segment: the decoder's serial token walk per lane is then
    tokens-per-BLOCK instead of blocks * tokens-per-block, and the
    boundary-scan and split phases vanish entirely (decoder
    _decode_direct; measured 42 -> ~15 ms device for 8K Q100 decode).
    Cost: ~5% stream size in markers + absolute-DC at Q100 density —
    the same size-for-speed trade the reference's auto interval makes
    (gpujpeg_encoder.c:290-317).  Pass an explicit restart_interval to
    override, or set GPUJPEG_TPU_RESTART_SCHEDULE=host to keep the
    interval at 4 for Q >= 97 (fewer segments => cheaper host-side
    parse/unstuff on low-core hosts, at the cost of the slower
    scan-phase decode on device).
    """
    import os

    blocks = 8                          # blocks per segment target
    schedule = os.environ.get("GPUJPEG_TPU_RESTART_SCHEDULE", "device")
    if quality >= 97 and not interleaved and schedule != "host":
        blocks = 1
    elif quality >= 93:
        # 4 (not 2): Q93-96 content still fits the W <= 64 scan window
        # at 4 blocks/segment with moderate per-segment host-prep cost
        blocks = 4
    if not interleaved:
        return blocks                   # blocks (== MCUs) per segment
    # blocks per interleaved MCU comes from the caller's sampling factors
    # (6 for 4:2:0, 4 for 4:2:2, comp_count for 4:4:4) with a
    # subsampling-derived fallback
    bpm = blocks_per_mcu or (6 if subsampled else comp_count)
    return max(1, blocks // max(bpm, 1))


def suggest_restart_interval_gpujpeg(
    param_image: ImageParameters, comp_count: int,
    subsampled: bool, interleaved: bool,
) -> int:
    """The reference's auto formula (gpujpeg_encoder.c:290-317), kept for
    stream-layout parity testing."""
    coefficient = (param_image.width * param_image.height * comp_count) / 3e6
    if coefficient < 1.0:
        ri = 4
    elif coefficient < 3.0:
        ri = 8
    elif coefficient < 9.0:
        ri = 10
    else:
        ri = 12
    if subsampled and interleaved:
        ri //= 2
    if not interleaved:
        ri *= comp_count
    return ri
