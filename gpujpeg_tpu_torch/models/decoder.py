"""Decoder session of the PyTorch port (gpujpeg_tpu.models.decoder).

The decode of one codestream:

    host: parse markers, split and unstuff the restart segments into a
          (segments, words) matrix                stream/reader, segments
    device:
      phase A, block boundaries of each segment   huffdec_kernel.scan_segments
      phase C, coefficients of each block         huffdec_kernel.decode_blocks
      differential DC -> absolute, per component  dc_fixup
    or, for non-interleaved scans of one block a restart segment (the
    direct route, the JAX decoder's _decode_direct):
      phase C, a segment row a block, from bit 0
      to the segment's bit count                  huffdec_kernel.
                                                  decode_blocks_direct
    then, for non-interleaved scans of 3 components whose chroma planes
    tile the luma plane at dx, dy in {1, 2}, to RGB or RGBA
    (prepost_kernel.decode_post_supported):
      dequantization + IDCT + upsampling + colour
      + store                                     prepost_kernel.decode_post
    or, for an interleaved scan and any other stream or output:
      dequantization + IDCT, a plane per
      component, one launch                       prepost_kernel.idct_planes
      upsampling + colour + store                 prepost_kernel.
                                                  postprocess_packed
    then the output options (flip, remap, row padding), torch ops.

On CUDA every stage is a hand-written kernel (the DC integration's is
csrc/dc_fixup.cu); with device="cpu" every stage runs its plain PyTorch
version (_dc_fixup_t, a torch cumsum, for the DC).  The pixels are
the same either way and equal the JAX package's.  Phase C decodes each
block straight out of its segment's row (the segment-row contract), so
the JAX package's phase B (the split into per-block buffers) and its
capacity protocol do not exist here.  In an interleaved scan a segment row
holds whole MCUs; the two Huffman phases take each block's table class
from the slot pattern of the MCU (Plan.pattern).

The decoder takes baseline streams of 1 to 4 components at every
sampling, in non-interleaved scans or in one interleaved scan: the
streams libjpeg, PIL and cameras write as well as the JAX package's.  It
writes every output of the JAX package: U8, P444_U8_P012,
P4444_U8_P0123 (alpha 255 from 3 components, the 4th component raw from
4), UYVY and the three planar formats, after the pseudo requests
AUTODETECT, NATIVE, STD and NO_ALPHA (resolve_output).  dpost takes
exactly the streams and outputs the JAX gate sends to its fused tail
(3 components to RGB or RGBA); everything else goes through the IDCT
planes and the postprocessor.  The options dec_opt_flipped,
dec_opt_channel_remap and dec_opt_alignment_bytes act on the decoded
image on the card (_apply_output_options, torch ops, as they are XLA ops
in the JAX package).  Any baseline Huffman tables (the
tuned family, Annex K, optimised ones) go through the same kernels, fed
the stream's canonical tables and their lookahead tables; up to two
table sets a class take the kernels' two-set instances, three or four
their four-set instances (huffdec_kernel's module docstring), which the
JAX package decodes on its legacy path.  A restart interval of 0 makes
each scan one segment: phase A's sync instance walks it in
subsequences, many threads a scan (huffdec_kernel.scan_instance), and
phase C decodes its blocks in parallel from phase A's cursors.

The direct route (Plan.direct) is taken for every non-interleaved stream
of one block a restart segment, which is what the auto restart interval
picks at quality 97 and above (utils/geometry.suggest_restart_interval):
the segment rows are the block buffers, so phase A does not run, and DC
is absolute (the predictor resets at every restart marker), so the DC
fix-up does not run either.  Phase C is bounded by each segment's
byte-aligned bit count, so a corrupt block may take up to 7 padding bits
without an error, as in the JAX route.  The JAX gate also asks for rows
of at most 40 words and at most two table sets (Plan.kernel_block_fn
there); those limits size its TPU kernel, and the port's kernel has
neither, so every such stream goes direct.  decode_coefficients keeps
phases A and C, as the JAX method does.  The RLE TGA option sets
io.image.TGA_RLE, the module global the file writer reads (a process-wide
setting, as in the JAX package).

The session surface is the JAX package's.  The words go up on an upload
stream from a reused pinned buffer and the image comes back into a
fresh pinned block on a download stream (models/staging.py), with the
corrupt-segment flag, so decode() synchronises once, on the image.
decode_pipelined parses and unstuffs stream i+1 (into the other of two
pinned buffers) while stream i's kernels and download run, with the
pixels of sequential decode(); pack_stream is its host prep against a
fixed geometry, row width and tables (CapacityError for a wider
stream); compile_stream_pipeline returns the device-only decode of
streams shaped like an example, and warmup decodes one to make the
plan, tables, kernels and buffers ready.  get_stats() gives the last
frame's DecoderStats from CUDA events read with the image (the phase
splits under perf_stats).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import logging
import math
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _kernels, huffdec_kernel, prepost_kernel, sample
from ..stream import reader, segments as segprep
from ..types import (ColorSpace, CorruptStreamError, ImageInfo,
                     ImageParameters, PixelFormat, PixelFormatRequest,
                     YCBCR_JPEG, from_reference, pixel_format_unit_size)
from ..utils.geometry import Geometry, get_geometry
from .staging import Clock, Fetch, Staging

log = logging.getLogger("gpujpeg_tpu_torch")

#: the reused segment-matrix buffer grows in steps of this many bytes
SCRATCH_STEP = 1 << 20

#: the DC fix-up's kernel (csrc/dc_fixup.cu kVecSlots, kTile,
#: kMaxThreadVecs, kChainVecs; fixup_layout): a thread takes vectors of
#: DC_PER slots of the DC row, up to DC_THREAD_VECS of them where its
#: slots hold whole rows, else one in tiles of up to DC_TILE slots of
#: whole rows, or DC_CHAIN_VECS in chained tiles
DC_PER = 8
DC_TILE = 2048
DC_THREAD_VECS = 3
DC_CHAIN_VECS = 2


def _bucket(n: int, lo: int = 16) -> int:
    """The pipeline's row width in words for n words: the next power of
    two from lo (gpujpeg_tpu.models.decoder._bucket)."""
    b = lo
    while b < n:
        b *= 2
    return b


def pinned_empty(nbytes: int) -> np.ndarray:
    """A page-locked host buffer of nbytes, as a numpy array (the source
    of non-blocking uploads)."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()


def default_output(ps: reader.ParsedStream) -> ImageParameters:
    """Default output: interleaved RGB (or U8 for grayscale), like the
    reference CLI default (gpujpeg_decoder.c output selection)."""
    if ps.comp_count == 1:
        pf, cs = PixelFormat.U8, ColorSpace.NONE
    elif ps.comp_count == 4:
        pf, cs = PixelFormat.P4444_U8_P0123, ColorSpace.RGB
    else:
        pf, cs = PixelFormat.P444_U8_P012, ColorSpace.RGB
    return ImageParameters(width=ps.width, height=ps.height,
                           color_space=cs, pixel_format=pf)


def _native_pixel_format(ps: reader.ParsedStream) -> PixelFormat:
    """Pixel format nearest the stream's internal subsampling
    (get_native_pixel_format, gpujpeg_reader.c:1507-1552)."""
    if ps.comp_count == 4:
        return PixelFormat.P4444_U8_P0123
    samp = list(ps.sampling[:3])
    hg = functools.reduce(math.gcd, (h for h, _ in samp))
    vg = functools.reduce(math.gcd, (v for _, v in samp))
    samp = [(h // hg, v // vg) for h, v in samp]
    if samp[1] == (1, 1) and samp[2] == (1, 1):
        key = (ps.interleaved, samp[0][0], samp[0][1])
        table = {
            (True, 1, 1): PixelFormat.P444_U8_P012,
            (False, 1, 1): PixelFormat.P444_U8_P0P1P2,
            (True, 2, 1): PixelFormat.P422_U8_P1020,
            (False, 2, 1): PixelFormat.P422_U8_P0P1P2,
            (True, 2, 2): PixelFormat.P420_U8_P0P1P2,
            (False, 2, 2): PixelFormat.P420_U8_P0P1P2,
        }
        if key in table:
            return table[key]
    return (PixelFormat.P444_U8_P012 if ps.interleaved
            else PixelFormat.P444_U8_P0P1P2)


def resolve_output(ps: reader.ParsedStream,
                   param_image: Optional[ImageParameters],
                   alignment_bytes: int = 0) -> ImageParameters:
    """Resolve the requested output ImageParameters against the stream:
    pseudo pixel formats AUTODETECT / NO_ALPHA / STD / NATIVE
    (gpujpeg_decoder.h:233-246), CS_DEFAULT / NONE color-space rules and
    row-alignment padding (adjust_params, gpujpeg_reader.c:1555-1616)."""
    req_pf = param_image.pixel_format if param_image else \
        PixelFormatRequest.AUTODETECT
    req_cs = param_image.color_space if param_image else ColorSpace.NONE

    unresolved = isinstance(req_pf, PixelFormatRequest) or \
        req_pf == PixelFormat.NONE

    # color space: NONE = CS_DEFAULT (grayscale stays luma, else RGB)
    if req_cs == ColorSpace.NONE:
        cs = YCBCR_JPEG if ps.comp_count == 1 else ColorSpace.RGB
    else:
        cs = req_cs

    if unresolved:
        if req_pf == PixelFormat.NONE:
            req_pf = PixelFormatRequest.AUTODETECT
        if ps.comp_count == 1:
            pf = PixelFormat.U8
        elif req_pf == PixelFormatRequest.NATIVE:
            pf = _native_pixel_format(ps)
        elif req_pf == PixelFormatRequest.STD and cs != ColorSpace.RGB:
            samp = tuple(ps.sampling[:3])
            if samp == ((2, 2), (1, 1), (1, 1)):
                pf = PixelFormat.P420_U8_P0P1P2
            elif samp == ((2, 1), (1, 1), (1, 1)):
                pf = PixelFormat.P422_U8_P0P1P2
            else:
                pf = PixelFormat.P444_U8_P0P1P2
        elif ps.comp_count == 4 and req_pf != PixelFormatRequest.NO_ALPHA:
            pf = PixelFormat.P4444_U8_P0123
        else:
            pf = PixelFormat.P444_U8_P012
    else:
        pf = req_pf

    # width_padding is BYTES appended per row (gpujpeg_reader.c:1610-1615)
    width_padding = param_image.width_padding if param_image else 0
    if alignment_bytes:
        unit = pixel_format_unit_size(pf)
        if unit:  # row alignment applies to packed formats only
            linesize = unit * ps.width
            aligned = -(-linesize // alignment_bytes) * alignment_bytes
            width_padding = aligned - linesize

    return ImageParameters(width=ps.width, height=ps.height,
                           color_space=cs, pixel_format=pf,
                           width_padding=width_padding)


def _comp_tables(ps: reader.ParsedStream, ncomp: int):
    """Each component's (dc, ac) Huffman table ids from the scans."""
    comp_dc = np.zeros(ncomp, np.int32)
    comp_ac = np.zeros(ncomp, np.int32)
    for scan in ps.scans:
        for ci, d, a in zip(scan.comp_indices, scan.dc_table, scan.ac_table):
            comp_dc[ci], comp_ac[ci] = d, a
    return comp_dc, comp_ac


def _table_ids(ps: reader.ParsedStream, ncomp: int):
    """(comp_dc, comp_ac, dc_ids, ac_ids): each component's table ids and
    the sorted ids the scans use, a class each."""
    comp_dc, comp_ac = _comp_tables(ps, ncomp)
    return (comp_dc, comp_ac, sorted(set(comp_dc.tolist())),
            sorted(set(comp_ac.tolist())))


def _table_key(ps: reader.ParsedStream) -> tuple:
    """Everything of the stream's tables a plan depends on."""
    key = []
    for tabs in (ps.huff_dc, ps.huff_ac):
        for tid in sorted(tabs):
            b, v = tabs[tid]
            key.append((tid, np.asarray(b, np.int64).tobytes(),
                        np.asarray(v, np.int64).tobytes()))
    for tid in sorted(ps.quant_tables):
        key.append((tid, np.asarray(ps.quant_tables[tid]).tobytes()))
    comp_dc, comp_ac = _comp_tables(ps, ps.comp_count)
    return (tuple(key), tuple(ps.quant_map), comp_dc.tobytes(),
            comp_ac.tobytes())


def _table_signature(ps: reader.ParsedStream) -> tuple:
    """Each component's (quant table, DC bits and values, AC bits and
    values) as bytes: the tables a stream pipeline decodes with, beyond
    the layout its Geometry records (gpujpeg_tpu.models.decoder.
    _table_signature)."""
    comp_dc: Dict[int, int] = {}
    comp_ac: Dict[int, int] = {}
    for scan in ps.scans:
        for ci, d, a in zip(scan.comp_indices, scan.dc_table,
                            scan.ac_table):
            comp_dc[ci], comp_ac[ci] = d, a
    sig = []
    for ci in sorted(comp_dc):
        db, dv = ps.huff_dc[comp_dc[ci]]
        ab, av = ps.huff_ac[comp_ac[ci]]
        sig.append((np.asarray(ps.quant_tables[ps.quant_map[ci]])
                    .tobytes(),
                    np.asarray(db).tobytes(), np.asarray(dv).tobytes(),
                    np.asarray(ab).tobytes(), np.asarray(av).tobytes()))
    return tuple(sig)


class CapacityError(ValueError):
    """A stream of the pipeline's format needs wider segment rows than
    the pipeline was made for: decodable, just not by this pipeline."""


class DecoderStats:
    """Per-phase decode timings of the last frame, the decoder's
    counterpart of the encoder's DurationStats (gpujpeg_duration_stats,
    gpujpeg_common.h:365-375), with the fields and labels of the JAX
    package's.  duration_stream is the host's parse and unstuff;
    duration_in_gpu the kernels from phase A to the last pixel store and
    duration_memory_from the copy of the image to the host, from CUDA
    events read when the image is fetched (the host's clock on the CPU).
    Under Decoder.perf_stats the Huffman phases (A, C and the DC fix-up;
    phase C alone on the direct route) and the IDCT with the colour
    stages (dpost, or the IDCT planes and the postprocessor) are split;
    postprocessing is counted in the second, as the label says."""

    def __init__(self) -> None:
        self.duration_stream = 0.0
        self.duration_in_gpu = 0.0
        self.duration_memory_from = 0.0
        self.duration_huffman_coder = 0.0
        self.duration_dct_quantization = 0.0
        self.duration_preprocessor = 0.0
        self.frames = 0
        self.total_ms = 0.0
        self.total_ms_wo_first = 0.0

    def add_frame(self, total: float) -> None:
        self.frames += 1
        self.total_ms += total
        if self.frames > 1:
            self.total_ms_wo_first += total

    def print(self, file=None) -> None:
        f = file or sys.stderr
        print(f" -Stream Reader:     {self.duration_stream:10.4f} ms",
              file=f)
        if self.duration_huffman_coder or self.duration_dct_quantization:
            print(f" -Huffman Decoder:   "
                  f"{self.duration_huffman_coder:10.4f} ms", file=f)
            print(f" -DCT & Quantization:"
                  f"{self.duration_dct_quantization:10.4f} ms", file=f)
            print(f" -Postprocessing:    "
                  f"{self.duration_preprocessor:10.4f} ms (fused into "
                  "DCT kernel)", file=f)
        print(f" -Device pipeline:   {self.duration_in_gpu:10.4f} ms",
              file=f)
        if self.duration_memory_from:
            print(f" -Copy From Device:  "
                  f"{self.duration_memory_from:10.4f} ms", file=f)

    def summary(self) -> str:
        if not self.frames:
            return "no frames"
        s = (f"avg {self.total_ms / self.frames:.2f} ms / frame "
             f"({self.frames} frames)")
        if self.frames > 1:
            s += (f"; {self.total_ms_wo_first / (self.frames - 1):.2f} ms"
                  " without first")
        return s


@dataclasses.dataclass
class Plan:
    """The per-segment constants of one (geometry, tables) combination,
    on the session's device: the kernels' inputs that do not change from
    frame to frame."""

    geo: Geometry
    bps: int                  # block slots a segment row
    nblocks: torch.Tensor     # (nseg,) int32 real blocks a segment
    # (nseg,) int32 DC and AC table selectors of each segment: with two
    # table sets 1 = set 0 (luma), with four the set's index
    dc_luma: torch.Tensor
    ac_luma: torch.Tensor
    tables: torch.Tensor      # (2 * sets, DECODE_TABLE_WORDS) int32, sets
    #                           = 2 or 4 (huffdec_kernel.decode_tables)
    scan_lut: torch.Tensor    # (2 * sets, 1 << SCAN_LUT_BITS) int16, phase
    #                           A's lookahead table (huffdec_kernel.scan_lut)
    block_lut: torch.Tensor   # (2 * sets, 1 << BLOCK_LUT_BITS) int32, phase
    #                           C's lookahead table (huffdec_kernel.block_lut)
    qtabs: torch.Tensor       # (3, 64) float32 zig-zag quant tables
    # slot pattern (bpm, dc mask, ac mask): with two sets, block slot j of
    # a segment takes set 0 when its segment's flag and bit j % bpm are
    # set; with four, the set of its selector plus field j % bpm (2 bits)
    pattern: Tuple[int, int, int] = huffdec_kernel.NO_PATTERN
    # each component's block slots in a segment row (int64 indices), for
    # the DC integration of an interleaved row; None when a row is one
    # component
    comp_slots: Optional[Tuple[torch.Tensor, ...]] = None
    # the same for the DC fix-up's kernel: (bpm, the component of slot
    # j % bpm in 2 bits a slot, components)
    comp_pattern: Tuple[int, int, int] = (1, 0, 1)
    # (2 * sets, stride) int16, the direct instance's two-level table
    # (huffdec_kernel.direct_lut) on a plan of the direct route, else None
    direct_lut: Optional[torch.Tensor] = None
    # the table sets the stream's blocks take: 2 (four tables), 3 or 4
    # (eight; with 3 the fourth set is a copy of the third, and phase A
    # loads the lookahead rows of the first three alone)
    sets: int = 2
    # the DC fix-up's look-back records where rows are longer than its
    # tile (restart interval 0), made at the first launch on a (device,
    # stream) and kept there with the count of its launches' generations
    # (dc_fixup)
    fixup_scratch: Dict[tuple, tuple] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def direct(self) -> bool:
        """One block a segment in non-interleaved scans: the direct route
        (phase C alone, from bit 0 of each segment row)."""
        return self.bps == 1 and not self.geo.interleaved


def _make_plan(ps: reader.ParsedStream, geo: Geometry, device) -> Plan:
    """The plan of a stream: any baseline DHT tables (the canonical decode
    takes them all), two table sets where the scans use at most two ids a
    class, four (T.81's ids 0-3) otherwise (huffdec_kernel's module
    docstring)."""
    comp_dc, comp_ac, dc_ids, ac_ids = _table_ids(ps, geo.comp_count)
    nsets = 2 if len(dc_ids) <= 2 and len(ac_ids) <= 2 else 4
    used = 2 if nsets == 2 else max(len(dc_ids), len(ac_ids))

    def pick(tabs, ids, i):
        return tabs[ids[min(i, len(ids) - 1)]]

    tab = huffdec_kernel.decode_tables(
        *[pick(ps.huff_dc, dc_ids, i) for i in range(nsets)],
        *[pick(ps.huff_ac, ac_ids, i) for i in range(nsets)])

    def sel(ids, tid):
        """A component's selector of table id tid: its luma flag with two
        sets, its set's index with four."""
        return ids.index(tid) if nsets == 4 else int(tid == ids[0])

    lut = huffdec_kernel.scan_lut(tab)
    blut = huffdec_kernel.block_lut(tab)
    bps = geo.max_blocks_per_seg
    qtabs = np.stack([ps.quant_tables[ps.quant_map[c.index]]
                      for c in geo.components]).astype(np.float32)

    def dev(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(
            np.concatenate(a) if isinstance(a, list) else a, dtype)).to(
            device)

    if geo.interleaved:
        # one interleaved scan (gpujpeg_tpu.models.decoder._plan_for): a
        # segment row holds whole MCUs, the component of block slot j is
        # ent[j % bpm], and the classes follow it
        S, rst, bpm = (geo.segment_count, geo.segment_mcu_count,
                       geo.blocks_per_mcu)
        ent = [c.index for c in geo.components
               for _ in range(c.samp_v * c.samp_h)]
        width = 1 if nsets == 2 else 2            # bits of a slot's field
        dc_pat = sum(sel(dc_ids, comp_dc[e]) << width * j
                     for j, e in enumerate(ent))
        ac_pat = sum(sel(ac_ids, comp_ac[e]) << width * j
                     for j, e in enumerate(ent))
        flags = np.full(S, 1 if nsets == 2 else 0)
        slot_comp = np.tile(np.asarray(ent), bps // bpm)
        comp_slots = tuple(dev(np.flatnonzero(slot_comp == c.index),
                               np.int64) for c in geo.components)
        return Plan(geo=geo, bps=bps,
                    nblocks=dev(np.clip(geo.mcu_count - rst * np.arange(S),
                                        0, rst) * bpm),
                    dc_luma=dev(flags), ac_luma=dev(flags),
                    tables=dev(tab), scan_lut=dev(lut, np.int16),
                    block_lut=dev(blut), qtabs=dev(qtabs, np.float32),
                    pattern=(bpm, dc_pat, ac_pat),
                    comp_slots=comp_slots,
                    comp_pattern=(bpm, sum(e << 2 * j
                                           for j, e in enumerate(ent)),
                                  geo.comp_count), sets=used)
    nb, dcl, acl = [], [], []
    for c in geo.components:
        S, rst = c.segment_count, c.segment_mcu_count
        nb.append(np.clip(c.mcu_count - rst * np.arange(S), 0, rst))
        dcl.append(np.full(S, sel(dc_ids, comp_dc[c.index])))
        acl.append(np.full(S, sel(ac_ids, comp_ac[c.index])))
    return Plan(geo=geo, bps=bps, nblocks=dev(nb), dc_luma=dev(dcl),
                ac_luma=dev(acl), tables=dev(tab),
                scan_lut=dev(lut, np.int16), block_lut=dev(blut),
                qtabs=dev(qtabs, np.float32),
                pattern=(huffdec_kernel.NO_PATTERN if nsets == 2
                         else huffdec_kernel.NO_PATTERN_WIDE),
                direct_lut=(dev(huffdec_kernel.direct_lut(tab), np.int16)
                            if bps == 1 else None), sets=used)


@dataclasses.dataclass
class HostFrame:
    """One parsed stream, ready for the device: its plan and its unstuffed
    segment matrix."""

    plan: Plan
    out_pi: ImageParameters
    words: np.ndarray         # (nseg, W) int32 host-order rows
    nbits: np.ndarray         # (nseg,) int32 bits of each segment


def _dc_fixup_t(coefs_t: torch.Tensor, nseg: int, bps: int,
                comp_slots: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> torch.Tensor:
    """Integrate differential DC along each segment row of the (64, L)
    layout, in place; the predictor resets at each restart marker (T.81
    F.1.1.5.1).  Every slot of a row belongs to one component in a
    non-interleaved scan; in an interleaved one each component integrates
    over its own slots (comp_slots, as gpujpeg_tpu.models.decoder.
    _dc_fixup_t does with its comp_pattern).  The sums run down the
    transposed (slots, nseg) rows, a scan over a short outer dimension;
    where rows are longer than they are many (restart interval 0: a scan
    a row) a one-component row sums along its own contiguous slots (a
    torch cumsum down 518,400 slots of a 3-column view took 37 ms at 8K
    4:4:4 on an H100 80GB HBM3 at 700 W; PERF.md)."""
    if comp_slots is None and bps > nseg:
        dc = coefs_t[0].view(nseg, bps)
        dc.copy_(torch.cumsum(dc, dim=1, dtype=torch.int32))
        return coefs_t
    dc_t = coefs_t[0].view(nseg, bps).T
    for idx in comp_slots or (slice(None),):
        dc_t[idx] = torch.cumsum(dc_t[idx], dim=0,
                                 dtype=torch.int32).to(torch.int16)
    return coefs_t


def fixup_layout(nseg: int, bps: int, aligned: bool = True
                 ) -> Tuple[int, int, int, str]:
    """(slots a tile, tiles, vectors a thread, mode) of the DC fix-up's
    kernel over nseg rows of bps slots (csrc/dc_fixup.cu layout): "thread"
    where a thread's 8, 16 or 24 slots hold whole rows (16-byte aligned
    rows only: it loads whole vectors), "tile" where a tile of at most
    DC_TILE slots holds whole rows (lcm(bps, DC_PER) <= DC_TILE), so no
    sum crosses a tile, else "chained": tiles of DC_CHAIN_VECS * DC_TILE
    slots that pass their sums on by a look-back."""
    for vecs in range(1, DC_THREAD_VECS + 1):
        if aligned and DC_PER * vecs % bps == 0:
            tile = DC_TILE * vecs
            return tile, -(-nseg * bps // tile), vecs, "thread"
    lcm = bps * DC_PER // math.gcd(bps, DC_PER)
    if lcm <= DC_TILE:
        tile, vecs, mode = DC_TILE // lcm * lcm, 1, "tile"
    else:
        tile, vecs, mode = DC_TILE * DC_CHAIN_VECS, DC_CHAIN_VECS, "chained"
    return tile, -(-nseg * bps // tile), vecs, mode


def fixup_scratch_words(tiles: int) -> int:
    """uint32 words of the chained fix-up's records: a status word a
    tile (padded to 16 bytes), then a tile's aggregate and inclusive sums
    (4 words each)."""
    return -(-tiles // 4) * 4 + 8 * tiles


def _check_fixup(coefs_t: torch.Tensor, bps: int) -> int:
    """The rows of (64, nseg * bps) int16 coefficients: nseg."""
    if coefs_t.dim() != 2 or coefs_t.shape[0] != 64 or \
            coefs_t.dtype != torch.int16 or coefs_t.shape[1] % bps:
        raise ValueError(f"dc_fixup takes (64, nseg * {bps}) int16 "
                         "coefficients")
    return coefs_t.shape[1] // bps


def _fixup_args(coefs_t: torch.Tensor, plan: Plan) -> tuple:
    """The C arguments of a fix-up launch on coefs_t (CUDA): the chained
    layout's records, kept on the plan for the current stream (launches on
    one stream run in order), grown when a launch needs more, zeroed once
    when made, and the launch's generation, one the records' count has not
    given before (its records never match an earlier launch's)."""
    bps = plan.bps
    nseg = _check_fixup(coefs_t, bps)
    _kernels.require_cuda("dc_fixup", coefs_t)
    bpm, pat, _ncomp = plan.comp_pattern
    _tile, tiles, _vecs, mode = fixup_layout(nseg, bps)
    scratch, words, gen = None, 0, 1
    if mode == "chained" and nseg:
        dev = coefs_t.device
        key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
        entry = plan.fixup_scratch.get(key)
        if entry is None or entry[0].numel() < fixup_scratch_words(tiles):
            with torch.cuda.device(dev):
                entry = (torch.zeros(fixup_scratch_words(tiles),
                                     dtype=torch.int32, device=dev),
                         itertools.count())
            plan.fixup_scratch[key] = entry
        scratch, gens = entry
        words = scratch.numel()
        gen = next(gens) % ((1 << 30) - 1) + 1
    return (coefs_t, nseg, bps, bpm, pat, scratch, words, gen)


def dc_fixup(coefs_t: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Differential DC -> absolute in place, along each segment row of the
    (64, nseg * plan.bps) int16 coefficients, each component of an
    interleaved row over its own slots: csrc/dc_fixup.cu on CUDA (one
    launch on every shape: whole rows a thread or a tile, or, for rows
    longer than a tile, tiles chained by a look-back over records kept on
    the plan, fixup_layout), _dc_fixup_t on the CPU."""
    nseg = _check_fixup(coefs_t, plan.bps)
    if coefs_t.device.type == "cpu":
        return _dc_fixup_t(coefs_t, nseg, plan.bps, plan.comp_slots)
    _kernels.launch("dc_fixup", *_fixup_args(coefs_t, plan))
    return coefs_t


def dc_fixup_probe(coefs_t: torch.Tensor, plan: Plan, stage: str) -> None:
    """Decomposition stage `stage` (_kernels.PROBE_STAGES) of the fix-up's
    kernel on coefs_t, in place, as dc_fixup launches it (chip_smoke.py's
    probe; never a codec path, never counted in _kernels.LAUNCHES)."""
    _check_fixup(coefs_t, plan.bps)
    if coefs_t.device.type != "cuda":
        raise ValueError("dc_fixup_probe: the probe takes CUDA tensors "
                         "only")
    _kernels.probe("dc_fixup", stage, *_fixup_args(coefs_t, plan))


@dataclasses.dataclass
class _Decoding:
    """One frame on the card: its image and error flag on their way to
    the host, and its clock."""

    image: Fetch
    bad: Fetch
    clock: Clock


class Decoder:
    """Persistent decoder session (create once, decode many streams).

    device: None runs on the current CUDA device and raises when there is
    none; "cpu" runs the plain PyTorch versions of the kernels."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._plans: Dict[tuple, Plan] = {}
        self._staging = Staging(self.device)
        # grow-only pinned buffer of the segment matrix, reused by every
        # frame of a CUDA session (gpujpeg_tpu Decoder._words_scratch),
        # and the event recorded after the last upload from it;
        # decode_pipelined alternates it with the spare pair
        self._reuse_scratch = self.device.type == "cuda"
        self._prep_buf: Optional[np.ndarray] = None
        self._prep_event = None
        self._spare_buf: Optional[np.ndarray] = None
        self._spare_event = None
        self._output_request: Optional[ImageParameters] = None
        #: the resolved output (pseudo formats resolved against the
        #: stream) of the last stream decoded
        self.last_output: Optional[ImageParameters] = None
        #: the output options (set_option): vertical flip, channel remap,
        #: row alignment in bytes
        self.flipped = False
        self.channel_remap: Optional[str] = None
        self.alignment_bytes = 0
        self.stats = DecoderStats()
        #: fill the Huffman / IDCT splits of the stats (the reference's
        #: param.perf_stats); their events are recorded either way, so the
        #: flag costs nothing
        self.perf_stats = False

    def get_stats(self) -> DecoderStats:
        """gpujpeg_decoder_get_stats (gpujpeg_common.h:365-375)."""
        return self.stats

    def set_output_format(self, color_space, pixel_format) -> None:
        """Request the output color space and pixel format for the
        decodes that pass no param_image; either may be a pseudo value
        (ColorSpace.NONE for the default, a PixelFormatRequest), resolved
        against each stream by resolve_output
        (gpujpeg_decoder_set_output_format)."""
        self._output_request = ImageParameters(
            width=0, height=0, color_space=color_space,
            pixel_format=pixel_format)

    # -- options (gpujpeg_decoder_set_option, gpujpeg_decoder.c:485-524) ----
    def set_option(self, key: str, value: str) -> None:
        """String options, the reference's keys
        (libgpujpeg/gpujpeg_decoder.h:293-304): vertical flip, channel
        remap and row alignment of the output (_apply_output_options);
        RLE TGA output sets io.image.TGA_RLE, the writer's module global
        (process-wide, as in the JAX package); any other key raises
        ValueError."""
        if key == "dec_opt_tga_rle":
            from ..io import image as iio

            iio.TGA_RLE = value == "true"
            return
        if key == "dec_opt_flipped":
            self.flipped = value == "true"
            return
        if key == "dec_opt_channel_remap":
            if not all(c in "0123FfZz" for c in value) or not value:
                raise ValueError(f"bad channel remap {value!r}")
            self.channel_remap = value
            return
        if key == "dec_opt_alignment_bytes":
            self.alignment_bytes = int(value)
            return
        raise ValueError(f"invalid decoder option {key!r}")

    @staticmethod
    def print_options() -> str:
        """gpujpeg_decoder_print_options equivalent."""
        return (
            "\tdec_opt_tga_rle=[false|true] - RLE TGA output\n"
            "\tdec_opt_flipped=[false|true] - vertically flip output\n"
            "\tdec_opt_channel_remap=XYZ[W] - output channel mapping\n"
            "\tdec_opt_alignment_bytes=<num> - output row alignment\n")

    def get_image_info(self, data: bytes) -> ImageInfo:
        return reader.get_image_info(data)

    # -- host ------------------------------------------------------------------
    def _parse(self, data: bytes, param_image: Optional[ImageParameters]):
        """(parsed stream, output, geometry) of a stream: the output
        resolved against the stream and the session's row alignment, the
        geometry without the output's row padding (which
        _apply_output_options adds after the back half)."""
        if param_image is not None and not isinstance(param_image,
                                                      ImageParameters):
            param_image = from_reference(param_image)
        ps = reader.parse(data)
        if not ps.scans:
            raise CorruptStreamError("no scan in stream")
        param = reader.parsed_to_parameters(ps)
        out_pi = resolve_output(ps, param_image, self.alignment_bytes)
        geo = get_geometry(param, out_pi.with_(width_padding=0))
        return ps, out_pi, geo

    def _plan(self, ps: reader.ParsedStream, geo: Geometry) -> Plan:
        key = (geo, _table_key(ps))
        plan = self._plans.get(key)
        if plan is None:
            plan = _make_plan(ps, geo, self.device)
            self._plans[key] = plan
        return plan

    def prepare(self, data: bytes,
                param_image: Optional[ImageParameters] = None) -> HostFrame:
        """Host half of a decode: parse, resolve the output, look up the
        plan, unstuff the segments into the word matrix.  On a CUDA
        session the matrix lies in the session's reused buffer, so a
        HostFrame's words hold until the next prepare."""
        ps, out_pi, geo = self._parse(data, param_image)
        self.last_output = out_pi
        plan = self._plan(ps, geo)
        bounds = self._segment_bounds(ps, geo)
        max_words = (int((bounds[1] - bounds[0]).max()) + 3) // 4
        words, nbits = segprep.pack_segments_matrix(
            ps.data, bounds, max_words,
            out=self._words_scratch(len(bounds[0]), max_words + 1))
        return HostFrame(plan=plan, out_pi=out_pi, words=words.view(np.int32),
                         nbits=np.ascontiguousarray(nbits, np.int32))

    def _words_scratch(self, nseg: int, row_words: int):
        """The session's (nseg, row_words * 4) uint8 staging view for the
        segment matrix, or None for a fresh array.  A fresh matrix page-
        faults its pages inside the unstuff (the reference measured +40-90
        ms per 8K Q100 frame), so a CUDA session keeps one grow-only pinned
        buffer, rounded up to SCRATCH_STEP, and uploads from it without
        blocking; it waits for the last upload from the buffer before the
        buffer is written again.  On the CPU torch.from_numpy aliases the
        array, so each frame gets a fresh one."""
        if not self._reuse_scratch:
            return None
        if self._prep_event is not None:
            self._prep_event.synchronize()
            self._prep_event = None
        need = nseg * row_words * 4
        if self._prep_buf is None or self._prep_buf.size < need:
            self._prep_buf = None          # released before the new one
            self._prep_buf = pinned_empty(-(-need // SCRATCH_STEP)
                                          * SCRATCH_STEP)
        return self._prep_buf[:need].reshape(nseg, row_words * 4)

    def _swap_scratch(self) -> None:
        """Make the spare buffer the one the next frame is unstuffed into
        (decode_pipelined: stream i+1 is unstuffed while stream i's words
        may still be on their way to the card)."""
        self._prep_buf, self._spare_buf = self._spare_buf, self._prep_buf
        self._prep_event, self._spare_event = (self._spare_event,
                                               self._prep_event)

    def upload(self, hf: HostFrame, clock: Optional[Clock] = None):
        """(words, nbits) of a prepared frame on the session's device,
        usable on the current stream.  On CUDA the copies run on the
        session's upload stream and do not block the host; the event after
        them guards the reused buffer (_words_scratch)."""
        (words, nbits), done = self._staging.upload(
            torch.from_numpy(hf.words), torch.from_numpy(hf.nbits),
            clock=clock)
        if done is not None and self._prep_buf is not None:
            self._prep_event = done
        return words, nbits

    def _drop_scratch(self) -> None:
        """Forget the reused buffers after a failure: an upload from them
        may still be in flight, so the next frame takes a new one."""
        self._prep_buf = self._spare_buf = None
        self._prep_event = self._spare_event = None

    @staticmethod
    def _segment_bounds(ps, geo):
        """(starts, ends) int64 1-D arrays over all scans; scans whose
        segment count differs from the geometry's (recovered corrupt
        streams) are padded with empty segments or truncated."""
        expected = np.diff(geo.scan_seg_bounds)
        if len(ps.scans) != geo.scan_count:
            raise CorruptStreamError(
                f"scan count mismatch: stream has {len(ps.scans)}, "
                f"geometry expects {geo.scan_count}")
        if all(s.segment_count == int(expected[k])
               for k, s in enumerate(ps.scans)):
            if len(ps.scans) == 1:
                return ps.scans[0].segment_bounds()
            ss, es = zip(*(s.segment_bounds() for s in ps.scans))
            return np.concatenate(ss), np.concatenate(es)
        r = Decoder._segment_ranges(ps, geo)
        return np.ascontiguousarray(r[:, 0]), np.ascontiguousarray(r[:, 1])

    @staticmethod
    def _segment_ranges(ps, geo) -> np.ndarray:
        """Per-scan segment ranges padded/truncated to the geometry's
        expected counts, as one (total, 2) int64 array: missing segments
        decode as empty instead of failing the whole frame."""
        expected = np.diff(geo.scan_seg_bounds)
        ranges = []
        for k, scan in enumerate(ps.scans):
            segs = np.asarray(scan.segments, np.int64).reshape(-1, 2)
            want = int(expected[k])
            if len(segs) != want:
                log.warning("scan %d: %d segments in stream, geometry "
                            "expects %d (padding/truncating)", k,
                            len(segs), want)
                if len(segs) > want:
                    segs = segs[:want]
                else:
                    segs = np.concatenate(
                        [segs, np.zeros((want - len(segs), 2), np.int64)])
            ranges.append(segs)
        return np.concatenate(ranges) if ranges \
            else np.zeros((0, 2), np.int64)

    # -- device ----------------------------------------------------------------
    @staticmethod
    def _coefficients(plan: Plan, words: torch.Tensor, nbits: torch.Tensor):
        """Phases A and C and the DC fix-up -> (coefs_t (64, nseg*bps)
        int16, errA (nseg,) bool, errC (nseg*bps,) int32)."""
        p = plan
        bstart, err_a = huffdec_kernel.scan_segments(
            words, nbits, p.nblocks, p.dc_luma, p.ac_luma, p.tables, p.bps,
            p.pattern, p.scan_lut, sets=p.sets)
        coefs_t, err_c = huffdec_kernel.decode_blocks(
            words, bstart, p.nblocks, p.dc_luma, p.ac_luma, p.tables,
            p.pattern, p.block_lut)
        return dc_fixup(coefs_t, p), err_a, err_c

    def coefficients_t(self, hf: HostFrame):
        """Phases A and C and the DC integration on the session's device:
        -> (coefs_t (64, nseg*bps) int16, errA (nseg,) bool, errC
        (nseg*bps,) int32)."""
        words, nbits = self.upload(hf)
        return self._coefficients(hf.plan, words, nbits)

    @staticmethod
    def back_half(coefs_t: torch.Tensor, plan: Plan,
                  out_pi: ImageParameters) -> torch.Tensor:
        """DC-integrated coefficients -> the raw image of out_pi's format
        without its row padding (which _apply_output_options adds),
        shaped as sample.pack_channels shapes it: the fused dpost kernel
        where the JAX gate sends it (decode_post_supported: 3 components
        to RGB or RGBA), else one IDCT launch for every component's plane
        and the postprocessor."""
        geo = plan.geo
        pi = out_pi.with_(width_padding=0)
        if prepost_kernel.decode_post_supported(geo, pi):
            return prepost_kernel.decode_post(coefs_t, plan.qtabs, geo, pi)
        planes = prepost_kernel.idct_planes(coefs_t, plan.qtabs, geo)
        return prepost_kernel.postprocess_packed(planes, geo, pi)

    def _apply_output_options(self, out: torch.Tensor,
                              out_pi: Optional[ImageParameters] = None
                              ) -> torch.Tensor:
        """Vertical flip, channel remap (sample.flip_remap) and row padding
        of the decoded image, as torch ops on its device (gpujpeg_tpu
        Decoder._apply_output_options, XLA ops there; width_padding,
        gpujpeg_reader.c:1600-1615): width_padding bytes pad each row of
        an image of 2 or more dimensions into (H, row stride) bytes."""
        out = sample.flip_remap(out, self.flipped, self.channel_remap)
        wp = out_pi.width_padding if out_pi else 0
        if wp > 0 and out.dim() >= 2:
            out = torch.nn.functional.pad(out.reshape(out.shape[0], -1),
                                          (0, wp))
        return out

    def _pixels(self, plan: Plan, out_pi: ImageParameters,
                words: torch.Tensor, nbits: torch.Tensor,
                clock: Optional[Clock] = None, options: bool = True):
        """The device decode of uploaded words -> (the uint8 image,
        0-d bool: a segment was corrupt), queued on the current stream,
        with the session's output options applied unless options is
        False; the clock's phases "huffman" (A, C, fix-up; phase C alone
        on the direct route) and "dct" (the rest)."""
        if clock is not None:
            clock.mark("huffman")
        if plan.direct:
            coefs_t, err_c = huffdec_kernel.decode_blocks_direct(
                words, nbits, plan.nblocks, plan.dc_luma, plan.ac_luma,
                plan.tables, plan.pattern, plan.direct_lut)
            bad = err_c.any()
        else:
            coefs_t, err_a, err_c = self._coefficients(plan, words, nbits)
            bad = err_a.any() | err_c.any()
        if clock is not None:
            clock.mark("dct")
        img = self.back_half(coefs_t, plan, out_pi)
        if options:
            img = self._apply_output_options(img, out_pi)
        if clock is not None:
            clock.mark("end")
        return img, bad

    def _launch(self, hf: HostFrame) -> _Decoding:
        """Queue one prepared frame: the upload of its words and bit
        counts, its kernels, and the copy of its image and error flag to
        pinned host memory after them."""
        clock = Clock(self.device)
        words, nbits = self.upload(hf, clock)
        img, bad = self._pixels(hf.plan, hf.out_pi, words, nbits, clock)
        done = self._staging.event()
        return _Decoding(self._staging.download(img, done, clock),
                         self._staging.download(bad, done), clock)

    def _fetch(self, job: _Decoding) -> np.ndarray:
        """Wait for a launched frame's image, warn about corrupt segments
        and fill the stats."""
        img = job.image.get().numpy()
        if bool(job.bad.get()):
            log.warning("corrupt segment(s) during Huffman decode")
        st, clock = self.stats, job.clock
        st.duration_in_gpu = clock.span()
        st.duration_memory_from = clock.ms("d0", "d1")
        if self.perf_stats:
            ph = clock.phases()
            st.duration_huffman_coder = ph.get("huffman", 0.0)
            st.duration_dct_quantization = ph.get("dct", 0.0)
            st.duration_preprocessor = 0.0
        return img

    def decode_to_device(self, data: bytes,
                         param_image: Optional[ImageParameters] = None
                         ) -> torch.Tensor:
        """Decode to a uint8 tensor on the session's device, in the output
        that param_image, else set_output_format, asks for, with the
        session's output options: (H, W) for U8, (H, W, C) for the
        interleaved formats, flat (N,) for UYVY and the planar formats,
        (H, row stride) bytes when rows are padded (the JAX package's
        shapes).
        A corrupt segment is decoded as far as it goes and logged as a
        warning; the rest of the frame is unaffected.  Any exception drops
        the reused segment buffer before it propagates."""
        try:
            hf = self.prepare(data, param_image or self._output_request)
            words, nbits = self.upload(hf)
            out, bad = self._pixels(hf.plan, hf.out_pi, words, nbits)
            if bool(bad):
                log.warning("corrupt segment(s) during Huffman decode")
            return out
        except BaseException:
            self._drop_scratch()
            raise

    def decode(self, data: bytes,
               param_image: Optional[ImageParameters] = None) -> np.ndarray:
        """Decode to a uint8 numpy array of decode_to_device's shape (on
        CUDA it lies in a pinned block of PyTorch's caching host
        allocator, recycled once the array is dropped)."""
        t0 = time.perf_counter()
        try:
            hf = self.prepare(data, param_image or self._output_request)
            self.stats.duration_stream = (time.perf_counter() - t0) * 1e3
            out = self._fetch(self._launch(hf))
        except BaseException:
            self._drop_scratch()
            raise
        self.stats.add_frame((time.perf_counter() - t0) * 1e3)
        return out

    def decode_coefficients(self, data: bytes) -> List[np.ndarray]:
        """Decoded QUANTIZED DCT coefficients, per component: a list of
        (nby, nbx, 64) int16 arrays in raster block order with zig-zag
        coefficient order (gpujpeg_tpu Decoder.decode_coefficients).  A
        stream with more than two Huffman table sets raises ValueError,
        as the JAX method does (its legacy path has no coefficients)."""
        hf = self.prepare(data)
        if huffdec_kernel.table_sets(hf.plan.tables) > 2:
            raise ValueError("streams with more than 2 Huffman table sets "
                             "are not supported by decode_coefficients")
        coefs_t, _ea, _ec = self.coefficients_t(hf)
        coefs = coefs_t.T.cpu()
        geo = hf.plan.geo
        return [coefs[prepost_kernel.block_columns(geo, c)].numpy().reshape(
                    c.data_height // 8, c.data_width // 8, 64)
                for c in geo.components]

    # -- pipelines (gpujpeg_tpu Decoder.compile_stream_pipeline,
    # decode_pipelined) -------------------------------------------------------
    def pack_stream(self, data: bytes, geo: Geometry, max_words: int,
                    comp_widths=None, table_sig=None):
        """Host prep of one stream against a fixed geometry and row width:
        returns (words, nbits) numpy arrays shaped like the pipeline's
        example stream, (nseg, max_words + 1) uint32 host-order words and
        (nseg,) int32 bit counts (stream.segments.pack_segments_matrix;
        row bytes past a segment's payload are not zeroed).

        A stream of another geometry, or whose tables differ from
        table_sig (_table_signature of the example: a pipeline decodes
        with the example's tables), raises ValueError.  A segment of more
        than max_words words raises CapacityError, as does one of
        segments lo:hi of more than wc - 1 words for an entry (lo, hi, wc)
        of comp_widths (the JAX package's per-component scan widths; the
        port's kernels take any width, and checking them refuses the
        streams the JAX method refuses)."""
        return self._pack(data, geo, max_words, comp_widths, table_sig)

    def _pack(self, data: bytes, geo: Geometry, max_words: int,
              comp_widths=None, table_sig=None, scratch: bool = False):
        """pack_stream; scratch=True unstuffs into the session's reused
        buffer (_words_scratch)."""
        ps = reader.parse(data)
        param = reader.parsed_to_parameters(ps)
        out_pi = resolve_output(ps, self._output_request,
                                self.alignment_bytes)
        if get_geometry(param, out_pi.with_(width_padding=0)) != geo:
            raise ValueError("stream geometry differs from the pipeline's")
        if table_sig is not None and _table_signature(ps) != table_sig:
            raise ValueError(
                "stream quantization/Huffman tables differ from the "
                "pipeline's example stream; rebuild the pipeline from a "
                "representative stream (it decodes with the example's "
                "tables)")
        bounds = self._segment_bounds(ps, geo)
        seg_lens = bounds[1] - bounds[0]
        need = (int(seg_lens.max()) + 3) // 4
        if need > max_words:
            raise CapacityError(f"segment needs {need} words > pipeline "
                                f"row width {max_words}")
        for lo, hi, wc in comp_widths or ():
            nc = (int(seg_lens[lo:hi].max()) + 3) // 4
            if nc > wc - 1:
                raise CapacityError(
                    f"segments {lo}:{hi} need {nc} words > the pipeline's "
                    f"per-component width {wc - 1}; rebuild the pipeline "
                    "from a representative stream")
        return segprep.pack_segments_matrix(
            ps.data, bounds, max_words,
            out=self._words_scratch(len(seg_lens), max_words + 1)
            if scratch else None)

    def _stream_pipeline_parts(self, data: bytes):
        """(fn, words, nbits, geo, max_words, comp_widths, table_sig, plan,
        out_pi) of streams shaped like data (the JAX method's tuple without
        its split capacities, with the plan and the output that fn decodes
        with): fn(words, nbits) decodes uploaded words on the session's
        device; words and nbits are data's, unstuffed at max_words =
        _bucket(its longest segment's words), the row width the pipeline
        admits.  comp_widths is None: the port's kernels are not
        specialised to widths."""
        ps, out_pi, geo = self._parse(data, self._output_request)
        self.last_output = out_pi
        plan = self._plan(ps, geo)
        bounds = self._segment_bounds(ps, geo)
        max_words = _bucket((int((bounds[1] - bounds[0]).max()) + 3) // 4)
        words, nbits = segprep.pack_segments_matrix(ps.data, bounds,
                                                    max_words)

        def fn(words: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
            """(nseg, max_words + 1) int32 words and (nseg,) int32 bit
            counts on the device -> the uint8 image there, without the
            output options (as the JAX method's): phases A and C and the
            DC fix-up (phase C alone on the direct route), dpost or the
            IDCT planes and the postprocessor, queued on the current
            stream."""
            return self._pixels(plan, out_pi, words, nbits,
                                options=False)[0]

        return (fn, words, np.ascontiguousarray(nbits, np.int32), geo,
                max_words, None, _table_signature(ps), plan, out_pi)

    def compile_stream_pipeline(self, data: bytes):
        """One device function for streams shaped like data: returns (fn,
        words, nbits) with fn(words, nbits) -> the decoded uint8 image on
        the session's device (no flip, remap or row padding, as the JAX
        method's), and data's words (int32) and bit
        counts already there.  fn runs the device decode alone (phases A
        and C and the DC fix-up, or phase C alone on the direct route;
        dpost or IDCT + postprocessor), with no host
        work and no synchronisation; the port has no compile step, so
        fn's plan and lookahead tables are built here."""
        fn, words, nbits = self._stream_pipeline_parts(data)[:3]
        return (fn, torch.from_numpy(words.view(np.int32)).to(self.device),
                torch.from_numpy(nbits).to(self.device))

    def warmup(self, example: bytes) -> None:
        """Make everything streams shaped like example need before the
        first one (the pre-init role of gpujpeg_decoder_init): the plan
        and its lookahead tables, the kernels' libraries (built from csrc/
        when missing, then loaded), the reused pinned segment buffer and a
        pinned image block, by decoding example once.  The stats are left
        as they were."""
        stats, self.stats = self.stats, DecoderStats()
        try:
            self.decode(example)
        finally:
            self.stats = stats

    def decode_pipelined(self, streams):
        """Double-buffered decode of a stream sequence: yields one decoded
        uint8 numpy image per stream, each equal to sequential decode()'s
        (gpujpeg_tpu Decoder.decode_pipelined), output options and all.

        While stream i's kernels run, the host parses and unstuffs stream
        i+1 into the other of two reused pinned word buffers, and stream
        i's image goes to a fresh pinned block on the download stream.
        The first stream fixes the geometry, the row width (_bucket of its
        longest segment) and the tables; a later stream of another
        geometry or other tables raises ValueError (pack_stream), one with
        a wider segment (CapacityError) is decoded by decode() in its
        turn.  Each yielded array is the caller's own: no later frame
        writes it."""
        it = iter(streams)
        first = next(it, None)
        if first is None:
            return
        (_fn, words, nbits, geo, max_words, comp_widths, table_sig, plan,
         out_pi) = self._stream_pipeline_parts(first)
        prev = self._launch(HostFrame(plan, out_pi, words.view(np.int32),
                                      nbits))
        try:
            for s in it:
                self._swap_scratch()
                try:
                    w, n = self._pack(s, geo, max_words, comp_widths,
                                      table_sig, scratch=True)
                except CapacityError:
                    if prev is not None:
                        yield self._fetch(prev)
                        prev = None
                    yield self.decode(s)
                    continue
                job = self._launch(HostFrame(
                    plan, out_pi, w.view(np.int32),
                    np.ascontiguousarray(n, np.int32)))
                if prev is not None:
                    yield self._fetch(prev)
                prev = job
            if prev is not None:
                yield self._fetch(prev)
        except BaseException:
            self._drop_scratch()
            raise
