"""Decoder session of the PyTorch port (gpujpeg_tpu.models.decoder).

The decode of one codestream:

    host: parse markers, split and unstuff the restart segments into a
          (segments, words) matrix                stream/reader, segments
    device:
      phase A, block boundaries of each segment   huffdec_kernel.scan_segments
      phase C, coefficients of each block         huffdec_kernel.decode_blocks
      differential DC -> absolute, per component  _dc_fixup_t (torch cumsum)
    then, for non-interleaved scans whose chroma planes tile the luma plane
    at dx, dy in {1, 2} (prepost_kernel.decode_post_supported):
      dequantization + IDCT + upsampling + colour
      + store                                     prepost_kernel.decode_post
    or, for an interleaved scan and any other stream:
      dequantization + IDCT, a plane per
      component, one launch                       prepost_kernel.idct_planes
      upsampling + colour + store                 prepost_kernel.
                                                  postprocess_packed

On CUDA every stage but the DC integration is a hand-written kernel; with
device="cpu" every stage runs its plain PyTorch version.  The pixels are
the same either way and equal the JAX package's.  Phase C decodes each
block straight out of its segment's row (the segment-row contract), so
the JAX package's phase B (the split into per-block buffers) and its
capacity protocol do not exist here.  In an interleaved scan a segment row
holds whole MCUs; the two Huffman phases take each block's table class
from the slot pattern of the MCU (Plan.pattern).

This slice decodes baseline streams of 3 components to P444_U8_P012,
with chroma at 1x1 and luma at 1x1, 2x1, 1x2 or 2x2, in non-interleaved
scans or in one interleaved scan: the streams libjpeg, PIL and cameras
write as well as the JAX package's.  Any baseline Huffman tables (the
tuned family, Annex K, optimised ones) go through the same kernels, fed
the stream's canonical tables and their lookahead tables; up to two
table sets a class take the kernels' two-set instances, three or four
their four-set instances (huffdec_kernel's module docstring), which the
JAX package decodes on its legacy path.  A restart interval of 0 makes
each scan one segment: one thread of phase A walks it, phase C decodes
its blocks in parallel from phase A's cursors.  Everything else raises
NotImplementedError naming the ROADMAP item (queue 1) that ports it.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import huffdec_kernel, prepost_kernel
from ..stream import reader, segments as segprep
from ..types import (ColorSpace, CorruptStreamError, ImageInfo,
                     ImageParameters, PixelFormat, PixelFormatRequest,
                     YCBCR_JPEG, from_reference, pixel_format_unit_size)
from ..utils.geometry import Geometry, get_geometry
from .encoder import not_ported

log = logging.getLogger("gpujpeg_tpu_torch")

#: the reused segment-matrix buffer grows in steps of this many bytes
SCRATCH_STEP = 1 << 20


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


def check_supported(ps: reader.ParsedStream, geo: Geometry,
                    out_pi: ImageParameters) -> None:
    """Raise NotImplementedError for a stream or an output outside this
    slice, naming every ROADMAP item (queue 1) it needs."""
    missing = []
    samp = [tuple(s) for s in ps.sampling]
    if ps.comp_count != 3:
        missing.append(f"{ps.comp_count} components (only 3 are ported; "
                       "item 6)")
    elif samp[1:] != [(1, 1)] * 2 or samp[0] not in (
            (1, 1), (2, 1), (1, 2), (2, 2)):
        scans = ("an interleaved scan" if geo.interleaved
                 else "non-interleaved scans")
        missing.append(
            f"{scans} with sampling {samp} (only chroma at 1x1 and luma at "
            "1x1, 2x1, 1x2 or 2x2 are ported; item 6)")
    if (out_pi.pixel_format != PixelFormat.P444_U8_P012
            or out_pi.width_padding):
        missing.append(
            f"output {out_pi.pixel_format.name}"
            f"{' with width_padding' if out_pi.width_padding else ''} "
            "(only P444_U8_P012 is ported; item 6)")
    if missing:
        raise NotImplementedError(
            "not ported yet (ROADMAP queue 1): " + "; ".join(missing))


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


def _make_plan(ps: reader.ParsedStream, geo: Geometry, device) -> Plan:
    """The plan of a stream: any baseline DHT tables (the canonical decode
    takes them all), two table sets where the scans use at most two ids a
    class, four (T.81's ids 0-3) otherwise (huffdec_kernel's module
    docstring)."""
    comp_dc, comp_ac, dc_ids, ac_ids = _table_ids(ps, geo.comp_count)
    nsets = 2 if len(dc_ids) <= 2 and len(ac_ids) <= 2 else 4

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
                    comp_slots=comp_slots)
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
                         else huffdec_kernel.NO_PATTERN_WIDE))


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


class Decoder:
    """Persistent decoder session (create once, decode many streams).

    device: None runs on the current CUDA device and raises when there is
    none; "cpu" runs the plain PyTorch versions of the kernels."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._plans: Dict[tuple, Plan] = {}
        # grow-only pinned buffer of the segment matrix, reused by every
        # frame of a CUDA session (gpujpeg_tpu Decoder._words_scratch),
        # and the event recorded after the last upload from it
        self._reuse_scratch = self.device.type == "cuda"
        self._prep_buf: Optional[np.ndarray] = None
        self._prep_event = None
        self._output_request: Optional[ImageParameters] = None

    def get_stats(self):
        """The session's DecoderStats: not ported yet."""
        not_ported("Decoder.get_stats")

    def set_output_format(self, color_space, pixel_format) -> None:
        """Request the output color space and pixel format for the
        decodes that pass no param_image; either may be a pseudo value
        (ColorSpace.NONE for the default, a PixelFormatRequest), resolved
        against each stream by resolve_output
        (gpujpeg_decoder_set_output_format).  A request that resolves to
        anything but P444_U8_P012 raises at decode time (item 6)."""
        self._output_request = ImageParameters(
            width=0, height=0, color_space=color_space,
            pixel_format=pixel_format)

    @staticmethod
    def print_options() -> str:
        """gpujpeg_decoder_print_options: not ported yet."""
        not_ported("Decoder.print_options")

    def compile_stream_pipeline(self, data: bytes):
        """One device function for streams shaped like data: not ported
        yet."""
        not_ported("Decoder.compile_stream_pipeline")

    def warmup(self, example: bytes) -> None:
        """Pre-build for streams shaped like example: not ported yet."""
        not_ported("Decoder.warmup")

    def decode_pipelined(self, streams):
        """Double-buffered decode of a stream sequence: not ported yet."""
        not_ported("Decoder.decode_pipelined")

    def pack_stream(self, data: bytes, geo: Geometry, max_words: int,
                    comp_widths=None, table_sig=None):
        """Host prep of one stream against a fixed geometry: not ported
        yet."""
        not_ported("Decoder.pack_stream")

    def set_option(self, key: str, value: str) -> None:
        """Reference-compatible string options (gpujpeg_decoder.c:485-524)
        are not ported yet."""
        item = 6 if key in ("dec_opt_flipped", "dec_opt_channel_remap",
                            "dec_opt_alignment_bytes") else 10
        raise NotImplementedError(f"decoder option {key!r} is not ported "
                                  f"(ROADMAP queue 1 item {item})")

    def get_image_info(self, data: bytes) -> ImageInfo:
        return reader.get_image_info(data)

    # -- host ------------------------------------------------------------------
    def prepare(self, data: bytes,
                param_image: Optional[ImageParameters] = None) -> HostFrame:
        """Host half of a decode: parse, check the slice's limits, look up
        the plan, unstuff the segments into the word matrix.  On a CUDA
        session the matrix lies in the session's reused buffer, so a
        HostFrame's words hold until the next prepare."""
        if param_image is not None and not isinstance(param_image,
                                                      ImageParameters):
            param_image = from_reference(param_image)
        ps = reader.parse(data)
        if not ps.scans:
            raise CorruptStreamError("no scan in stream")
        param = reader.parsed_to_parameters(ps)
        out_pi = resolve_output(ps, param_image)
        geo = get_geometry(param, out_pi.with_(width_padding=0))
        check_supported(ps, geo, out_pi)
        key = (geo, _table_key(ps))
        plan = self._plans.get(key)
        if plan is None:
            plan = _make_plan(ps, geo, self.device)
            self._plans[key] = plan
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

    def upload(self, hf: HostFrame):
        """(words, nbits) of a prepared frame on the session's device.  On
        CUDA the copies do not block the host; an event after them guards
        the reused buffer (_words_scratch)."""
        nb = self.device.type == "cuda"
        words = torch.from_numpy(hf.words).to(self.device, non_blocking=nb)
        nbits = torch.from_numpy(hf.nbits).to(self.device, non_blocking=nb)
        if nb and self._prep_buf is not None:
            self._prep_event = torch.cuda.Event()
            self._prep_event.record(torch.cuda.current_stream(self.device))
        return words, nbits

    def _drop_scratch(self) -> None:
        """Forget the reused buffer after a failure: an upload from it may
        still be in flight, so the next frame takes a new one."""
        self._prep_buf = None
        self._prep_event = None

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
    def coefficients_t(self, hf: HostFrame):
        """Phases A and C and the DC integration on the session's device:
        -> (coefs_t (64, nseg*bps) int16, errA (nseg,) bool, errC
        (nseg*bps,) int32)."""
        p = hf.plan
        words, nbits = self.upload(hf)
        bstart, err_a = huffdec_kernel.scan_segments(
            words, nbits, p.nblocks, p.dc_luma, p.ac_luma, p.tables, p.bps,
            p.pattern, p.scan_lut)
        coefs_t, err_c = huffdec_kernel.decode_blocks(
            words, bstart, p.nblocks, p.dc_luma, p.ac_luma, p.tables,
            p.pattern, p.block_lut)
        return (_dc_fixup_t(coefs_t, words.shape[0], p.bps, p.comp_slots),
                err_a, err_c)

    @staticmethod
    def back_half(coefs_t: torch.Tensor, plan: Plan,
                  out_pi: ImageParameters) -> torch.Tensor:
        """DC-integrated coefficients -> (H, W, 3) uint8 pixels: the fused
        dpost kernel where it applies (decode_post_supported), else one
        IDCT launch for every component's plane and the postprocessor."""
        geo = plan.geo
        if prepost_kernel.decode_post_supported(geo, out_pi):
            return prepost_kernel.decode_post(coefs_t, plan.qtabs, geo,
                                              out_pi)
        planes = prepost_kernel.idct_planes(coefs_t, plan.qtabs, geo)
        return prepost_kernel.postprocess_packed(planes, geo, out_pi)

    def decode_to_device(self, data: bytes,
                         param_image: Optional[ImageParameters] = None
                         ) -> torch.Tensor:
        """Decode to an (H, W, 3) uint8 tensor on the session's device,
        in the output that param_image, else set_output_format, asks for.
        A corrupt segment is decoded as far as it goes and logged as a
        warning; the rest of the frame is unaffected.  Any exception drops
        the reused segment buffer before it propagates."""
        try:
            hf = self.prepare(data, param_image or self._output_request)
            coefs_t, err_a, err_c = self.coefficients_t(hf)
            out = self.back_half(coefs_t, hf.plan, hf.out_pi)
            if bool(err_a.any()) or bool(err_c.any()):
                log.warning("corrupt segment(s) during Huffman decode")
            return out
        except BaseException:
            self._drop_scratch()
            raise

    def decode(self, data: bytes,
               param_image: Optional[ImageParameters] = None) -> np.ndarray:
        """Decode to an (H, W, 3) uint8 numpy array."""
        try:
            return self.decode_to_device(data, param_image).cpu().numpy()
        except BaseException:
            self._drop_scratch()
            raise

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
