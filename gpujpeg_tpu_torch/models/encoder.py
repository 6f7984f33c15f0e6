"""Encoder session of the PyTorch port (gpujpeg_tpu.models.encoder).

The device pipeline follows the JAX package's megakernel dispatch
(gpujpeg_tpu.models.encoder.make_full_encode_fn).  For non-interleaved
scans, per component (any decimation of the chroma planes):

    preprocess (colour, decimation)   ops/prepost_kernel.preprocess_packed
    per component:
      forward DCT + quantization      ops/fusedpack.fdct_quant
      Huffman coding of segment rows  ops/fusedpack.huffman_segments

and for an interleaved scan (the megakernel's interleaved mode, which the
JAX package runs at 1x1 sampling and sends subsampled scans to XLA
tokens and its deep-stuff kernel), one scan at any of the sampling
layouts below:

    preprocess (colour, decimation)   ops/prepost_kernel.preprocess_packed
    per component:
      forward DCT + quantization,
      stored in MCU stream order      ops/fusedpack.interleaved_rows
    Huffman coding, slot patterns     ops/fusedpack.huffman_segments

then host assembly: headers (stream/writer.py) and the rows of each scan,
cut to their byte counts (native.assemble_rows).  With Annex-K tables
(huffman_tables="annexk") the Huffman step is the JAX package's
non-megakernel route instead, in both layouts:

    tokens of the segment rows        ops/fusedpack.rows_tokens (torch)
    stuffed byte rows                 ops/fusedpack.pack_stuff_rows

and a restart interval of 0 (each scan one segment) takes the JAX
package's host-entropy route (_encode_host_entropy) with either table
family: the preprocessor and the DCT on the device, the tokens of each
scan there too (ops/fusedpack.scan_tokens), then the headers and each
scan's tokens packed on the host (native.pack_tokens).  encode_to_device
packs each such scan on the device instead, into one row of one segment
(ops/fusedpack.scan_rows: the token-row packer's scan instance, chunks of
the scan a CTA), which assemble turns into the same bytes.  On CUDA every
stage but the tokenizer (XLA in the JAX package, torch ops here) is a
hand-written kernel (the DCT kernel stores an interleaved scan's MCU
order itself); with device="cpu" every stage runs its plain PyTorch
version.  The bytes are the same either way and equal the JAX
package's.

The session surface is the JAX package's: a host frame reaches the card
through pinned staging on an upload stream, the rows come back on a
download stream (models/staging.py), and encode_pipelined queues frame
i+1's upload and kernels before frame i's rows are copied back and
assembled, with the bytes of sequential encode().  get_stats() gives the
last frame's DurationStats from CUDA events read when its rows are
fetched (the phase splits under perf_stats), aggregate the running
averages of encode(); set_option takes the header, orientation, EXIF
and output-buffer keys; allocate encodes a zero frame to make the
tables, kernels and staging ready; estimate_memory, max_pixels and
max_memory reckon the port's own device buffers (frame_bytes).

The encoder takes every input pixel format of the JAX package: U8 (an
(H, W) array), P444_U8_P012 and P4444_U8_P0123 ((H, W, 3) and (H, W, 4)
arrays, or flat buffers with rows padded by width_padding bytes), UYVY
(P422_U8_P1020, flat, even widths) and the three planar formats (flat,
libyuv plane sizes); 1 to 4 components (comp_count 1 encodes channel 0,
unconverted, as the JAX package does; a 4th component is the raw 4th
channel); every sampling the JAX package encodes, in non-interleaved
scans or in one interleaved scan of up to 16 blocks an MCU (4:4:4 to
4:2:0, 4:1:1, subsampled chroma such as ((2, 2), (2, 1), (2, 1)), four
components); the tuned and the Annex-K Huffman tables; any restart
interval (auto picks 8 blocks a segment up to Q92).  The options
enc_opt_flipped and enc_opt_channel_remap flip and remap the frame on
its device before the preprocessor (sample.flip_remap, torch ops, as
they are XLA ops in the JAX package); the preprocessor kernel then reads
the result.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..ops import fusedpack, prepost_kernel, sample
from ..stream import writer as jwriter
from ..types import (ColorSpace, HeaderType, ImageParameters, Orientation,
                     Parameters, PixelFormat, RESTART_AUTO, image_size_bytes,
                     pixel_format_comp_count, pixel_format_sampling)
from ..utils.geometry import Geometry, get_geometry, suggest_restart_interval
from .staging import Clock, Staging


def adjust_params(param: Parameters, pi: ImageParameters) -> Parameters:
    """Resolve auto values (comp count, sampling, restart interval)
    (gpujpeg_encoder.c:319-348)."""
    if param.comp_count == 0:
        n = min(pixel_format_comp_count(pi.pixel_format), 3) \
            if pi.pixel_format != PixelFormat.P4444_U8_P0123 else 4
        samp = pixel_format_sampling(pi.pixel_format)
        param = param.chroma_subsampled(samp[:n])
    if param.restart_interval == RESTART_AUTO:
        sf = param.sampling_factor[: param.comp_count]
        subsampled = any(s.horizontal != sf[0].horizontal
                         or s.vertical != sf[0].vertical for s in sf)
        bpm = sum(s.horizontal * s.vertical for s in sf)
        param = param.with_(restart_interval=suggest_restart_interval(
            pi, param.comp_count, subsampled, param.interleaved, bpm,
            param.quality))
    if param.comp_count == 1:
        # grayscale always luminance; internal color space irrelevant
        param = param.with_(interleaved=False)
    return param


def check_tables(geo: Geometry) -> None:
    """Raise ValueError for a Huffman table family the encoder does not
    know."""
    if geo.param.huffman_tables not in ("tuned", "annexk"):
        raise ValueError(f"huffman_tables={geo.param.huffman_tables!r}: "
                         "the families are 'tuned' and 'annexk'")


def frame_shape(pi: ImageParameters) -> Tuple[int, ...]:
    """The shape of a raw frame of pi as the encoder takes it (the JAX
    Encoder.allocate's): (H, W) for U8, (H, W, 3) or (H, W, 4) for the
    interleaved formats, flat for UYVY and the planar formats."""
    pf, h, w = pi.pixel_format, pi.height, pi.width
    if pf == PixelFormat.U8:
        return (h, w)
    if pf == PixelFormat.P444_U8_P012:
        return (h, w, 3)
    if pf == PixelFormat.P4444_U8_P0123:
        return (h, w, 4)
    return (image_size_bytes(w, h, pf),)


@dataclasses.dataclass
class DurationStats:
    """Per-phase timings of the last frame (gpujpeg_duration_stats,
    gpujpeg_common.h:365-375), the fields and labels of the JAX package's.

    On CUDA the device phases come from CUDA events recorded around the
    stages and read when the frame's rows are fetched, so they add no
    synchronisation: duration_memory_to is the upload of the frame,
    duration_in_gpu the kernels from the preprocessor to the end of the
    Huffman coder, duration_memory_from the copy of the rows back.  The
    splits preprocessor / DCT / Huffman are filled under
    Encoder.perf_stats.  duration_stream is the host assembly.  On the CPU
    the host's clock times the same stages.  retries stays 0: the rows
    have worst-case strides, so no frame is coded twice."""

    duration_memory_to: float = 0.0
    duration_memory_from: float = 0.0
    duration_preprocessor: float = 0.0
    duration_dct_quantization: float = 0.0
    duration_huffman_coder: float = 0.0
    duration_stream: float = 0.0
    duration_in_gpu: float = 0.0
    retries: int = 0

    def print(self, file=None) -> None:
        f = file or sys.stderr
        if self.duration_preprocessor or self.duration_dct_quantization \
                or self.duration_huffman_coder:
            print(f" -Preprocessing:     "
                  f"{self.duration_preprocessor:10.4f} ms", file=f)
            print(f" -DCT & Quantization:"
                  f"{self.duration_dct_quantization:10.4f} ms", file=f)
            print(f" -Huffman Encoder:   "
                  f"{self.duration_huffman_coder:10.4f} ms", file=f)
        print(f" -Device pipeline:   {self.duration_in_gpu:10.4f} ms",
              file=f)
        print(f" -Stream Formatter:  {self.duration_stream:10.4f} ms",
              file=f)
        if self.duration_memory_from:
            print(f" -Copy From Device:  "
                  f"{self.duration_memory_from:10.4f} ms", file=f)
        if self.retries:
            print(f" -Capacity regrows:  {self.retries:10d}", file=f)


@dataclasses.dataclass
class AggregateStats:
    """Running averages of Encoder.encode's frames
    (gpujpeg_common.c:2238-2254)."""

    frames: int = 0
    total_ms: float = 0.0
    total_ms_wo_first: float = 0.0

    def add(self, ms: float) -> None:
        self.frames += 1
        self.total_ms += ms
        if self.frames > 1:
            self.total_ms_wo_first += ms

    def summary(self) -> str:
        if not self.frames:
            return "no frames"
        avg = self.total_ms / self.frames
        s = f"avg {avg:.2f} ms / frame ({self.frames} frames)"
        if self.frames > 1:
            s += (f"; {self.total_ms_wo_first / (self.frames - 1):.2f} ms"
                  " without first")
        return s


#: device bytes of a frame's encode that do not scale with the image: the
#: table classes, the row markers and counts, and the caching allocator's
#: rounding (a large block is handed out whole when less than 1 MiB of it
#: would be left)
FIXED_BYTES = 32 << 20

#: device bytes a slot of a tokenizer chunk takes for its temporaries
#: (fusedpack.TOKEN_CHUNK_SLOTS): about 90 at the peak of an 8K Annex-K
#: encode (chip_smoke.py's [session] step, H100 80GB HBM3 at 700 W),
#: with room
TOKEN_SLOT_BYTES = 128

#: the image the planners take their bytes a pixel from: 8K, whole MCUs of
#: every layout and whole segments of 8 blocks
PLAN_WIDTH, PLAN_HEIGHT = 7680, 4320


def frame_bytes(geo: Geometry) -> int:
    """Device bytes at the peak of one frame's encode of this geometry,
    from the port's own buffers, the largest of three moments: the raw
    frame and the planes (the preprocessor); the planes, the largest
    coefficient array alive at once (one component's in non-interleaved
    scans, the whole scan's when interleaved) and every scan's rows at
    their worst-case stride (fusedpack.bits_stride), with Annex-K tables
    also the int32 tokens of those coefficients and a tokenizer chunk's
    temporaries (the coders); every scan's rows and one more scan's, the
    contiguous copy assembly slices them into (the copy back).  The raw
    frame is image_size_bytes of its format plus its rows' padding; the
    frame-sized copy that a flip or a channel remap makes is not counted
    (the planners know no session's options).  At
    restart interval 0: the planes, the coefficients twice (scan_tokens'
    rows), the tokens kept twice (the pieces and their concatenation) and
    a chunk.  Pinned staging lies in host memory and counts nothing
    here."""
    p = geo.param
    bits = [fusedpack.block_bits(p.quality, luma, p.huffman_tables)
            for luma in (True, False)]
    pi = geo.param_image
    raw = image_size_bytes(pi.width, pi.height, pi.pixel_format) \
        + pi.height * pi.width_padding
    planes = sum(c.data_width * c.data_height for c in geo.components)
    if geo.interleaved:
        slots = [geo.segment_count * geo.segment_mcu_count
                 * geo.blocks_per_mcu]
        mcu_bits = sum(bits[c.table_index] * c.samp_h * c.samp_v
                       for c in geo.components)
        rows = [geo.segment_count * fusedpack.bits_stride(
            geo.segment_mcu_count * mcu_bits)]
        nseg = geo.segment_count
    else:
        slots = [c.segment_count * c.segment_mcu_count
                 for c in geo.components]
        rows = [c.segment_count * fusedpack.bits_stride(
            c.segment_mcu_count * bits[c.table_index])
            for c in geo.components]
        nseg = sum(c.segment_count for c in geo.components)
    coefs = 128 * max(slots)
    chunk = fusedpack.TOKEN_CHUNK_SLOTS * TOKEN_SLOT_BYTES
    if p.restart_interval == 0:
        coders = planes + 2 * coefs + 2 * 8 * 64 * max(slots) + chunk
        return max(raw + planes, coders) + FIXED_BYTES
    tokens = 8 * 64 * max(slots) + chunk \
        if p.huffman_tables == "annexk" else 0
    return (max(raw + planes, planes + coefs + tokens + sum(rows),
                sum(rows) + max(rows)) + 16 * nseg + FIXED_BYTES)


def _plan_rate(param: Parameters) -> Fraction:
    """Device bytes a pixel of the planners (frame_bytes of PLAN_WIDTH x
    PLAN_HEIGHT less FIXED_BYTES, a pixel)."""
    pi = ImageParameters(width=PLAN_WIDTH, height=PLAN_HEIGHT,
                         color_space=ColorSpace.RGB,
                         pixel_format=PixelFormat.P444_U8_P012)
    return Fraction(Encoder.estimate_memory(param, pi) - FIXED_BYTES,
                    PLAN_WIDTH * PLAN_HEIGHT)


def pack_scans(header: bytes, geo: Geometry, scans) -> bytes:
    """A restart-0 stream: the header, then each scan's header and its
    host tokens [(bits, lens)] packed in sequence (native.pack_tokens)."""
    out = bytearray(header)
    for k, (bits, lens) in enumerate(scans):
        out += jwriter.write_scan_header(geo, k)
        out += native.pack_tokens(bits, lens)
    out += b"\xff\xd9"
    return bytes(out)


def _as_tensor(image) -> torch.Tensor:
    return image if isinstance(image, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(image))


def _frame_shape(image) -> Tuple[Tuple[int, ...], str]:
    """(shape, dtype name) of a numpy array or a tensor."""
    return tuple(image.shape), str(image.dtype).replace("torch.", "")


class Encoder:
    """Persistent encoder session (create once, encode many frames).

    device: None runs on the current CUDA device and raises when there is
    none; "cpu" runs the plain PyTorch versions of the kernels."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._tables: Dict[Tuple[int, bool, str],
                           fusedpack.ClassTables] = {}
        self._staging = Staging(self.device)
        self.stats = DurationStats()
        self.aggregate = AggregateStats()
        #: fill the preprocessor / DCT / Huffman splits of the stats (the
        #: reference's param.perf_stats); their events are recorded either
        #: way, so the flag costs nothing
        self.perf_stats = False
        self.header_type_override: Optional[HeaderType] = None
        self.exif_tags: List[str] = []
        self.orientation: Optional[Orientation] = None
        self.flipped = False
        self.channel_remap: Optional[str] = None

    # -- options (gpujpeg_encoder_set_option, gpujpeg_encoder.c:736-795) -----
    def set_option(self, key: str, value: str) -> None:
        """String options, the reference's keys
        (libgpujpeg/gpujpeg_encoder.h:211-242)."""
        if key in ("enc_opt_out", "enc_out_pinned"):
            # the rows always come back through pinned staging
            return
        if key == "enc_hdr":
            m = {"JFIF": HeaderType.JFIF, "Exif": HeaderType.EXIF,
                 "Adobe": HeaderType.ADOBE, "SPIFF": HeaderType.SPIFF}
            if value not in m:
                raise ValueError(f"unknown header type {value!r}")
            self.header_type_override = m[value]
            return
        if key == "enc_opt_flipped":
            self.flipped = value == "true"
            return
        if key == "enc_opt_channel_remap":
            if not all(c in "0123FfZz" for c in value) or not value:
                raise ValueError(f"bad channel remap {value!r}")
            self.channel_remap = value
            return
        if key == "enc_exif_tag":
            self.header_type_override = HeaderType.EXIF
            self.exif_tags.append(value)
            return
        if key == "enc_metadata":
            if value.startswith("orientation="):
                # "orientation=<rot>[,flip]"
                parts = value.split("=", 1)[1].split(",")
                self.orientation = Orientation(
                    rotation=int(parts[0]) & 3,
                    flip=len(parts) > 1 and parts[1] == "flip")
                return
            raise ValueError(f"unknown metadata {value!r}")
        raise ValueError(f"invalid encoder option {key!r}")

    @staticmethod
    def print_options() -> str:
        """gpujpeg_encoder_print_options equivalent."""
        return (
            "\tenc_opt_out=[enc_out_val_pageable|enc_out_val_pinned] - "
            "accepted for compatibility (the rows always come back through "
            "pinned host buffers)\n"
            "\tenc_hdr=[JFIF|Adobe|Exif|SPIFF] - output JPEG header\n"
            "\tenc_opt_flipped=[false|true] - vertically flip input\n"
            "\tenc_opt_channel_remap=XYZ[W] - input channel mapping, eg. "
            "'210F' for GBRX; 'F'/'Z' = all-ones/all-zeros\n"
            "\tenc_exif_tag=<key>:TYPE=<value> - custom EXIF tag\n"
            "\tenc_metadata=orientation=<rot>[,flip] - image metadata\n")

    def _header(self, geo: Geometry) -> bytes:
        return jwriter.write_header(
            geo, orientation=self.orientation,
            exif_tags=self.exif_tags or None,
            header_type=self.header_type_override)

    # -- pre-allocation and planners (gpujpeg_encoder_allocate,
    # gpujpeg_encoder.c:258-288; gpujpeg_encoder.h:132-146) ------------------
    def allocate(self, param: Parameters,
                 param_image: ImageParameters) -> None:
        """Make everything a frame of (param, param_image) needs before the
        first one: the table classes, the kernels' libraries (built from
        csrc/ when missing, then loaded) and the staging buffers, by
        encoding one zero frame, whose bytes are dropped.  Each kernel's
        launch configuration follows from the shapes, so the first real
        frame runs as every later one."""
        param = adjust_params(param or Parameters(), param_image)
        geo = get_geometry(param, param_image)
        check_tables(geo)
        zeros = np.zeros(frame_shape(param_image), np.uint8)
        if param.restart_interval == 0:
            self._encode_host_entropy(zeros, geo)
        else:
            self.assemble(geo, self._device_rows(zeros, geo))

    @staticmethod
    def estimate_memory(param: Parameters,
                        param_image: ImageParameters) -> int:
        """Device bytes at the peak of one frame's encode (frame_bytes: the
        port's own buffers, rows at their worst-case stride), without the
        copy a flip or remap makes (a static method knows no session's
        options).  encode_pipelined holds one more frame's rows while the
        next frame runs."""
        param = adjust_params(param or Parameters(), param_image)
        geo = get_geometry(param, param_image)
        check_tables(geo)
        return frame_bytes(geo)

    @staticmethod
    def max_pixels(param: Parameters, memory_bytes: int) -> int:
        """Largest pixel count whose encode fits in memory_bytes
        (gpujpeg_encoder_max_pixels, gpujpeg_encoder.h:132-138), at the
        bytes a pixel of an 8K frame (_plan_rate); max_memory's
        inverse."""
        rate = _plan_rate(param)
        return max(0, math.floor((memory_bytes - FIXED_BYTES) / rate))

    @staticmethod
    def max_memory(param: Parameters, pixels: int) -> int:
        """Device bytes needed to encode `pixels` pixels
        (gpujpeg_encoder_max_memory, gpujpeg_encoder.h:140-146), at the
        bytes a pixel of an 8K frame (_plan_rate)."""
        return FIXED_BYTES + math.ceil(pixels * _plan_rate(param))

    def get_stats(self) -> DurationStats:
        return self.stats

    # -- tables --------------------------------------------------------------
    def class_tables(self, quality: int, luma: bool,
                     family: str = "tuned") -> fusedpack.ClassTables:
        key = (quality, luma, family)
        tabs = self._tables.get(key)
        if tabs is None:
            tabs = fusedpack.class_tables(quality, luma, self.device,
                                          family)
            self._tables[key] = tabs
        return tabs

    def classes(self, quality: int, family: str = "tuned"
                ) -> Tuple[fusedpack.ClassTables, fusedpack.ClassTables]:
        """The (luma, chroma) table classes at this quality and of this
        AC code family: component c takes classes[c.table_index]."""
        return (self.class_tables(quality, True, family),
                self.class_tables(quality, False, family))

    def resolve(self, image, param: Optional[Parameters] = None,
                param_image: Optional[ImageParameters] = None) -> Geometry:
        if param_image is None:
            if image.ndim < 2:
                raise ValueError("param_image required for flat buffers")
            h, w = image.shape[:2]
            ncomp = image.shape[2] if image.ndim == 3 else 1
            pf = {1: PixelFormat.U8, 3: PixelFormat.P444_U8_P012,
                  4: PixelFormat.P4444_U8_P0123}[ncomp]
            cs = ColorSpace.RGB if ncomp >= 3 else ColorSpace.NONE
            param_image = ImageParameters(width=w, height=h, color_space=cs,
                                          pixel_format=pf)
        param = adjust_params(param or Parameters(), param_image)
        return get_geometry(param, param_image)

    # -- device ----------------------------------------------------------------
    def encode_to_device(self, image, param: Optional[Parameters] = None,
                         param_image: Optional[ImageParameters] = None,
                         check: bool = True):
        """Device-side encode.  Returns (geo, res, meta): res["rows"] holds
        one (segments, stride) uint8 tensor per scan (one for an
        interleaved scan) and res["row_bytes"] one (segments,) int32 tensor
        per scan, still on the device; the rest of res is the frame's
        clock, its row counts in one tensor and the event after its
        kernels, which assemble reads.  meta is those row counts (the
        (segments,) int32 tensor res["rb"], on the device), or None under
        check=False, as the JAX method's meta is None there; assemble
        takes it and does not read it.  The work is queued, not waited
        for.  The rows have a worst-case stride, so there is no overflow
        readback for check to skip.  Annex-K tables code through tokens
        and the token-row packer (fusedpack.entropy_tokens).  At restart
        interval 0 each scan is one row of one segment with no marker
        after it (fusedpack.scan_tokens, then the token-row packer's scan
        instance, fusedpack.scan_rows), which assemble turns into
        encode()'s bytes; encode itself packs such scans on the host
        (_encode_host_entropy)."""
        geo = self.resolve(image, param, param_image)
        check_tables(geo)
        res = self._device_rows(image, geo)
        return geo, res, (res["rb"] if check else None)

    def _scan_coefs(self, planes, geo: Geometry, classes,
                    clock: Optional[Clock] = None):
        """Each scan's (coefficient rows, real blocks, slot tables): one
        interleaved scan in MCU order (fusedpack.interleaved_rows) or a
        scan a component (fusedpack.fdct_quant), a row a restart segment,
        the whole scan in one row at restart interval 0; the clock's phase
        "dct" opens before each DCT and "huffman" after it."""
        rst0 = geo.param.restart_interval == 0
        if geo.interleaved:
            if clock is not None:
                clock.mark("dct")
            coefs = fusedpack.interleaved_rows(planes, geo, classes)
            if clock is not None:
                clock.mark("huffman")
            yield (coefs, geo.mcu_count * geo.blocks_per_mcu,
                   fusedpack.interleaved_slots(geo, classes))
            return
        for c in geo.components:
            tabs = classes[c.table_index]
            if clock is not None:
                clock.mark("dct")
            coefs = fusedpack.fdct_quant(
                planes[c.index], tabs,
                c.mcu_count if rst0 else c.segment_mcu_count)
            if clock is not None:
                clock.mark("huffman")
            yield coefs, c.mcu_count, tabs

    def _device_rows(self, image, geo: Geometry,
                     shard: Optional[int] = None) -> dict:
        """Queue a frame's upload and kernels; the clock's phases "pre",
        "dct" and "huffman" mark the stages, the event "done" their end.
        Nothing goes on the download stream yet: a copy queued there now
        would hold up the previous frame's copies behind this frame's
        kernels.  shard None codes a whole frame: an RST marker after
        every segment but each scan's last.  An int codes stripe `shard`
        of a frame whose stripes have geo's geometry
        (parallel.batch.BatchEncoder): every segment is followed by its
        marker, numbered from the stripe's first segment in its scan
        (fusedpack.stripe_markers).  At restart interval 0 each scan is
        one row (fusedpack.scan_rows)."""
        clock = Clock(self.device)
        planes, classes = self._front(image, geo, clock)
        tuned = geo.param.huffman_tables == "tuned"
        rows, row_bytes = [], []
        coefs = None
        for coefs, nblocks, st in self._scan_coefs(planes, geo, classes,
                                                   clock):
            if geo.param.restart_interval == 0:
                bits, lens = fusedpack.scan_tokens(coefs, nblocks, st)
                r, rb, _needs = fusedpack.scan_rows(
                    bits, lens, nblocks, st,
                    0 if shard is None else 0xD0 + (shard & 7))
                del bits, lens
            else:
                markers = None if shard is None else \
                    fusedpack.stripe_markers(coefs.shape[0], shard,
                                             coefs.device)
                code = (fusedpack.huffman_segments if tuned
                        else fusedpack.entropy_tokens)
                r, rb, _needs = code(coefs, nblocks, st, markers)
            rows.append(r)
            row_bytes.append(rb)
        del coefs, planes
        clock.mark("end")
        rb = torch.cat(row_bytes)
        return {"rows": rows, "row_bytes": row_bytes, "clock": clock,
                "rb": rb, "done": self._staging.event()}

    def _front(self, image, geo: Geometry, clock: Optional[Clock] = None):
        """The image on the session's device (through pinned staging from
        the host), flipped and remapped as the session's options say
        (sample.flip_remap), preprocessed: (planes, the (luma, chroma)
        table classes of the geometry's quality and family)."""
        (x,), _ = self._staging.upload(_as_tensor(image), clock=clock)
        if clock is not None:
            clock.mark("pre")
        x = sample.flip_remap(x, self.flipped, self.channel_remap)
        planes = prepost_kernel.preprocess_packed(x.contiguous(), geo,
                                                  geo.param_image)
        return planes, self.classes(geo.param.quality,
                                    geo.param.huffman_tables)

    def _encode_host_entropy(self, image, geo: Geometry) -> bytes:
        """Restart interval 0 (gpujpeg_tpu Encoder._encode_host_entropy):
        the preprocessor, the DCT and each scan's tokens on the device
        (one segment a scan, fusedpack.scan_tokens), the tokens copied to
        the host, then the headers and each scan's tokens packed in
        sequence (native.pack_tokens), as the reference does with its CPU
        coder when restart markers are off (gpujpeg_encoder.c:512-534).
        The stats: duration_in_gpu from the start to the tokens on the
        host, duration_stream the packing (host clock)."""
        t0 = time.perf_counter()
        scans = self._fetch_tokens(self._device_tokens(image, geo))
        t1 = time.perf_counter()
        out = pack_scans(self._header(geo), geo, scans)
        self.stats.duration_in_gpu = (t1 - t0) * 1e3
        self.stats.duration_stream = (time.perf_counter() - t1) * 1e3
        return out

    def _device_tokens(self, image, geo: Geometry) -> dict:
        """Queue a restart-0 frame's upload, preprocessor, DCT and each
        scan's tokens (fusedpack.scan_tokens); "done" is the event after
        them.  Nothing is waited for."""
        planes, classes = self._front(image, geo)
        scans = [fusedpack.scan_tokens(coefs, nblocks, st)
                 for coefs, nblocks, st in self._scan_coefs(planes, geo,
                                                            classes)]
        return {"tokens": scans, "done": self._staging.event()}

    def _fetch_tokens(self, res: dict) -> list:
        """_device_tokens' scans on the host, [(bits, lens)] numpy, copied
        on the download stream after their kernels."""
        fetches = [(self._staging.download(b, res["done"]),
                    self._staging.download(n, res["done"]))
                   for b, n in res["tokens"]]
        return [(b.get().numpy(), n.get().numpy()) for b, n in fetches]

    def assemble(self, geo: Geometry, res, meta=None) -> bytes:
        """Host codestream assembly: headers, then each scan's rows cut to
        their byte counts (RST markers and stuffing come from the
        device).  Each scan's rows are sliced to the longest row on the
        device and copied to pinned host memory once the frame's kernels
        are done, all scans before the first wait.  Fills the session's
        stats from the frame's clock where res has one (encode_to_device).
        meta is taken for the JAX package's signature and not read, as
        there."""
        t0 = time.perf_counter()
        if "rb" in res:
            rb_all = self._staging.download(res["rb"], res["done"]).get()
        else:
            rb_all = self._staging.download(torch.cat(res["row_bytes"])
                                            ).get()
        rb_all = rb_all.numpy()
        clock = res.get("clock")
        bounds = geo.scan_seg_bounds
        fetches = []
        for k in range(geo.scan_count):
            rb = rb_all[int(bounds[k]):int(bounds[k + 1])]
            width = int(rb.max()) if len(rb) else 0
            fetches.append(self._staging.download(
                res["rows"][k][:, :width], res.get("done"), clock,
                (f"rows{k}", f"rows{k}_end")))
        parts = [self._header(geo)]
        for k, f in enumerate(fetches):
            rb = rb_all[int(bounds[k]):int(bounds[k + 1])]
            if geo.param.segment_info and geo.param.restart_interval > 0:
                offs = np.concatenate([[0], np.cumsum(rb)]).astype(np.int64)
                parts.append(jwriter.write_segment_info_headers(k, offs))
            parts.append(jwriter.write_scan_header(geo, k))
            parts.append(native.assemble_rows(f.get().contiguous().numpy(),
                                              rb))
        parts.append(b"\xff\xd9")
        if clock is not None:
            self._read_clock(clock, geo.scan_count)
        out = b"".join(parts)   # one copy of the stream, not a growing one
        self.stats.duration_stream = (time.perf_counter() - t0) * 1e3
        return out

    def _read_clock(self, clock: Clock, nscans: int) -> None:
        """The stats of a frame whose rows have reached the host."""
        st = self.stats
        st.retries = 0
        st.duration_memory_to = clock.ms("up0", "up1")
        st.duration_in_gpu = clock.span()
        st.duration_memory_from = sum(
            clock.ms(f"rows{k}", f"rows{k}_end") for k in range(nscans))
        if self.perf_stats:
            ph = clock.phases()
            st.duration_preprocessor = ph.get("pre", 0.0)
            st.duration_dct_quantization = ph.get("dct", 0.0)
            st.duration_huffman_coder = ph.get("huffman", 0.0)

    def encode(self, image, param: Optional[Parameters] = None,
               param_image: Optional[ImageParameters] = None) -> bytes:
        """Encode one raw image to a JPEG codestream.

        image: a uint8 numpy array or torch tensor (any device; a host array
        goes to the session's device through pinned staging): (H, W) for
        greyscale, (H, W, 3) or (H, W, 4), or a flat buffer of the format
        that param_image names (UYVY, planar, rows padded by
        width_padding); see prepost_kernel.check_raw."""
        t0 = time.perf_counter()
        geo = self.resolve(image, param, param_image)
        check_tables(geo)
        if geo.param.restart_interval == 0:
            out = self._encode_host_entropy(image, geo)
        else:
            out = self.assemble(geo, self._device_rows(image, geo))
        self.aggregate.add((time.perf_counter() - t0) * 1e3)
        return out

    def encode_pipelined(self, frames, param: Optional[Parameters] = None,
                         param_image: Optional[ImageParameters] = None):
        """Double-buffered encode of a frame sequence: yields one JPEG
        codestream per frame, each byte for byte sequential encode()'s
        (gpujpeg_tpu Encoder.encode_pipelined).

        Frame i+1 is staged, uploaded (upload stream) and its kernels
        queued (compute stream) before frame i's rows are copied back
        (download stream, after frame i's kernels only) and assembled, so
        the host's staging and assembly overlap the card's copies and
        kernels, as the reference overlaps them on CUDA streams
        (gpujpeg_encoder.c:423-424,550-563).  All frames must share the
        first frame's shape and dtype; a mismatch raises ValueError.  At
        restart interval 0 each frame goes through encode()."""
        it = iter(frames)
        first = next(it, None)
        if first is None:
            return
        geo = self.resolve(first, param, param_image)
        check_tables(geo)
        if geo.param.restart_interval == 0:
            # host-entropy path: no device pipeline to overlap
            yield self.encode(first, param, param_image)
            for f in it:
                yield self.encode(f, param, param_image)
            return
        shape = _frame_shape(first)
        prev = self._device_rows(first, geo)
        for f in it:
            if _frame_shape(f) != shape:
                raise ValueError(
                    f"encode_pipelined frames must all match the first "
                    f"frame's shape/dtype {shape}; got {_frame_shape(f)} "
                    "(use separate calls for mixed geometries)")
            nxt = self._device_rows(f, geo)
            yield self.assemble(geo, prev)
            prev = nxt
        yield self.assemble(geo, prev)
