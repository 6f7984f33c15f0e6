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
scan's tokens packed on the host (native.pack_tokens).  On CUDA every
stage but the tokenizer (XLA in the JAX package, torch ops here) is a
hand-written kernel (the DCT kernel stores an interleaved scan's MCU
order itself); with device="cpu" every stage runs its plain PyTorch
version.  The bytes are the same either way and equal the JAX
package's.

This slice covers 8-bit RGB P444_U8_P012 input, 3 components, the tuned
and the Annex-K Huffman tables, any restart interval (auto picks 8
blocks a segment up to Q92), chroma at 1x1 and luma at 1x1, 2x1, 1x2 or
2x2 (4:4:4, 4:2:2, 4:4:0, 4:2:0), in non-interleaved scans (the
reference GPUJPEG's headline configuration at 4:4:4) or in one
interleaved scan.  Everything else raises NotImplementedError naming
the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..ops import fusedpack, prepost_kernel
from ..stream import writer as jwriter
from ..types import (ColorSpace, ImageParameters, Parameters, PixelFormat,
                     RESTART_AUTO, pixel_format_comp_count,
                     pixel_format_sampling)
from ..utils.geometry import Geometry, get_geometry, suggest_restart_interval


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


def not_ported(what: str):
    """Raise for a public method of the JAX package's sessions that the
    port does not have yet (the session surface, ROADMAP queue 1 item
    10)."""
    raise NotImplementedError(
        f"{what} is not ported (ROADMAP queue 1 item 10)")


#: luma sampling factors of the ported layouts, chroma at 1x1
SAMPLINGS = ((1, 1), (2, 1), (1, 2), (2, 2))


def check_supported(geo: Geometry) -> None:
    """Raise NotImplementedError for a configuration outside this slice,
    naming the ROADMAP item (queue 1) that ports it."""
    param, pi = geo.param, geo.param_image
    if pi.pixel_format != PixelFormat.P444_U8_P012 or pi.width_padding:
        raise NotImplementedError(
            f"pixel format {pi.pixel_format.name}"
            f"{' with width_padding' if pi.width_padding else ''}: only "
            "P444_U8_P012 is ported (ROADMAP queue 1 item 6)")
    samp = [(c.samp_h, c.samp_v) for c in geo.components]
    if geo.comp_count != 3:
        raise NotImplementedError(
            "component counts other than 3 are not ported (ROADMAP queue "
            "1 item 6)")
    if samp[1:] != [(1, 1)] * 2 or samp[0] not in SAMPLINGS:
        raise NotImplementedError(
            f"{'interleaved' if geo.interleaved else 'non-interleaved'} "
            f"sampling {samp}: only chroma at 1x1 with luma at 1x1, 2x1, "
            "1x2 or 2x2 (4:4:4, 4:2:2, 4:4:0, 4:2:0) is ported (ROADMAP "
            "queue 1 item 6)")
    if param.huffman_tables not in ("tuned", "annexk"):
        raise ValueError(f"huffman_tables={param.huffman_tables!r}: the "
                         "families are 'tuned' and 'annexk'")


class Encoder:
    """Persistent encoder session (create once, encode many frames).

    device: None runs on the current CUDA device and raises when there is
    none; "cpu" runs the plain PyTorch versions of the kernels."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._tables: Dict[Tuple[int, bool, str],
                           fusedpack.ClassTables] = {}

    def set_option(self, key: str, value: str) -> None:
        """Reference-compatible string options (gpujpeg_encoder.c:736-795)
        are not ported yet."""
        item = {"enc_opt_flipped": 6, "enc_opt_channel_remap": 6,
                "enc_exif_tag": 11, "enc_hdr": 10, "enc_metadata": 10}
        raise NotImplementedError(
            f"encoder option {key!r} is not ported (ROADMAP queue 1 item "
            f"{item.get(key, 10)})")

    @staticmethod
    def print_options() -> str:
        """gpujpeg_encoder_print_options: not ported yet."""
        not_ported("Encoder.print_options")

    def allocate(self, param: Parameters,
                 param_image: ImageParameters) -> None:
        """gpujpeg_encoder_allocate: not ported yet."""
        not_ported("Encoder.allocate")

    @staticmethod
    def estimate_memory(param: Parameters,
                        param_image: ImageParameters) -> int:
        """Device bytes of one frame's encode: not ported yet."""
        not_ported("Encoder.estimate_memory")

    @staticmethod
    def max_pixels(param: Parameters, memory_bytes: int) -> int:
        """gpujpeg_encoder_max_pixels: not ported yet."""
        not_ported("Encoder.max_pixels")

    @staticmethod
    def max_memory(param: Parameters, pixels: int) -> int:
        """gpujpeg_encoder_max_memory: not ported yet."""
        not_ported("Encoder.max_memory")

    def encode_pipelined(self, frames, param: Optional[Parameters] = None,
                         param_image: Optional[ImageParameters] = None):
        """Double-buffered encode of a frame sequence: not ported yet."""
        not_ported("Encoder.encode_pipelined")

    def get_stats(self):
        """The session's DurationStats: not ported yet."""
        not_ported("Encoder.get_stats")

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

    def encode_to_device(self, image, param: Optional[Parameters] = None,
                         param_image: Optional[ImageParameters] = None,
                         check: bool = True):
        """Device-side encode.  Returns (geo, res): res["rows"] holds one
        (segments, stride) uint8 tensor per scan (one for an interleaved
        scan) and res["row_bytes"] one (segments,) int32 tensor per scan,
        still on the device.  The rows have a worst-case stride, so there
        is no overflow readback for check=False to skip: check is taken
        for the JAX package's signature and not read.  Annex-K tables code
        through tokens and the token-row packer (fusedpack.entropy_tokens).
        A restart interval of 0 raises ValueError: encode packs such scans
        on the host (_encode_host_entropy) and makes no device rows."""
        geo = self.resolve(image, param, param_image)
        check_supported(geo)
        if geo.param.restart_interval == 0:
            raise ValueError("restart_interval == 0: each scan is one "
                             "segment, packed on the host by encode(); "
                             "encode_to_device makes the rows of restart "
                             "segments only")
        planes, classes = self._front(image, geo)
        tuned = geo.param.huffman_tables == "tuned"
        if geo.interleaved:
            if tuned:
                rows, row_bytes, _needs = fusedpack.entropy_fused_u8_il(
                    planes, geo, classes)
            else:
                rows, row_bytes, _needs = fusedpack.entropy_tokens(
                    fusedpack.interleaved_rows(planes, geo, classes),
                    geo.mcu_count * geo.blocks_per_mcu,
                    fusedpack.interleaved_slots(geo, classes))
            return geo, {"rows": [rows], "row_bytes": [row_bytes]}
        rows, row_bytes = [], []
        for c in geo.components:
            tabs = classes[c.table_index]
            if tuned:
                r, rb, _needs = fusedpack.entropy_fused_u8(
                    planes[c.index], tabs, c.segment_mcu_count)
            else:
                r, rb, _needs = fusedpack.entropy_tokens(
                    fusedpack.fdct_quant(planes[c.index], tabs,
                                         c.segment_mcu_count),
                    c.mcu_count, tabs)
            rows.append(r)
            row_bytes.append(rb)
        return geo, {"rows": rows, "row_bytes": row_bytes}

    def _front(self, image, geo: Geometry):
        """The image on the session's device, preprocessed: (planes, the
        (luma, chroma) table classes of the geometry's quality and
        family)."""
        if isinstance(image, torch.Tensor):
            x = image.to(self.device)
        else:
            x = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
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
        coder when restart markers are off (gpujpeg_encoder.c:512-534)."""
        planes, classes = self._front(image, geo)
        scans = []
        if geo.interleaved:
            scans.append(fusedpack.scan_tokens(
                fusedpack.interleaved_rows(planes, geo, classes),
                geo.mcu_count * geo.blocks_per_mcu,
                fusedpack.interleaved_slots(geo, classes)))
        else:
            for c in geo.components:
                tabs = classes[c.table_index]
                scans.append(fusedpack.scan_tokens(
                    fusedpack.fdct_quant(planes[c.index], tabs,
                                         c.mcu_count), c.mcu_count, tabs))
        out = bytearray(jwriter.write_header(geo))
        for k, (bits, lens) in enumerate(scans):
            out += jwriter.write_scan_header(geo, k)
            out += native.pack_tokens(bits.cpu().numpy(), lens.cpu().numpy())
        out += b"\xff\xd9"
        return bytes(out)

    def assemble(self, geo: Geometry, res, meta=None) -> bytes:
        """Host codestream assembly: headers, then each scan's rows cut to
        their byte counts (RST markers and stuffing come from the
        device).  Each scan's rows are sliced to the longest row on the
        device before the copy to the host.  meta is taken for the JAX
        package's signature and not read, as there."""
        rb_all = torch.cat(res["row_bytes"]).cpu().numpy()
        out = bytearray(jwriter.write_header(geo))
        for k in range(geo.scan_count):
            b0, b1 = (int(geo.scan_seg_bounds[k]),
                      int(geo.scan_seg_bounds[k + 1]))
            rb = rb_all[b0:b1]
            width = int(rb.max()) if len(rb) else 0
            by = res["rows"][k][:, :width].contiguous().cpu().numpy()
            if geo.param.segment_info:
                offs = np.concatenate([[0], np.cumsum(rb)]).astype(np.int64)
                out += jwriter.write_segment_info_headers(k, offs)
            out += jwriter.write_scan_header(geo, k)
            out += native.assemble_rows(by, rb)
        out += b"\xff\xd9"
        return bytes(out)

    def encode(self, image, param: Optional[Parameters] = None,
               param_image: Optional[ImageParameters] = None) -> bytes:
        """Encode one raw image to a JPEG codestream.

        image: (H, W, 3) uint8 numpy array or torch tensor (any device; it
        is moved to the session's device)."""
        geo = self.resolve(image, param, param_image)
        if geo.param.restart_interval == 0:
            check_supported(geo)
            return self._encode_host_entropy(image, geo)
        geo, res = self.encode_to_device(image, param, param_image)
        return self.assemble(geo, res)
