"""Encoder session of the PyTorch port (gpujpeg_tpu.models.encoder).

The device pipeline follows the JAX package's dispatch
(gpujpeg_tpu.models.encoder.make_full_encode_fn).  Where its megakernel
applies (non-interleaved scans, tuned tables), per component:

    preprocess (colour + planes)      ops/prepost_kernel.preprocess_packed
    per component:
      forward DCT + quantization      ops/fusedpack.fdct_quant
      Huffman coding of segment rows  ops/fusedpack.huffman_segments

and for an interleaved scan with subsampled chroma, its non-megakernel
path (make_rows_tokens_impl, then the deep-stuff packer), one scan:

    preprocess (colour, decimation)   ops/prepost_kernel.preprocess_packed
    per component:
      forward DCT + quantization      ops/fusedpack.fdct_quant
      blocks to MCU stream order      Encoder.interleaved_coefs
      Huffman tokens of its blocks    ops/tokens.tokenize_rows (torch ops)
    tokens interleaved per MCU        Encoder.interleaved_tokens
    token rows to stuffed byte rows   ops/fusedpack.pack_stuff_rows

then host assembly: headers (stream/writer.py) and the rows of each scan,
cut to their byte counts (native.assemble_rows).  On CUDA every stage but
the tokenizer is a hand-written kernel; with device="cpu" every stage runs
its plain PyTorch version.  The bytes are the same either way and equal
the JAX package's.

This slice covers 8-bit RGB P444_U8_P012 input, 3 components, the tuned
Huffman family, a restart interval > 0 (auto picks 8 blocks a segment up
to Q92), and either non-interleaved scans at 4:4:4 (the reference
GPUJPEG's headline configuration) or one interleaved scan with chroma at
1x1 and luma at 2x2, 2x1 or 1x2 (4:2:0, 4:2:2, 4:4:0).  Everything else
raises NotImplementedError naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..ops import fusedpack, prepost_kernel, tokens
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
    if geo.interleaved:
        if samp == [(1, 1)] * 3:
            raise NotImplementedError(
                "interleaved 4:4:4 scans (the JAX package's interleaved "
                "megakernel mode) are not ported (ROADMAP queue 1 item 8, "
                "queue 2 item 7)")
        if samp[1:] != [(1, 1)] * 2 or samp[0] not in ((2, 2), (2, 1),
                                                       (1, 2)):
            raise NotImplementedError(
                f"interleaved sampling {samp}: only 4:2:0, 4:2:2 and 4:4:0 "
                "are ported (ROADMAP queue 1 item 6)")
    elif samp != [(1, 1)] * 3:
        raise NotImplementedError(
            f"non-interleaved scans at sampling {samp}: only 4:4:4 is "
            "ported (ROADMAP queue 1 item 6)")
    if param.restart_interval == 0:
        raise NotImplementedError(
            "restart_interval == 0 (host entropy path) is not ported "
            "(ROADMAP queue 1 item 9)")
    if param.huffman_tables != "tuned":
        raise NotImplementedError(
            f"huffman_tables={param.huffman_tables!r}: only the tuned "
            "family is ported (ROADMAP queue 1 item 7)")


class Encoder:
    """Persistent encoder session (create once, encode many frames).

    device: None runs on the current CUDA device and raises when there is
    none; "cpu" runs the plain PyTorch versions of the kernels."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._tables: Dict[Tuple[int, bool], fusedpack.ClassTables] = {}

    def set_option(self, key: str, value: str) -> None:
        """Reference-compatible string options (gpujpeg_encoder.c:736-795)
        are not ported yet."""
        item = {"enc_opt_flipped": 6, "enc_opt_channel_remap": 6,
                "enc_exif_tag": 11, "enc_hdr": 10, "enc_metadata": 10}
        raise NotImplementedError(
            f"encoder option {key!r} is not ported (ROADMAP queue 1 item "
            f"{item.get(key, 10)})")

    def class_tables(self, quality: int,
                     luma: bool) -> fusedpack.ClassTables:
        key = (quality, luma)
        tabs = self._tables.get(key)
        if tabs is None:
            tabs = fusedpack.class_tables(quality, luma, self.device)
            self._tables[key] = tabs
        return tabs

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
                         param_image: Optional[ImageParameters] = None):
        """Device-side encode.  Returns (geo, res): res["rows"] holds one
        (segments, stride) uint8 tensor per scan (one for an interleaved
        scan) and res["row_bytes"] one (segments,) int32 tensor per scan,
        still on the device."""
        geo = self.resolve(image, param, param_image)
        check_supported(geo)
        if isinstance(image, torch.Tensor):
            x = image.to(self.device)
        else:
            x = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        planes = prepost_kernel.preprocess_packed(x.contiguous(), geo,
                                                  geo.param_image)
        if geo.interleaved:
            bits, lens = self.interleaved_tokens(
                self.interleaved_coefs(planes, geo), geo)
            del planes
            rows, row_bytes, _needs = fusedpack.pack_stuff_rows(
                bits, lens, fusedpack.segment_markers(geo.segment_count,
                                                      bits.device),
                self.interleaved_stride(geo))
            return geo, {"rows": [rows], "row_bytes": [row_bytes]}
        rows, row_bytes = [], []
        for c in geo.components:
            tabs = self.class_tables(geo.param.quality, c.table_index == 0)
            r, rb, _needs = fusedpack.entropy_fused_u8(
                planes[c.index], tabs, c.segment_mcu_count)
            rows.append(r)
            row_bytes.append(rb)
        return geo, {"rows": rows, "row_bytes": row_bytes}

    def interleaved_coefs(self, planes, geo: Geometry) -> List[torch.Tensor]:
        """Per component, its quantized coefficients in the scan's stream
        order: (segments, restart interval * sv * sh, 64) int16, MCUs in
        raster order and the component's sv x sh blocks of an MCU in (v,
        h) order, MCUs past the image zero (the layout math of
        gpujpeg_tpu.models.encoder.make_rows_tokens_impl)."""
        S, rst, nmcu = (geo.segment_count, geo.segment_mcu_count,
                        geo.mcu_count)
        out = []
        for c in geo.components:
            tabs = self.class_tables(geo.param.quality, c.table_index == 0)
            n = c.samp_v * c.samp_h
            x = fusedpack.fdct_quant(planes[c.index], tabs, 1).reshape(
                c.mcu_count_y, c.samp_v, c.mcu_count_x, c.samp_h, 64)
            x = x.permute(0, 2, 1, 3, 4).reshape(nmcu, n, 64)
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, S * rst - nmcu))
            out.append(x.reshape(S, rst * n, 64))
        return out

    def interleaved_tokens(self, coefs: List[torch.Tensor], geo: Geometry):
        """Huffman tokens of an interleaved scan: each component's blocks
        tokenized with its class's tables (the DC predictor runs along the
        component's own blocks of the segment), then interleaved per MCU
        -> (bits, lens) (segments, T) int32, T = interval * blocks a MCU *
        64, fusedpack.PLAIN_CHUNK_ROWS segment rows at a time."""
        S, rst, bpm = (geo.segment_count, geo.segment_mcu_count,
                       geo.blocks_per_mcu)
        dev = coefs[0].device
        bits = torch.empty((S, rst, bpm * 64), dtype=torch.int32,
                           device=dev)
        lens = torch.empty_like(bits)
        mcus = torch.clamp(geo.mcu_count - rst * torch.arange(
            S, device=dev), 0, rst)
        off = 0
        for c, x in zip(geo.components, coefs):
            tabs = self.class_tables(geo.param.quality, c.table_index == 0)
            n = c.samp_v * c.samp_h
            cols = slice(off * 64, (off + n) * 64)
            for a in range(0, S, fusedpack.PLAIN_CHUNK_ROWS):
                sl = slice(a, min(S, a + fusedpack.PLAIN_CHUNK_ROWS))
                b, ln = tokens.tokenize_rows(x[sl], tabs.luts[:16],
                                             tabs.luts[16:], mcus[sl] * n)
                k = sl.stop - sl.start
                bits[sl, :, cols] = b.reshape(k, rst, n * 64).to(torch.int32)
                lens[sl, :, cols] = ln.reshape(k, rst, n * 64)
            off += n
        return bits.reshape(S, -1), lens.reshape(S, -1)

    def interleaved_stride(self, geo: Geometry) -> int:
        """Worst-case bytes of an interleaved segment row, from the class
        of every block slot (fusedpack.pack_stride)."""
        slots = [self.class_tables(geo.param.quality, c.table_index == 0)
                 for c in geo.components
                 for _ in range(c.samp_v * c.samp_h)]
        return fusedpack.pack_stride(slots * geo.segment_mcu_count)

    def assemble(self, geo: Geometry, res) -> bytes:
        """Host codestream assembly: headers, then each scan's rows cut to
        their byte counts (RST markers and stuffing come from the
        device).  Each scan's rows are sliced to the longest row on the
        device before the copy to the host."""
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
        geo, res = self.encode_to_device(image, param, param_image)
        return self.assemble(geo, res)
