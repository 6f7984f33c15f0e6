"""Entropy stage of the encoder: forward DCT + quantization, then Huffman
coding of restart-segment rows into stuffed byte rows.

The JAX package runs both in one Pallas megakernel
(gpujpeg_tpu.ops.fusedpack._entropy_kernel_body through entropy_fused_u8).
The port splits it into two hand-written CUDA kernels:

  fdct_quant        csrc/fdct_quant.cu        plane -> (S, rst*64) int16
  huffman_segments  csrc/huffman_segments.cu  coefficients -> byte rows

``entropy_fused_u8`` runs one after the other.  Where the megakernel does
not apply (interleaved subsampled scans), the JAX package tokenizes in XLA
and packs the token rows with its Pallas deep-stuff kernel
(_deep_stuff_kernel_body through pack_stuff_fused); the port's counterpart
is

  pack_stuff_rows   csrc/pack_stuff_rows.cu   token rows -> byte rows

For CPU tensors each wrapper runs its plain version (ops/dct.py;
ops/tokens.py plus ``pack_rows`` below); for CUDA tensors it launches its
kernel or raises.

Rows are bytes in stream order, one restart segment per row, with the
F.1.2.3 1-padding, 0xFF -> 0xFF00 stuffing and the RST marker of every
segment but the scan's last.  Their stride is the
worst case (``row_stride``), so no capacity protocol is needed; ``needs``
keeps the last two entries of the JAX package's vector: the largest
stuffed-zero count and the largest row length.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils import tables
from . import _kernels, dct, tokens

#: segment rows per chunk of the plain Huffman coder (bounds its memory)
PLAIN_CHUNK_ROWS = 8192


@dataclasses.dataclass(frozen=True)
class ClassTables:
    """Constants of one table class (luma or chroma) at one quality, on
    one device."""

    qtab: np.ndarray        # (64,) quant table, zig-zag order
    mq: torch.Tensor        # (64, 64) f32 fused DCT+quant matrix
    bias: torch.Tensor      # (64,) f32 folded level shift
    luts: torch.Tensor      # (272,) int32 (len << 16 | code): DC at
                            # [0, 16) (12 used), AC at [16, 272)
    max_block_bits: int     # longest possible coding of one block


def class_tables(quality: int, luma: bool, device) -> ClassTables:
    """Tables of one class with the tuned AC code family."""
    qtab = tables.quant_table_zz(luma, quality)
    mq, bias = tables.fdct_fused_matrix(qtab)
    dc = tables.huffman_encode_lut(*tables.huffman_spec_for("dc", luma), 16)
    ac = tables.huffman_encode_lut(*tables.ac_spec(luma, quality), 256)
    luts = np.concatenate([dc, ac])        # entries < 2^21: exact in int32
    # DC: code + up to 11 value bits; each of 63 AC slots emits at most one
    # token of code + up to 10 value bits (ZRL and EOB carry none)
    max_dc = int((dc[:12] >> 16).max()) + 11
    max_ac = int((ac >> 16).max()) + 10
    return ClassTables(
        qtab=qtab,
        # row-major: fdct_fused_matrix may hand back a column-major array
        mq=torch.from_numpy(np.ascontiguousarray(mq)).to(device),
        bias=torch.from_numpy(bias).to(device),
        luts=torch.from_numpy(luts.astype(np.int32)).to(device),
        max_block_bits=max_dc + 63 * max_ac)


def pack_stride(slots: Sequence[ClassTables]) -> int:
    """Worst-case bytes of one segment row whose block slots take these
    classes: every block at its class's longest coding, doubled for
    stuffing, plus the 2-byte marker, rounded up to 16."""
    raw = -(-sum(t.max_block_bits for t in slots) // 8)
    return -(-(2 * raw + 2) // 16) * 16


def row_stride(rst: int, tabs: ClassTables) -> int:
    """Worst-case bytes of a segment row of rst blocks of one class."""
    return pack_stride([tabs] * rst)


def segment_count(plane: torch.Tensor, rst: int) -> Tuple[int, int]:
    """(blocks, restart segments of rst blocks) of a (data_h, data_w)
    plane."""
    nblocks = (plane.shape[0] // 8) * (plane.shape[1] // 8)
    return nblocks, -(-nblocks // rst)


def fdct_quant_plain(plane: torch.Tensor, tabs: ClassTables,
                     rst: int) -> torch.Tensor:
    """Plain version of fdct_quant, on any device."""
    nblocks, nseg = segment_count(plane, rst)
    coefs = dct.fdct_quantize(plane, tabs.qtab)
    coefs = torch.nn.functional.pad(coefs, (0, 0, 0, nseg * rst - nblocks))
    return coefs.reshape(nseg, rst * 64)


def fdct_quant(plane: torch.Tensor, tabs: ClassTables,
               rst: int) -> torch.Tensor:
    """(data_h, data_w) uint8 plane -> (nseg, rst*64) int16 quantized
    zig-zag coefficients, nseg = ceil(blocks / rst); blocks in raster
    order are segment order, pad blocks past the plane's last block are
    0."""
    H, W = plane.shape
    _, nseg = segment_count(plane, rst)
    if plane.device.type == "cpu":
        return fdct_quant_plain(plane, tabs, rst)
    out = torch.empty((nseg, rst * 64), dtype=torch.int16,
                      device=plane.device)
    _kernels.require_cuda("fdct_quant", plane, tabs.mq, tabs.bias, out)
    if plane.dtype != torch.uint8 or H % 8 or W % 8:
        raise ValueError("fdct_quant takes a uint8 plane of whole blocks")
    _kernels.launch("fdct_quant", plane, H, W, nseg * rst, tabs.mq,
                    tabs.bias, out)
    return out


def pack_rows(bits: torch.Tensor, lens: torch.Tensor,
              markers: torch.Tensor, stride: int):
    """Plain bit packer: token rows -> stuffed byte rows.

    bits/lens: (R, T) right-aligned tokens and their lengths (0 = none);
    markers: (R,) second byte of the RST marker after each row (0 = none).
    Concatenates every row's tokens MSB first (bits above a token's
    length are ignored), pads the last byte with 1-bits (F.1.2.3), stuffs
    a 0x00 after every 0xFF, then appends 0xFF, marker.  Returns (rows
    (R, stride) uint8 zero-filled past the data, row_bytes (R,) int32,
    nff (R,) stuffed-zero counts).
    """
    dev = bits.device
    R, T = lens.shape
    L = lens.to(torch.int64)
    bits = bits.to(torch.int64) & ((1 << L) - 1)
    off = torch.cumsum(L, dim=1) - L                  # bit offset of token
    tb = off[:, -1] + L[:, -1]                        # bits per row
    nb = (tb + 7) >> 3                                # bytes before stuffing
    cap = int(nb.max()) + 5 if R else 5
    # each token (<= 27 bits) lies in the 5 bytes from its first byte on:
    # place it in a 40-bit window and add the bytes, which is an OR since
    # tokens never share a bit
    sh = off & 7
    val = torch.where(L > 0, bits << (40 - sh - L), 0)
    rowbase = (torch.arange(R, device=dev, dtype=torch.int64) * cap)[:, None]
    first = rowbase + (off >> 3)
    buf = torch.zeros(R * cap, dtype=torch.int64, device=dev)
    for j in range(5):
        buf.index_add_(0, (first + j).reshape(-1),
                       ((val >> (32 - 8 * j)) & 0xFF).reshape(-1))
    pad = (-tb) & 7                                   # 1-bits to the byte end
    last = torch.arange(R, device=dev) * cap + (tb >> 3)
    buf.index_add_(0, last, torch.where(pad > 0, (1 << pad) - 1, 0))
    b = buf.reshape(R, cap)
    pos = torch.arange(cap, device=dev)
    inb = pos[None, :] < nb[:, None]
    ff = (b == 0xFF) & inb
    nff = ff.sum(dim=1)
    dest = pos[None, :] + torch.cumsum(ff, dim=1) - ff.to(torch.int64)
    rows = torch.zeros((R, stride), dtype=torch.uint8, device=dev)
    flat = rows.view(-1)
    rbase = torch.arange(R, device=dev, dtype=torch.int64) * stride
    flat[(rbase[:, None] + dest)[inb]] = b[inb].to(torch.uint8)
    end = nb + nff
    has = markers.to(dev) != 0
    flat[(rbase + end)[has]] = 0xFF
    flat[(rbase + end + 1)[has]] = markers.to(dev)[has].to(torch.uint8)
    row_bytes = (end + 2 * has.to(torch.int64)).to(torch.int32)
    return rows, row_bytes, nff.to(torch.int32)


def segment_markers(nseg: int, device) -> torch.Tensor:
    """Second RST byte after each segment row of one scan: 0xD0 + s % 8,
    none after the scan's last (gpujpeg_encoder.c:566-624), as (nseg,)
    int32.  A scan of one segment (restart interval 0) gets none."""
    s = torch.arange(nseg, device=device, dtype=torch.int32)
    return torch.where(s < nseg - 1, 0xD0 + (s & 7), 0).to(torch.int32)


def huffman_segments_plain(coefs: torch.Tensor, nblocks: int,
                           tabs: ClassTables):
    """Plain version of huffman_segments, on any device: tokenize
    (ops/tokens.py), then pack_rows, PLAIN_CHUNK_ROWS rows at a time."""
    dev = coefs.device
    S, C = coefs.shape
    rst = C // 64
    stride = row_stride(rst, tabs)
    nvalid = torch.clamp(
        nblocks - torch.arange(S, dtype=torch.int64, device=dev) * rst,
        0, rst)
    markers = segment_markers(S, dev)
    rows = torch.zeros((S, stride), dtype=torch.uint8, device=dev)
    row_bytes = torch.zeros(S, dtype=torch.int32, device=dev)
    nff = torch.zeros(S, dtype=torch.int32, device=dev)
    for a in range(0, S, PLAIN_CHUNK_ROWS):
        sl = slice(a, min(S, a + PLAIN_CHUNK_ROWS))
        bits, lens = tokens.tokenize_rows(
            coefs[sl].reshape(-1, rst, 64), tabs.luts[:16], tabs.luts[16:],
            nvalid[sl])
        rows[sl], row_bytes[sl], nff[sl] = pack_rows(
            bits, lens, markers[sl], stride)
    needs = torch.zeros(2, dtype=torch.int32, device=dev)
    if S:
        needs = torch.stack([nff.max(), row_bytes.max()])
    return rows, row_bytes, needs


def huffman_segments(coefs: torch.Tensor, nblocks: int, tabs: ClassTables
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, rst*64) int16 coefficients of one component's scan, of which
    the first `nblocks` blocks are real -> (rows (S, row_stride) uint8,
    row_bytes (S,) int32, needs (2,) int32 = [max stuffed zeros, max row
    bytes])."""
    S, C = coefs.shape
    rst = C // 64
    if C % 64 or not 0 < nblocks <= S * rst:
        raise ValueError(f"{nblocks} blocks do not fit {S} rows of "
                         f"{C} coefficients")
    if coefs.device.type == "cpu":
        return huffman_segments_plain(coefs, nblocks, tabs)
    stride = row_stride(rst, tabs)
    rows = torch.empty((S, stride), dtype=torch.uint8, device=coefs.device)
    row_bytes = torch.empty(S, dtype=torch.int32, device=coefs.device)
    needs = torch.zeros(2, dtype=torch.int32, device=coefs.device)
    _kernels.require_cuda("huffman_segments", coefs, tabs.luts, rows,
                          row_bytes, needs)
    if coefs.dtype != torch.int16:
        raise ValueError("huffman_segments takes int16 coefficients")
    _kernels.launch("huffman_segments", coefs, S, rst, nblocks, tabs.luts,
                    stride, rows, row_bytes, needs)
    return rows, row_bytes, needs


def entropy_fused_u8(plane: torch.Tensor, tabs: ClassTables, rst: int):
    """One component's uint8 plane -> (rows, row_bytes, needs): the
    forward DCT + quantization, then the Huffman coder, with segments of
    `rst` blocks (gpujpeg_tpu.ops.fusedpack.entropy_fused_u8 for a
    non-interleaved scan)."""
    nblocks, _ = segment_count(plane, rst)
    return huffman_segments(fdct_quant(plane, tabs, rst), nblocks, tabs)


def pack_stuff_rows_plain(bits: torch.Tensor, lens: torch.Tensor,
                          markers: torch.Tensor, stride: int):
    """Plain version of pack_stuff_rows, on any device: pack_rows,
    PLAIN_CHUNK_ROWS rows at a time."""
    dev = bits.device
    R = bits.shape[0]
    rows = torch.zeros((R, stride), dtype=torch.uint8, device=dev)
    row_bytes = torch.zeros(R, dtype=torch.int32, device=dev)
    needs = torch.zeros(2, dtype=torch.int32, device=dev)
    for a in range(0, R, PLAIN_CHUNK_ROWS):
        sl = slice(a, min(R, a + PLAIN_CHUNK_ROWS))
        rows[sl], row_bytes[sl], nff = pack_rows(bits[sl], lens[sl],
                                                 markers[sl], stride)
        needs = torch.maximum(needs, torch.stack([nff.max(),
                                                  row_bytes[sl].max()]))
    return rows, row_bytes, needs


def pack_stuff_rows(bits: torch.Tensor, lens: torch.Tensor,
                    markers: torch.Tensor, stride: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token rows -> stuffed byte rows (the JAX package's pack_stuff_fused
    without its capacities): bits/lens (R, T) int32 right-aligned tokens of
    at most 27 bits and their lengths (0 = no token), markers (R,) int32
    second RST byte after each row (0 = none), stride a worst case for the
    rows (pack_stride) -> (rows (R, stride) uint8, row_bytes (R,) int32,
    needs (2,) int32 = [max stuffed zeros, max row bytes])."""
    R, T = bits.shape
    if tuple(lens.shape) != (R, T) or tuple(markers.shape) != (R,):
        raise ValueError("pack_stuff_rows: bits and lens must be (R, T), "
                         "markers (R,)")
    if bits.device.type == "cpu":
        return pack_stuff_rows_plain(bits, lens, markers, stride)
    rows = torch.empty((R, stride), dtype=torch.uint8, device=bits.device)
    row_bytes = torch.empty(R, dtype=torch.int32, device=bits.device)
    needs = torch.zeros(2, dtype=torch.int32, device=bits.device)
    _kernels.require_cuda("pack_stuff_rows", bits, lens, markers, rows,
                          row_bytes, needs)
    if (bits.dtype != torch.int32 or lens.dtype != torch.int32
            or markers.dtype != torch.int32 or T % 4 or stride % 4):
        raise ValueError("pack_stuff_rows takes int32 tensors, T and the "
                         "stride multiples of 4")
    _kernels.launch("pack_stuff_rows", bits, lens, R, T, markers, stride,
                    rows, row_bytes, needs)
    return rows, row_bytes, needs
