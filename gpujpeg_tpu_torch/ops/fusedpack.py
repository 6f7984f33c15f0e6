"""Entropy stage of the encoder: forward DCT + quantization, then Huffman
coding of restart-segment rows into stuffed byte rows.

The JAX package runs both in one Pallas megakernel
(gpujpeg_tpu.ops.fusedpack._entropy_kernel_body) in three modes: DCT-fused
for one component of a non-interleaved scan (entropy_fused_u8), DCT-fused
for a whole interleaved scan (entropy_fused_u8_il) and coefficient input
(entropy_fused).  The port splits it into two hand-written CUDA kernels:

  fdct_quant        csrc/fdct_quant.cu        plane -> (S, rst*64) int16,
                                              or into its MCU slots
  huffman_segments  csrc/huffman_segments.cu  coefficient rows -> byte rows

and one Huffman contract covers the three modes: a table class and a
component (for the DC predictor) per block slot of an MCU (``SlotTables``),
a class flag per row, a valid mask per block and the RST marker after
each row given by the caller.  ``entropy_fused_u8``, ``entropy_fused_u8_il``
and ``entropy_fused`` are the counterparts of the JAX functions of those
names.  With the tuned tables every interleaved scan codes through the
slot-pattern mode, 4:2:0 included: the coefficients are in device memory
in MCU order (``interleaved_rows``).  With Annex-K tables the encode takes
the JAX package's non-megakernel route (its megakernel computes the tuned
codes; gpujpeg_tpu.models.encoder.mega_supported): the torch tokenizer on
the device (``rows_tokens``; the JAX package's is XLA too), then its
deep-stuff kernel:

  pack_stuff_rows   csrc/pack_stuff_rows.cu   token rows -> byte rows

(``entropy_tokens``).  Both kernels code a row a warp and share the warp's
bit buffer and its stuffing (csrc/bitbuf.cuh).  A scan coded as one
segment (restart interval 0) is tokenized the same way, a piece of the
scan a row with each component's DC predictor carried from piece to
piece (``scan_tokens``), and packed on the host (native.pack_tokens), as
the JAX package's _encode_host_entropy does; encode_to_device packs it on
the card instead, through the packer's scan instance (``scan_rows``,
``pack_stuff_scan``: chunks of a scan's tokens a CTA, joined by
look-backs).

For CPU tensors each wrapper runs its plain version (ops/dct.py;
``segment_tokens`` plus ``pack_rows`` below); for CUDA tensors it launches
its kernel or raises.

Rows are bytes in stream order, one restart segment per row, with the
F.1.2.3 1-padding, 0xFF -> 0xFF00 stuffing and the row's RST marker.
Their stride is the worst case (``pack_stride``), so no capacity protocol
is needed; ``needs`` keeps the last two entries of the JAX package's
vector: the largest stuffed-zero count and the largest row length.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils import tables
from . import _kernels, dct, tokens

#: segment rows per chunk of the plain Huffman coder (bounds its memory)
PLAIN_CHUNK_ROWS = 8192

#: token slots per chunk of the tokenizer on the encode paths (bounds its
#: memory: about 30 temporaries of 4 or 8 bytes a slot)
TOKEN_CHUNK_SLOTS = 1 << 22

#: MCUs a row when a scan of one segment is cut into rows (scan_tokens)
SCAN_ROW_MCUS = 8

#: the token-row packer's scan instance (csrc/pack_stuff_rows.cu; the same
#: constants there): a CTA packs a chunk of SCAN_CHUNK_TOKENS tokens; its
#: scratch is SCAN_HEAD int64 words (the ticket) and a look-back record of
#: SCAN_REC words a chunk
SCAN_CHUNK_TOKENS = 4096
SCAN_REC = 8
SCAN_HEAD = 8


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


def _code_luts(quality: int, luma: bool, family: str):
    """(DC, AC) code tables of a class, (len << 16 | code) an entry."""
    return (tables.huffman_encode_lut(*tables.huffman_spec_for("dc", luma),
                                      16),
            tables.huffman_encode_lut(*tables.ac_spec(luma, quality, family),
                                      256))


def block_bits(quality: int, luma: bool, family: str = "tuned") -> int:
    """The longest possible coding of one block in a class's tables
    (ClassTables.max_block_bits): the DC code and up to 11 value bits,
    and for each of the 63 AC slots at most one token of code and up to
    10 value bits (ZRL and EOB carry none)."""
    dc, ac = _code_luts(quality, luma, family)
    return (int((dc[:12] >> 16).max()) + 11
            + 63 * (int((ac >> 16).max()) + 10))


def class_tables(quality: int, luma: bool, device,
                 family: str = "tuned") -> ClassTables:
    """Tables of one class with the AC code family `family` ("tuned" or
    "annexk", tables.ac_spec); the DC codes are Annex K's in both."""
    qtab = tables.quant_table_zz(luma, quality)
    mq, bias = tables.fdct_fused_matrix(qtab)
    dc, ac = _code_luts(quality, luma, family)
    luts = np.concatenate([dc, ac])        # entries < 2^21: exact in int32
    return ClassTables(
        qtab=qtab,
        # row-major: fdct_fused_matrix may hand back a column-major array
        mq=torch.from_numpy(np.ascontiguousarray(mq)).to(device),
        bias=torch.from_numpy(bias).to(device),
        luts=torch.from_numpy(luts.astype(np.int32)).to(device),
        max_block_bits=block_bits(quality, luma, family))


@dataclasses.dataclass(frozen=True)
class SlotTables:
    """The Huffman coder's view of a row: block b sits in slot b % bpm of
    its MCU and takes classes[slot_class[slot]] (classes[1] in a row whose
    class flag is 0) and the DC predictor of component slot_comp[slot]."""

    classes: Tuple[ClassTables, ClassTables]
    slot_class: Tuple[int, ...]     # 0 or 1 a slot
    slot_comp: Tuple[int, ...]      # 0..3 a slot

    @property
    def bpm(self) -> int:
        return len(self.slot_class)

    def stride(self, B: int, row_flags: bool = False) -> int:
        """Worst-case bytes of a row of B blocks (pack_stride), with every
        row's class flag set, or either when row_flags."""
        slots = [self.classes[k] for k in self.slot_class] * (B // self.bpm)
        out = pack_stride(slots)
        if row_flags:
            out = max(out, pack_stride([self.classes[1]] * B))
        return out


def one_slot(tabs: ClassTables) -> SlotTables:
    """The rows of one component's non-interleaved scan: one slot, one
    class."""
    return SlotTables((tabs, tabs), (0,), (0,))


def pack_stride(slots: Sequence[ClassTables]) -> int:
    """Worst-case bytes of one segment row whose block slots take these
    classes: every block at its class's longest coding (bits_stride)."""
    return bits_stride(sum(t.max_block_bits for t in slots))


def bits_stride(bits: int) -> int:
    """Worst-case bytes of a segment row that codes in at most `bits`
    bits: doubled for stuffing, plus the 2-byte marker, rounded up to
    16."""
    return -(-(2 * -(-bits // 8) + 2) // 16) * 16


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


def _fdct_args(plane: torch.Tensor, tabs: ClassTables, out: torch.Tensor,
               nblocks_out: int, bpm: int = 1, off: int = 0, sh: int = 1,
               sv: int = 1, mcux: Optional[int] = None):
    """The C arguments of csrc/fdct_quant.cu: the plane's blocks into the
    first nblocks_out block slots of out, block b at slot b (bpm = 1) or
    at its MCU slot (interleaved_rows)."""
    H, W = plane.shape
    _kernels.require_cuda("fdct_quant", plane, tabs.mq, tabs.bias, out)
    if plane.dtype != torch.uint8 or H % 8 or W % 8:
        raise ValueError("fdct_quant takes a uint8 plane of whole blocks")
    if out.dtype != torch.int16 or out.numel() != nblocks_out * 64:
        raise ValueError("fdct_quant writes nblocks_out int16 blocks")
    return (plane, H, W, nblocks_out, bpm, off, sh, sv,
            W // 8 if mcux is None else mcux, tabs.mq, tabs.bias, out)


def _fdct_out(plane: torch.Tensor, rst: int) -> torch.Tensor:
    _, nseg = segment_count(plane, rst)
    return torch.empty((nseg, rst * 64), dtype=torch.int16,
                       device=plane.device)


def fdct_quant(plane: torch.Tensor, tabs: ClassTables,
               rst: int) -> torch.Tensor:
    """(data_h, data_w) uint8 plane -> (nseg, rst*64) int16 quantized
    zig-zag coefficients, nseg = ceil(blocks / rst); blocks in raster
    order are segment order, pad blocks past the plane's last block are
    0."""
    if plane.device.type == "cpu":
        return fdct_quant_plain(plane, tabs, rst)
    out = _fdct_out(plane, rst)
    _kernels.launch("fdct_quant", *_fdct_args(plane, tabs, out,
                                              out.numel() // 64))
    return out


def fdct_quant_probe(plane: torch.Tensor, tabs: ClassTables, rst: int,
                     stage: str) -> torch.Tensor:
    """fdct_quant's kernel cut to a decomposition stage
    (_kernels.PROBE_STAGES) for chip_smoke.py's probe; no codec path calls
    it.  Only the "full" stage's output is the coefficients."""
    out = _fdct_out(plane, rst)
    _kernels.probe("fdct_quant", stage, *_fdct_args(plane, tabs, out,
                                                    out.numel() // 64))
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


def stripe_markers(nseg: int, shard: int, device) -> torch.Tensor:
    """Second RST byte after each segment row of one scan's stripe of a
    frame cut into stripes of nseg segments of that scan (parallel.batch):
    0xD0 + (shard * nseg + s) % 8 after every row, the stripe's last
    included (gpujpeg_tpu.parallel.batch numbers them so; its stitch drops
    the frame's last), as (nseg,) int32."""
    s = torch.arange(nseg, device=device, dtype=torch.int64) + shard * nseg
    return (0xD0 + (s & 7)).to(torch.int32)


@functools.lru_cache(maxsize=16)
def _scan_markers(nseg: int, device) -> torch.Tensor:
    """segment_markers(nseg), made once per size and device: the markers
    of a call that gives none (read it, never write it)."""
    return segment_markers(nseg, device)


def _as_slots(tabs: Union[ClassTables, SlotTables]) -> SlotTables:
    return tabs if isinstance(tabs, SlotTables) else one_slot(tabs)


def _row_args(coefs: torch.Tensor, nblocks: Optional[int],
              st: SlotTables, markers, valid, row_luma):
    """Check the Huffman contract's arguments; -> (R, B, markers)."""
    R, C = coefs.shape
    B = C // 64
    if C % 64 or B % st.bpm or not 1 <= st.bpm <= 16:
        raise ValueError(f"rows of {C} coefficients do not hold whole MCUs "
                         f"of {st.bpm} blocks")
    if valid is None and (nblocks is None or not 0 < nblocks <= R * B):
        raise ValueError(f"{nblocks} blocks do not fit {R} rows of {B} "
                         "blocks")
    if valid is not None and tuple(valid.shape) != (R, B):
        raise ValueError(f"valid must be ({R}, {B})")
    if row_luma is not None and tuple(row_luma.shape) != (R,):
        raise ValueError(f"row_luma must be ({R},)")
    if markers is None:
        markers = _scan_markers(R, coefs.device)
    if tuple(markers.shape) != (R,):
        raise ValueError(f"markers must be ({R},)")
    return R, B, markers


def _block_masks(R: int, B: int, st: SlotTables, nblocks, valid, row_luma,
                 device):
    """(valid (R, B) bool, class (R, B) int64) of the Huffman contract."""
    if valid is None:
        valid = (torch.arange(R * B, device=device) < nblocks).reshape(R, B)
    slot = torch.tensor(st.slot_class, device=device).repeat(B // st.bpm)
    cls = slot[None, :].expand(R, B)
    if row_luma is not None:
        cls = torch.where(row_luma.to(device)[:, None] != 0, cls, 1)
    return valid.to(device) != 0, cls.to(torch.int64)


def segment_tokens(coefs: torch.Tensor, tabs, valid: torch.Tensor,
                   cls: torch.Tensor, dc_prev: Optional[torch.Tensor] = None):
    """Huffman tokens of rows in the slot layout of tabs (a SlotTables):
    each component's blocks of a row tokenized together (so its DC
    predictor runs over them, T.81 F.1.1.5.1), each block with its class
    cls (R, B) and valid mask valid (R, B), then put back in their slots
    -> (bits int64, lens int32), each (R, B*64): the XLA tokens of the
    JAX package's non-megakernel path (make_rows_tokens_impl, before
    pack_stuff_fused).  dc_prev (R, 4): the DC each component's first
    block of a row predicts from (None = 0: a row is a segment)."""
    st = _as_slots(tabs)
    R, C = coefs.shape
    B = C // 64
    x = coefs.reshape(R, B, 64)
    bits = torch.empty((R, B, 64), dtype=torch.int64, device=coefs.device)
    lens = torch.empty((R, B, 64), dtype=torch.int32, device=coefs.device)
    luts = [t.luts for t in st.classes]
    comp_of = np.tile(np.asarray(st.slot_comp), B // st.bpm)
    for comp in sorted(set(st.slot_comp)):
        cols = torch.from_numpy(np.flatnonzero(comp_of == comp)).to(
            coefs.device)
        b, ln = tokens.tokenize_rows(
            x[:, cols], luts, valid[:, cols], cls[:, cols],
            None if dc_prev is None else dc_prev[:, comp])
        bits[:, cols] = b.reshape(R, -1, 64)
        lens[:, cols] = ln.reshape(R, -1, 64)
    return bits.reshape(R, C), lens.reshape(R, C)


def huffman_segments_plain(coefs: torch.Tensor, nblocks: Optional[int],
                           tabs: Union[ClassTables, SlotTables],
                           markers: Optional[torch.Tensor] = None,
                           valid: Optional[torch.Tensor] = None,
                           row_luma: Optional[torch.Tensor] = None):
    """Plain version of huffman_segments, on any device: segment_tokens,
    then pack_rows, PLAIN_CHUNK_ROWS rows at a time."""
    st = _as_slots(tabs)
    dev = coefs.device
    R, B, markers = _row_args(coefs, nblocks, st, markers, valid, row_luma)
    stride = st.stride(B, row_luma is not None)
    ok, cls = _block_masks(R, B, st, nblocks, valid, row_luma, dev)
    rows = torch.zeros((R, stride), dtype=torch.uint8, device=dev)
    row_bytes = torch.zeros(R, dtype=torch.int32, device=dev)
    nff = torch.zeros(R, dtype=torch.int32, device=dev)
    for a in range(0, R, PLAIN_CHUNK_ROWS):
        sl = slice(a, min(R, a + PLAIN_CHUNK_ROWS))
        bits, lens = segment_tokens(coefs[sl], st, ok[sl], cls[sl])
        rows[sl], row_bytes[sl], nff[sl] = pack_rows(
            bits, lens, markers[sl], stride)
    needs = torch.zeros(2, dtype=torch.int32, device=dev)
    if R:
        needs = torch.stack([nff.max(), row_bytes.max()])
    return rows, row_bytes, needs


def huffman_segments(coefs: torch.Tensor, nblocks: Optional[int],
                     tabs: Union[ClassTables, SlotTables],
                     markers: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None,
                     row_luma: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, B*64) int16 coefficient rows -> (rows (R, stride) uint8,
    row_bytes (R,) int32, needs (2,) int32 = [max stuffed zeros, max row
    bytes]).

    tabs: one ClassTables (one component, one slot) or the SlotTables of
    the rows' MCU layout.  Validity: valid (R, B) bool/uint8, or else the
    first `nblocks` blocks.  row_luma: (R,) int32 class flag of each row
    (0 = classes[1] for every block), or None.  markers: (R,) int32 second
    RST byte after each row (0 = none), or None for segment_markers(R).
    The stride is tabs' worst case (SlotTables.stride)."""
    st = _as_slots(tabs)
    if coefs.device.type == "cpu":
        return huffman_segments_plain(coefs, nblocks, st, markers, valid,
                                      row_luma)
    out, args = _huffman_args(coefs, nblocks, st, markers, valid, row_luma)
    _kernels.launch("huffman_segments", *args)
    return out


def _huffman_args(coefs, nblocks, st, markers, valid, row_luma):
    """The outputs (rows, row_bytes, needs) and the C arguments of
    csrc/huffman_segments.cu."""
    R, B, markers = _row_args(coefs, nblocks, st, markers, valid, row_luma)
    stride = st.stride(B, row_luma is not None)
    dev = coefs.device
    rows = torch.empty((R, stride), dtype=torch.uint8, device=dev)
    row_bytes = torch.empty(R, dtype=torch.int32, device=dev)
    needs = torch.zeros(2, dtype=torch.int32, device=dev)
    opt = [t for t in (valid, row_luma) if t is not None]
    _kernels.require_cuda("huffman_segments", coefs, st.classes[0].luts,
                          st.classes[1].luts, markers, *opt, rows,
                          row_bytes, needs)
    if coefs.dtype != torch.int16 or markers.dtype != torch.int32:
        raise ValueError("huffman_segments takes int16 coefficients and "
                         "int32 markers")
    if coefs.data_ptr() % 16:
        raise ValueError("huffman_segments takes 16-byte aligned "
                         "coefficients")
    if valid is not None and valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError("huffman_segments takes a bool or uint8 mask")
    if row_luma is not None and row_luma.dtype != torch.int32:
        raise ValueError("huffman_segments takes int32 row class flags")
    luma_pat = sum(1 << j for j, k in enumerate(st.slot_class) if k == 0)
    comp_pat = sum(c << (2 * j) for j, c in enumerate(st.slot_comp))
    return (rows, row_bytes, needs), (
        coefs, R, B, nblocks or 0,
        valid.view(torch.uint8) if valid is not None else None,
        st.classes[0].luts, st.classes[1].luts, row_luma, st.bpm, luma_pat,
        comp_pat, markers, stride, rows, row_bytes, needs)


def huffman_segments_probe(coefs: torch.Tensor, nblocks: Optional[int],
                           tabs: Union[ClassTables, SlotTables],
                           stage: str, markers=None, valid=None,
                           row_luma=None):
    """huffman_segments' kernel cut to a decomposition stage
    (_kernels.PROBE_STAGES: the full kernel; the blocks' loads alone; all
    but the byte stores) for chip_smoke.py's probe; no codec path calls
    it.  Only the "full" stage's output is the rows."""
    out, args = _huffman_args(coefs, nblocks, _as_slots(tabs), markers,
                              valid, row_luma)
    _kernels.probe("huffman_segments", stage, *args)
    return out


def entropy_fused_u8(plane: torch.Tensor, tabs: ClassTables, rst: int):
    """One component's uint8 plane -> (rows, row_bytes, needs): the
    forward DCT + quantization, then the Huffman coder, with segments of
    `rst` blocks (gpujpeg_tpu.ops.fusedpack.entropy_fused_u8 for a
    non-interleaved scan)."""
    nblocks, _ = segment_count(plane, rst)
    return huffman_segments(fdct_quant(plane, tabs, rst), nblocks, tabs)


def entropy_fused(coefs: torch.Tensor, valid: torch.Tensor,
                  luma: torch.Tensor, markers: torch.Tensor,
                  classes: Tuple[ClassTables, ClassTables]):
    """Coefficient-input mode (gpujpeg_tpu.ops.fusedpack.entropy_fused):
    coefs (R, B*64) int16 zig-zag coefficients, one segment row each (the
    JAX function takes them transposed, a TPU layout); valid (R, B) block
    mask; luma (R,) int32, 1 where the row takes classes[0]; markers (R,)
    int32 second RST byte after each row (0 = none).  The DC predictor
    runs along each row.  -> (rows, row_bytes, needs)."""
    return huffman_segments(coefs, None, SlotTables(classes, (0,), (0,)),
                            markers, valid, luma)


def interleaved_slots(geo, classes: Tuple[ClassTables, ClassTables]
                      ) -> SlotTables:
    """The slot layout of an interleaved scan's rows: each component's
    sv x sh blocks of an MCU in (v, h) order, components in order (T.81
    A.2.3), each slot with its component's table class."""
    slot_class, slot_comp = [], []
    for c in geo.components:
        n = c.samp_v * c.samp_h
        slot_class += [c.table_index] * n
        slot_comp += [c.index] * n
    return SlotTables(classes, tuple(slot_class), tuple(slot_comp))


def interleaved_rows_plain(planes: List[torch.Tensor], geo,
                           classes: Tuple[ClassTables, ClassTables]
                           ) -> torch.Tensor:
    """Plain version of interleaved_rows, on any device: each plane's
    coefficients in raster order, then a copy into MCU order (the layout
    math of gpujpeg_tpu.models.encoder.make_rows_tokens_impl and
    make_rows_xbd_il_impl)."""
    S, rst, nmcu, bpm = (geo.segment_count, geo.segment_mcu_count,
                         geo.mcu_count, geo.blocks_per_mcu)
    dev = planes[0].device
    alloc = torch.zeros if S * rst > nmcu else torch.empty
    out = alloc((S * rst, bpm, 64), dtype=torch.int16, device=dev)
    off = 0
    for c in geo.components:
        n = c.samp_v * c.samp_h
        x = fdct_quant_plain(planes[c.index], classes[c.table_index],
                             1).reshape(c.mcu_count_y, c.samp_v,
                                        c.mcu_count_x, c.samp_h, 64)
        out[:nmcu, off:off + n] = x.permute(0, 2, 1, 3, 4).reshape(
            nmcu, n, 64)
        off += n
    return out.reshape(S, rst * bpm * 64)


def interleaved_rows(planes: List[torch.Tensor], geo,
                     classes: Tuple[ClassTables, ClassTables]
                     ) -> torch.Tensor:
    """An interleaved scan's quantized coefficients in stream order:
    (segments, restart interval * bpm * 64) int16, MCUs in raster order
    with each component's blocks at its slots (interleaved_slots), MCUs
    past the image zero.  On CUDA, one fdct_quant launch a component
    stores its blocks straight into their MCU slots (csrc/fdct_quant.cu's
    output map; the first launch zeroes the MCUs past the image)."""
    if planes[0].device.type == "cpu":
        return interleaved_rows_plain(planes, geo, classes)
    S, rst, bpm = (geo.segment_count, geo.segment_mcu_count,
                   geo.blocks_per_mcu)
    out = torch.empty((S * rst * bpm, 64), dtype=torch.int16,
                      device=planes[0].device)
    off = 0
    for c in geo.components:
        _kernels.launch("fdct_quant", *_fdct_args(
            planes[c.index], classes[c.table_index], out, S * rst * bpm,
            bpm, off, c.samp_h, c.samp_v, c.mcu_count_x))
        off += c.samp_v * c.samp_h
    return out.reshape(S, rst * bpm * 64)


def entropy_fused_u8_il(planes: List[torch.Tensor], geo,
                        classes: Tuple[ClassTables, ClassTables]):
    """An interleaved scan's uint8 planes -> (rows, row_bytes, needs) of
    its segment rows (gpujpeg_tpu.ops.fusedpack.entropy_fused_u8_il, which
    the JAX package runs at 1x1 sampling only; here any sampling whose
    MCU holds at most 16 blocks): fdct_quant per component into MCU
    order (interleaved_rows), then the slot-pattern Huffman coder."""
    return huffman_segments(interleaved_rows(planes, geo, classes),
                            geo.mcu_count * geo.blocks_per_mcu,
                            interleaved_slots(geo, classes),
                            segment_markers(geo.segment_count,
                                            planes[0].device))


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


def _pack_args(bits: torch.Tensor, lens: torch.Tensor,
               markers: torch.Tensor, stride: int):
    """The outputs and C arguments of csrc/pack_stuff_rows.cu."""
    R, T = bits.shape
    rows = torch.empty((R, stride), dtype=torch.uint8, device=bits.device)
    row_bytes = torch.empty(R, dtype=torch.int32, device=bits.device)
    needs = torch.zeros(2, dtype=torch.int32, device=bits.device)
    _kernels.require_cuda("pack_stuff_rows", bits, lens, markers, rows,
                          row_bytes, needs)
    if (bits.dtype != torch.int32 or lens.dtype != torch.int32
            or markers.dtype != torch.int32 or T % 4 or stride % 4):
        raise ValueError("pack_stuff_rows takes int32 tensors, T and the "
                         "stride multiples of 4")
    if bits.data_ptr() % 16 or lens.data_ptr() % 16:
        raise ValueError("pack_stuff_rows reads bits and lens 16 bytes at "
                         "a time: both must be 16-byte aligned")
    return (rows, row_bytes, needs), (bits, lens, R, T, markers, stride,
                                      rows, row_bytes, needs)


def _pack_shapes(bits: torch.Tensor, lens: torch.Tensor,
                 markers: torch.Tensor) -> None:
    R, T = bits.shape
    if tuple(lens.shape) != (R, T) or tuple(markers.shape) != (R,):
        raise ValueError("pack_stuff_rows: bits and lens must be (R, T), "
                         "markers (R,)")


def pack_stuff_rows(bits: torch.Tensor, lens: torch.Tensor,
                    markers: torch.Tensor, stride: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token rows -> stuffed byte rows (the JAX package's pack_stuff_fused
    without its capacities): bits/lens (R, T) int32 right-aligned tokens of
    at most 27 bits and their lengths (0 = no token), markers (R,) int32
    second RST byte after each row (0 = none), stride a worst case for the
    rows (pack_stride) -> (rows (R, stride) uint8, row_bytes (R,) int32,
    needs (2,) int32 = [max stuffed zeros, max row bytes])."""
    _pack_shapes(bits, lens, markers)
    if bits.device.type == "cpu":
        return pack_stuff_rows_plain(bits, lens, markers, stride)
    out, args = _pack_args(bits, lens, markers, stride)
    _kernels.launch("pack_stuff_rows", *args, instance="rows")
    return out


def scan_chunks(n: int) -> int:
    """Chunks (CTAs) of the packer's scan instance for n tokens."""
    return max(1, -(-n // SCAN_CHUNK_TOKENS))


def pack_stuff_scan_plain(bits: torch.Tensor, lens: torch.Tensor,
                          marker: int, stride: int):
    """Plain version of pack_stuff_scan, on any device: the tokens as one
    padded (1, T) row through pack_stuff_rows_plain."""
    n = int(bits.shape[0])
    T = max(4, -(-n // 4) * 4)
    b = torch.zeros((1, T), dtype=torch.int32, device=bits.device)
    ln = torch.zeros((1, T), dtype=torch.int32, device=bits.device)
    b[0, :n] = bits
    ln[0, :n] = lens
    markers = torch.full((1,), marker, dtype=torch.int32,
                         device=bits.device)
    return pack_stuff_rows_plain(b, ln, markers, stride)


def pack_stuff_scan(bits: torch.Tensor, lens: torch.Tensor, marker: int,
                    stride: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One row of n tokens (a scan coded as one segment): bits/lens (n,)
    int32 right-aligned tokens of at most 27 bits and their lengths (0 =
    no token), `marker` the second RST byte after the row (0 = none),
    stride at least the row's worst case -> (rows (1, stride) uint8,
    row_bytes (1,) int32, needs (2,) int32), as pack_stuff_rows gives them
    for the tokens as one row.  On CUDA the packer's scan instance
    (csrc/pack_stuff_rows.cu, chunks of SCAN_CHUNK_TOKENS tokens a CTA,
    64-bit offsets: any scan that fits on the card); for CPU tensors its
    plain version."""
    if bits.dim() != 1 or tuple(lens.shape) != tuple(bits.shape):
        raise ValueError("pack_stuff_scan: bits and lens must be (n,)")
    if bits.device.type == "cpu":
        return pack_stuff_scan_plain(bits, lens, marker, stride)
    if bits.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("pack_stuff_scan takes int32 tensors")
    n = int(bits.shape[0])
    dev = bits.device
    rows = torch.empty((1, stride), dtype=torch.uint8, device=dev)
    row_bytes = torch.empty(1, dtype=torch.int32, device=dev)
    needs = torch.zeros(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(SCAN_HEAD + SCAN_REC * scan_chunks(n),
                          dtype=torch.int64, device=dev)
    _kernels.require_cuda("pack_stuff_rows", bits, lens, rows, row_bytes,
                          needs, scratch)
    _kernels.launch("pack_stuff_scan", bits, lens, n, int(marker), rows,
                    row_bytes, needs, scratch, instance="scan")
    return rows, row_bytes, needs


def pack_stuff_rows_probe(bits: torch.Tensor, lens: torch.Tensor,
                          markers: torch.Tensor, stride: int, stage: str):
    """pack_stuff_rows' kernel cut to a decomposition stage
    (_kernels.PROBE_STAGES: the full kernel; the lengths and the bits of
    the quads that hold tokens loaded, nothing coded; all but the byte
    stores) for chip_smoke.py's probe; no codec path calls it.  Only the
    "full" stage's output is the rows."""
    _pack_shapes(bits, lens, markers)
    out, args = _pack_args(bits, lens, markers, stride)
    _kernels.probe("pack_stuff_rows", stage, *args)
    return out


def _token_chunks(coefs: torch.Tensor, st: SlotTables, valid: torch.Tensor,
                  cls: torch.Tensor, dc_prev: Optional[torch.Tensor] = None):
    """segment_tokens of the rows a chunk of TOKEN_CHUNK_SLOTS slots at a
    time: yields (row slice, bits int64, lens int32)."""
    R, C = coefs.shape
    step = max(1, TOKEN_CHUNK_SLOTS // max(C, 1))
    for a in range(0, R, step):
        sl = slice(a, min(R, a + step))
        bits, lens = segment_tokens(coefs[sl], st, valid[sl], cls[sl],
                                    None if dc_prev is None else dc_prev[sl])
        yield sl, bits, lens


def rows_tokens(coefs: torch.Tensor, tabs, valid: torch.Tensor,
                cls: torch.Tensor):
    """segment_tokens of coefficient rows in the slot layout of tabs, a
    chunk at a time, as the token-row packer takes them: (bits, lens),
    int32 (R, B*64) (a token has at most 27 bits)."""
    st = _as_slots(tabs)
    bits = torch.empty(coefs.shape, dtype=torch.int32, device=coefs.device)
    lens = torch.empty_like(bits)
    for sl, b, ln in _token_chunks(coefs, st, valid, cls):
        bits[sl] = b.to(torch.int32)
        lens[sl] = ln
    return bits, lens


def entropy_tokens(coefs: torch.Tensor, nblocks: int,
                   tabs: Union[ClassTables, SlotTables],
                   markers: Optional[torch.Tensor] = None):
    """(R, B*64) int16 coefficient rows, the first nblocks blocks real ->
    (rows, row_bytes, needs) as huffman_segments gives them, through the
    JAX package's non-megakernel route (make_rows_tokens_impl, then
    pack_stuff_fused): the tokenizer (rows_tokens), then the token-row
    packer (pack_stuff_rows) at tabs' worst-case stride.  The route of
    every table family; the encoder takes it for Annex-K tables, whose
    codes the Huffman kernel's tuned contract does not compute."""
    st = _as_slots(tabs)
    R, B, markers = _row_args(coefs, nblocks, st, markers, None, None)
    ok, cls = _block_masks(R, B, st, nblocks, None, None, coefs.device)
    bits, lens = rows_tokens(coefs, st, ok, cls)
    return pack_stuff_rows(bits, lens, markers, st.stride(B))


def scan_tokens(coefs: torch.Tensor, nblocks: int,
                tabs: Union[ClassTables, SlotTables]):
    """The tokens of one scan coded as a single segment (restart interval
    0): coefs holds the scan's blocks in stream order (any row shape,
    nblocks real blocks of the slot layout of tabs) -> (bits, lens), int32
    1-D on the coefficients' device, only the slots that hold a token, in
    stream order (what native.pack_tokens packs; the JAX package's
    make_rows_tokens_impl(as_list=True) gives the same tokens with the
    empty slots).  The scan is cut into rows of SCAN_ROW_MCUS MCUs (the
    last padded with blocks that emit nothing) and tokenized a chunk of
    rows at a time; each component's first block of a row predicts its
    DC from the component's last block of the row before."""
    st = _as_slots(tabs)
    dev = coefs.device
    per = SCAN_ROW_MCUS * st.bpm             # blocks a row
    flat = coefs.reshape(-1, 64)[:nblocks]
    R = max(1, -(-nblocks // per))
    rows = torch.zeros((R * per, 64), dtype=coefs.dtype, device=dev)
    rows[:nblocks] = flat
    rows = rows.reshape(R, per * 64)
    ok, cls = _block_masks(R, per, st, nblocks, None, None, dev)
    # each component's DC predictor at a row's start: the DC of its last
    # slot in the row before
    comp_of = np.tile(np.asarray(st.slot_comp), SCAN_ROW_MCUS)
    dc_prev = torch.zeros((R, 4), dtype=torch.int32, device=dev)
    for comp in sorted(set(st.slot_comp)):
        last = int(np.flatnonzero(comp_of == comp)[-1])
        dc_prev[1:, comp] = rows[:-1, 64 * last].to(torch.int32)
    bits, lens = [], []
    for _sl, b, ln in _token_chunks(rows, st, ok, cls, dc_prev):
        keep = ln > 0
        bits.append(b[keep].to(torch.int32))
        lens.append(ln[keep])
    return torch.cat(bits), torch.cat(lens)


def scan_rows(bits: torch.Tensor, lens: torch.Tensor, nblocks: int,
              tabs: Union[ClassTables, SlotTables], marker: int = 0):
    """One scan coded as a single segment (restart interval 0) as one
    device row: scan_tokens' (bits, lens) of a scan of nblocks blocks ->
    (rows (1, stride) uint8, row_bytes (1,) int32, needs) through the
    token-row packer's scan instance (pack_stuff_scan: chunks of the scan
    a CTA), at the scan's worst-case stride (SlotTables.stride of its
    blocks), with an RST marker of second byte `marker` after the row (0 =
    none)."""
    st = _as_slots(tabs)
    stride = st.stride(-(-nblocks // st.bpm) * st.bpm)
    return pack_stuff_scan(bits, lens, marker, stride)
