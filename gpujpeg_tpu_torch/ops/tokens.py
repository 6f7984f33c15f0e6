"""Huffman tokenization of segment rows in plain PyTorch.

The semantics of the JAX package's entropy megakernel tokenizer
(gpujpeg_tpu.ops.fusedpack._entropy_kernel_body): each of the 64 zig-zag
slots of every block emits zero or one token of at most 27 bits,

  slot 0:            DC code (size category of the DC difference to the
                     previous block of the row; the first block predicts
                     from 0) + value bits
  slot i, coef != 0: AC code ((run & 15) << 4 | size) + value bits
  slot i, coef == 0: ZRL (0xF0) iff this zero is the 16th/32nd/48th of its
                     run *and* a nonzero coefficient follows in the block
  slot 63, coef==0:  EOB (0x00)
  otherwise:         nothing (length 0)

with value bits vb = (v < 0 ? v - 1 : v) & ((1 << size) - 1).  A block that
is not valid emits nothing, but its DC still feeds the next block's
difference (the megakernel forms the difference before it applies its
valid mask).  This is the plain version of the token walk inside the CUDA
Huffman kernel (csrc/huffman_segments.cu), which makes the same tokens
sequentially; ops/fusedpack.segment_tokens runs it once per component of
a row and interleaves the results.  It is the port of the JAX package's
XLA tokenizer (gpujpeg_tpu.ops.tokens.tokenize_rows) without its pairs
mode, a TPU pre-merge that changes no byte.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

#: words of one table class: DC entries at [0, 16) (12 used), AC at
#: [16, 272), each (len << 16 | code)
LUT_WORDS = 272


def tokenize_rows(rows: torch.Tensor, luts: Sequence[torch.Tensor],
                  valid: torch.Tensor,
                  cls: Optional[torch.Tensor] = None,
                  dc_prev: Optional[torch.Tensor] = None):
    """Tokenize restart-segment rows whose blocks all take one DC
    predictor (one component).

    rows:  (R, B, 64) integer quantized zig-zag coefficients, one restart
           segment per row, blocks in stream order
    luts:  the (272,) integer (len << 16 | code) table of each table
           class (LUT_WORDS layout)
    valid: (R, B) bool, the blocks that emit tokens
    cls:   (R, B) integer table class of each block (index into luts);
           None = class 0 everywhere
    dc_prev: (R,) integer DC that each row's first block predicts from
           (the row continues one before it, as the rows of a scan cut
           into pieces do); None = 0, a row is a restart segment

    Returns (bits, lens): (R, B*64) int64 right-aligned code-then-value
    bits and int32 bit lengths (0 = no token in that slot).
    """
    dev = rows.device
    R, B, _ = rows.shape
    v = rows.to(torch.int32)
    dc = v[:, :, 0]
    pred = F.pad(dc, (1, 0))[:, :-1]
    if dc_prev is not None:
        pred[:, 0] = dc_prev.to(dev, torch.int32)
    v = torch.cat([(dc - pred)[..., None], v[..., 1:]], dim=2)

    av = v.abs()
    # bit-size category: the frexp exponent is exact for |v| < 2^24 and 0
    # for v == 0
    size = torch.frexp(av.to(torch.float32))[1].to(torch.int32)
    mask = (torch.ones_like(size) << size) - 1
    vb = torch.where(v < 0, v - 1, v) & mask

    zz = torch.arange(64, device=dev, dtype=torch.int32)
    is_dc = zz == 0
    nz = v != 0
    marker = torch.where(nz | is_dc, zz, torch.full_like(v, -1))
    last_incl = torch.cummax(marker, dim=2).values
    last_before = F.pad(last_incl, (1, 0))[..., :-1]   # slot 0: unused
    run = zz - last_before - 1
    zri = zz - last_before                    # zeros up to and incl. slot
    has_after = last_incl[..., 63:64] > zz

    is_code = nz & ~is_dc
    is_zrl = ~nz & ~is_dc & has_after & ((zri & 15) == 0)
    is_eob = ~nz & (zz == 63)

    sym = torch.where(is_code, ((run & 15) << 4) | torch.clamp(size, max=15),
                      torch.where(is_zrl, 0xF0, 0))
    idx = torch.where(is_dc, torch.clamp(size, max=11), 16 + sym).long()
    table = torch.stack([t.to(dev, torch.int64) for t in luts]).reshape(-1)
    if cls is not None:
        idx = idx + cls.to(dev, torch.int64)[..., None] * LUT_WORDS
    entry = table[idx]
    clen = (entry >> 16).to(torch.int32)
    code = entry & 0xFFFF

    token = (is_dc | is_code | is_zrl | is_eob) & valid.to(dev)[..., None]
    lens = torch.where(token, clen + size, 0)
    bits = torch.where(token, (code << size.long()) | vb.long(), 0)
    return bits.reshape(R, B * 64), lens.reshape(R, B * 64)
