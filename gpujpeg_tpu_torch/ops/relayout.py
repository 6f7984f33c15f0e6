"""Relayout and primitive kernels: the H100 counterparts of the JAX
package's TPU probes in tools/ (csrc/relayout.cu).

  xbd_relayout   tools/proto_xbdkernel.py (make_fn), tools/profile_transpose.py
                 (pallas_t): a packed u32 plane (H, W/4) to the entropy
                 megakernel's feed layout xbd (rst*16, nbh*nsr), the XLA
                 relayout of gpujpeg_tpu.models.encoder's planar feed
  transpose_u32  tools/profile_transpose.py (pallas_2d), tools/profile_prims.py
                 (f_t): a 2-D transpose
  pair_sum_rows  tools/profile_prims.py (f_s2): x[0::2] + x[1::2] with
                 32-bit wraparound, the decimation primitive
  pack_u8_quads  tools/profile_prims.py (f_b): the low bytes of rows 4i ..
                 4i + 3 into one word, row 4i in the low byte

The last two run on a grid of the CTAs that fit on the card, each a band
of output rows, with 16-byte streaming loads and stores where row_vector
allows.

No codec path calls them: the port's interleaved feed relayout is
fdct_quant's MCU-order store (fusedpack.interleaved_rows).  Words are u32
bit patterns held in int32 tensors.  For CPU tensors each wrapper runs its
plain version; for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from . import _kernels


def _check(name: str, x: torch.Tensor, rows_multiple: int = 1) -> None:
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"{name} takes a 2-D int32 tensor of u32 words")
    if x.shape[0] % rows_multiple:
        raise ValueError(f"{name} takes a multiple of {rows_multiple} rows")


def _as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their u32 bit patterns as int32."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def xbd_relayout_plain(p32: torch.Tensor, rst: int) -> torch.Tensor:
    """Plain version of xbd_relayout, on any device (tools/
    proto_xbdkernel.py xla_relayout)."""
    H, W4 = p32.shape
    nbh, nsr = H // 8, W4 // (2 * rst)
    return p32.reshape(nbh, 8, nsr, rst, 2).permute(3, 1, 4, 0, 2).reshape(
        rst * 16, nbh * nsr)


def xbd_vector(p32: torch.Tensor, rst: int) -> bool:
    """Whether xbd_relayout's kernel takes a 16-byte vector instance for
    p32: nsr = W/(8 rst) segments a block row a multiple of 4 (every input
    run and output row then starts on 16 bytes) and p32 16-byte aligned
    (the output is a fresh allocation); else its generic instance, a word
    an access.  The C entry (csrc/relayout.cu gj_xbd_relayout) applies
    the same rule to both tensors, and at rst 8 takes the vector instance
    built for that rst."""
    return (p32.shape[1] // (2 * rst)) % 4 == 0 and p32.data_ptr() % 16 == 0


def xbd_relayout(p32: torch.Tensor, rst: int) -> torch.Tensor:
    """(H, W/4) words, H a multiple of 8 and W/4 of 2 rst -> (rst*16,
    nbh*nsr): out[b*16 + r*2 + k, g*nsr + sr] = p32[g*8 + r,
    (sr*rst + b)*2 + k], nbh = H/8 block rows of nsr = W/(8 rst) segments
    of rst blocks."""
    _check("xbd_relayout", p32, 8)
    if rst < 1 or p32.shape[1] % (2 * rst):
        raise ValueError("xbd_relayout: W/4 must be a multiple of 2 rst")
    if p32.device.type == "cpu":
        return xbd_relayout_plain(p32, rst)
    H, W4 = p32.shape
    out = torch.empty((rst * 16, H // 8 * (W4 // (2 * rst))),
                      dtype=torch.int32, device=p32.device)
    _kernels.require_cuda("xbd_relayout", p32, out)
    _kernels.launch("xbd_relayout", p32, H, W4, rst, out)
    return out


def transpose_u32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of transpose_u32, on any device."""
    return x.t().contiguous()


def transpose_u32(x: torch.Tensor) -> torch.Tensor:
    """(R, C) words -> (C, R)."""
    _check("transpose_u32", x)
    if x.device.type == "cpu":
        return transpose_u32_plain(x)
    R, C = x.shape
    out = torch.empty((C, R), dtype=torch.int32, device=x.device)
    _kernels.require_cuda("transpose_u32", x, out)
    _kernels.launch("transpose_u32", x, R, C, out)
    return out


def row_vector(x: torch.Tensor) -> bool:
    """Whether pair_sum_rows and pack_u8_quads take their vector instance
    (16-byte streaming loads and stores, the loads of 4 output chunks a
    thread in flight) for x: C % 4 == 0 and x 16-byte aligned (the output
    is a fresh allocation); else their generic instance, a word an
    access.  The C entries (csrc/relayout.cu rows_entry) apply the same
    rule to both tensors."""
    return x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0


def _rows(name: str, x: torch.Tensor, fold: int, launch) -> torch.Tensor:
    R, C = x.shape
    out = torch.empty((R // fold, C), dtype=torch.int32, device=x.device)
    _kernels.require_cuda(name, x, out)
    launch(name, x, R, C, out)
    return out


def empty_launch(name: str, x: torch.Tensor) -> None:
    """An empty kernel launched as kernel `name` (pair_sum_rows or
    pack_u8_quads) would be for the CUDA tensor x: the same path, grid and
    block (chip_smoke.py's floor of a launch); not counted."""
    fold = {"pair_sum_rows": 2, "pack_u8_quads": 4}[name]
    _check(name, x, fold)
    _rows(name, x, fold, _kernels.empty)


def pair_sum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of pair_sum_rows, on any device: the sums in int64,
    then cut to 32 bits."""
    return _as_i32((x[0::2].long() + x[1::2].long()) & 0xFFFFFFFF)


def pair_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """(R, C) words, R even -> (R/2, C): x[0::2] + x[1::2] as u32 with
    wraparound."""
    _check("pair_sum_rows", x, 2)
    if x.device.type == "cpu":
        return pair_sum_rows_plain(x)
    return _rows("pair_sum_rows", x, 2, _kernels.launch)


def pack_u8_quads_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of pack_u8_quads, on any device (the formula of
    tools/profile_prims.py's check)."""
    a = x.long() & 255
    return _as_i32(a[0::4] | a[1::4] << 8 | a[2::4] << 16 | a[3::4] << 24)


def pack_u8_quads(x: torch.Tensor) -> torch.Tensor:
    """(R, C) words, R a multiple of 4 -> (R/4, C): word (i, j) holds the
    low bytes of x[4i, j] .. x[4i + 3, j], x[4i, j] in the low byte."""
    _check("pack_u8_quads", x, 4)
    if x.device.type == "cpu":
        return pack_u8_quads_plain(x)
    return _rows("pack_u8_quads", x, 4, _kernels.launch)
