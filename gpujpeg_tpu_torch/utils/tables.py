"""JPEG quantization + Huffman table math (pure NumPy, computed at init).

The subset of ``gpujpeg_tpu.utils.tables`` that the port's encode and
decode paths use, copied so that the PyTorch port never imports the JAX
package.  Behavioral parity with the
reference table layer (src/gpujpeg_table.c):
  - default quant tables + IJG quality scaling  (gpujpeg_table.c:36-99)
  - Annex-K default Huffman bits/values          (gpujpeg_table.c:189-256)
  - canonical Huffman code construction (C.1-3)  (gpujpeg_table.c:264-306)
  - the tuned AC code family the encoder writes by default

Everything returned is a numpy array; the kernels receive copies on the
device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

# --- zig-zag -----------------------------------------------------------------

#: natural (row-major) index for each zig-zag position ("order_natural",
#: gpujpeg_table.h:73-84 without its 16 safety entries — our vectorized
#: decoder cannot overrun).
ZIGZAG_TO_NATURAL = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

#: zig-zag position for each natural index (inverse permutation)
NATURAL_TO_ZIGZAG = np.argsort(ZIGZAG_TO_NATURAL).astype(np.int32)


# --- quantization ------------------------------------------------------------

#: default luminance quant table, zig-zag order (gpujpeg_table.c:36-45)
DEFAULT_QUANT_LUMA_ZZ = np.array([
    16, 11, 12, 14, 12, 10, 16, 14,
    13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37,
    29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68,
    87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113,
    121, 112, 100, 120, 92, 101, 103, 99,
], dtype=np.int64)

#: default chrominance quant table, zig-zag order (gpujpeg_table.c:47-56)
DEFAULT_QUANT_CHROMA_ZZ = np.array([
    17, 18, 18, 24, 21, 24, 47, 26,
    26, 47, 99, 66, 56, 66, 99, 99,
] + [99] * 48, dtype=np.int64)


def quant_table_zz(luma: bool, quality: int) -> np.ndarray:
    """Quality-scaled quant table in zig-zag order.

    IJG scaling: s = q<50 ? 5000/q : 200-2q; v = (s*t+50)/100, clamped [1,255]
    (gpujpeg_table.c:83-99).
    """
    quality = min(max(quality, 1), 100)
    s = (5000 // quality) if quality < 50 else (200 - 2 * quality)
    base = DEFAULT_QUANT_LUMA_ZZ if luma else DEFAULT_QUANT_CHROMA_ZZ
    v = (s * base + 50) // 100
    return np.clip(v, 1, 255).astype(np.int32)


def quant_table_natural(luma: bool, quality: int) -> np.ndarray:
    """Quality-scaled table in natural (row-major) order, shape (8, 8)."""
    zz = quant_table_zz(luma, quality)
    nat = np.zeros(64, dtype=np.int32)
    nat[ZIGZAG_TO_NATURAL] = zz
    return nat.reshape(8, 8)


# --- DCT matrices -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def dct8_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D, float64. y = D @ x."""
    k = np.arange(8)
    D = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    D[0] *= 1 / np.sqrt(2)
    return (D * 0.5).astype(np.float64)


@functools.lru_cache(maxsize=None)
def dct2d_matrix_zz() -> np.ndarray:
    """(64, 64) matrix M with zig-zag output ordering.

    For a row-major flattened 8x8 block x (float, level-shifted), the 2D DCT
    coefficients in zig-zag order are  x_flat @ M.
    M[(i*8+j), zz(u,v)] = D[u,i] * D[v,j].

    This is the TPU-idiomatic formulation of the reference's warp-based AAN
    kernel (gpujpeg_dct_gpu.cu:163-294): one big MXU matmul instead of
    register shuffles; the quantizer reciprocals get folded into the columns
    by the caller, mirroring the pre-divided table trick (gpujpeg_table.c:111-120).
    """
    D = dct8_matrix()
    # M_nat[(i*8+j), (u*8+v)] = D[u, i] * D[v, j]
    M = np.einsum("ui,vj->ijuv", D, D).reshape(64, 64)
    return M[:, ZIGZAG_TO_NATURAL]


@functools.lru_cache(maxsize=None)
def idct2d_matrix_zz() -> np.ndarray:
    """(64, 64) matrix N: for zig-zag DCT coefficients y (dequantized),
    x_flat_rowmajor = y_zz @ N.  N = transpose of dct2d_matrix_zz
    (orthonormal)."""
    return dct2d_matrix_zz().T.copy()


def fdct_fused_matrix(qtab_zz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Fused forward DCT+quant matrix and DC bias.

    Returns (Mq, bias):  quantized_zz = round(x_u8_flat @ Mq + bias)
    where x_u8_flat is the *unshifted* uint8 block; the -128 level shift is
    folded into `bias` (reference folds it into the first DCT pass,
    gpujpeg_dct_gpu.cu:251-261).
    """
    M = dct2d_matrix_zz()
    Mq = (M / qtab_zz[None, :].astype(np.float64)).astype(np.float32)
    # level shift: (x-128) @ Mq = x @ Mq - 128 * colsum(Mq)
    bias = (-128.0 * M.sum(axis=0) / qtab_zz).astype(np.float32)
    return Mq, bias

# --- Huffman tables ------------------------------------------------------------

#: Annex-K default tables: (bits[1..16], values) (gpujpeg_table.c:189-256)
HUFF_DC_LUMA = (
    np.array([0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], np.int32),
    np.arange(12, dtype=np.int32),
)
HUFF_DC_CHROMA = (
    np.array([0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], np.int32),
    np.arange(12, dtype=np.int32),
)
HUFF_AC_LUMA = (
    np.array([0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], np.int32),
    np.array([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
        0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
        0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
        0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
        0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
        0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
        0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
        0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
        0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
        0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
        0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
        0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
        0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
        0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
        0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
        0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ], np.int32),
)
HUFF_AC_CHROMA = (
    np.array([0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], np.int32),
    np.array([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
        0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
        0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
        0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
        0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
        0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
        0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
        0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
        0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
        0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
        0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
        0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
        0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
        0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
        0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
        0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ], np.int32),
)


def huffman_canonical(bits: np.ndarray, values: np.ndarray):
    """Canonical Huffman code construction (ITU-T T.81 C.1-C.3,
    gpujpeg_table.c:264-306).

    Returns (symbols, code_lengths, codes) as parallel int arrays.
    """
    lengths = []
    for l in range(1, 17):
        lengths.extend([l] * int(bits[l]))
    lengths = np.asarray(lengths, dtype=np.int32)
    assert len(lengths) == len(values), (len(lengths), len(values))
    codes = np.zeros(len(lengths), dtype=np.int64)
    code = 0
    si = lengths[0] if len(lengths) else 0
    k = 0
    while k < len(lengths):
        while k < len(lengths) and lengths[k] == si:
            codes[k] = code
            code += 1
            k += 1
        code <<= 1
        si += 1
    return np.asarray(values, dtype=np.int32), lengths, codes.astype(np.int64)


def huffman_encode_lut(bits: np.ndarray, values: np.ndarray, size: int) -> np.ndarray:
    """Encoder LUT indexed by JPEG symbol (run<<4|size for AC, size for DC).

    Entry layout: uint32 = (code_len << 16) | code.  Mirrors the packed LUT
    idea of the reference encoder (gpujpeg_huffman_gpu_encoder.cu:956-969)
    with a layout natural for 32-bit TPU lanes.
    """
    syms, lens, codes = huffman_canonical(bits, values)
    lut = np.zeros(size, dtype=np.uint32)
    lut[syms] = (lens.astype(np.uint32) << 16) | codes.astype(np.uint32)
    return lut


def huffman_decode_spec(bits: np.ndarray, values: np.ndarray):
    """Canonical decode parameters (F.15/F.16, gpujpeg_table.c:383-449).

    Returns (maxcode16, valoff, huffval16):
      maxcode16: (17,) int64 — largest 16-bit-LEFT-ALIGNED code of each
                 length; -1 where the length has no codes
      valoff:    (17,) int32 — valptr[l] - mincode[l], so that
                 symbol_index = (peek16 >> (16-l)) + valoff[l]
      huffval16: (11, 16) int32 — symbol values, zero-padded
    """
    syms, lens, codes = huffman_canonical(bits, values)
    maxcode16 = np.full(17, -1, dtype=np.int64)
    valoff = np.zeros(17, dtype=np.int64)
    k = 0
    for l in range(1, 17):
        n = int(bits[l])
        if n == 0:
            continue
        mincode = codes[k]
        maxcode = codes[k + n - 1]
        valoff[l] = k - mincode
        maxcode16[l] = (int(maxcode) << (16 - l)) | ((1 << (16 - l)) - 1)
        k += n
    hv = np.zeros(11 * 16, dtype=np.int32)
    hv[: len(values)] = np.asarray(values[: len(syms)], dtype=np.int32)
    return (maxcode16.astype(np.int64), valoff.astype(np.int32),
            hv.reshape(11, 16))


#: int32 entries of one kernel decode table (kernel_decode_table)
DECODE_TABLE_WORDS = 17 + 17 + 256


def kernel_decode_table(bits, values) -> np.ndarray:
    """One Huffman table as the port's decode kernels take it:
    int32[DECODE_TABLE_WORDS] = mono[17] | valoff[17] | huffval[256].

    mono is maxcode16 with empty lengths back-filled by the previous
    length's value, so for a left-aligned 16-bit peek the code length is
    clen = 1 + #{l in 1..15 : peek16 > mono[l]} and the code is invalid
    when peek16 > mono[16]; the symbol is huffval[(peek16 >> (16 - clen))
    + valoff[clen]].  Any baseline DHT table fits (at most 256 symbols).
    """
    bits = np.asarray(bits, np.int64)
    values = np.asarray(values, np.int64)
    maxcode16, valoff, _hv = huffman_decode_spec(bits, values)
    mono = np.asarray(maxcode16, np.int64).copy()
    mono[0] = -1
    for l in range(1, 17):
        if mono[l] < 0:
            mono[l] = mono[l - 1]
    hv = np.zeros(256, np.int64)
    hv[:len(values)] = values
    return np.concatenate([mono, np.asarray(valoff, np.int64),
                           hv]).astype(np.int32)

def huffman_spec_for(table_class: str, luma: bool):
    """(bits, values) for the default table of a class ('dc'|'ac')."""
    if table_class == "dc":
        return HUFF_DC_LUMA if luma else HUFF_DC_CHROMA
    if table_class == "ac":
        return HUFF_AC_LUMA if luma else HUFF_AC_CHROMA
    raise ValueError(table_class)


# --- Tuned computable AC tables (the "tuned" family) ---------------------------
#
# The reference encodes AC symbols through a 256-entry LUT
# (gpujpeg_huffman_gpu_encoder.cu:956-969) — a single shared-memory gather
# on a GPU, but ~256 vector selects per coefficient on a TPU (the dominant
# encode cost).  The TPU-native answer is to make the CODE computable: we
# emit custom canonical Huffman tables whose AC code lengths follow
#
#     run  0    : len = l0[size]                    (free, exact lookup)
#     run >= 1  : len = min(16, r_len[run] + size)  (affine in size)
#
# with r_len monotone nondecreasing over runs 1..15, plus free-standing
# EOB and ZRL lengths.  With symbols canonically ordered (within a length
# class: EOB, ZRL, run-0 by size, then (run, size) ascending), the code
# VALUE for runs >= 1 collapses to arithmetic on two 16-entry lookups:
#
#     l < 16 :  code = A[l]   + run        (A per length class)
#     l >= 16:  code = B[run] + size       (B per run, class-16 ranks)
#
# and run 0 is one 16-entry lookup on size.  ~70 vector ops per
# coefficient instead of ~270 for the dense 256-entry select chain.
#
# Parameters are tuned per quality bucket (tools/design_tables.py:
# package-merge over the 27 entities, isotonic projection, greedy polish)
# on a mixed photographic+synthetic corpus.  Recorded end-to-end sizes
# (QUALITY.json, tools/quality_sweep.py, HD+4K synthetic photographic
# frames): tuned vs Annex-K = -18.8% at Q10, -13.9% Q20, -4.2% Q50,
# -6.8% Q100; roughly neutral in the Q70-Q90 band (worst +1.8% at Q80)
# — the per-quality fit pays most where Annex-K's generic code lengths
# are furthest from the realized symbol statistics.  The resulting
# (bits, values) arrays are ordinary DHT payloads: any JPEG decoder
# interoperates.  The Kraft budget reserves the all-ones code (T.81
# F.1.2.3 padding safety, like libjpeg's dummy-symbol trick).

#: {(quality_bucket, 'luma'|'chroma'): (r_len[16], l0[10], len_eob,
#: len_zrl)} — trained by tools/design_tables.py; regenerate there
AFFINE_AC_PARAMS = {
    (10, "chroma"): ([1, 3, 5, 5, 7, 7, 8, 8, 8, 9, 10, 10, 10, 12, 14,
                      14], [3, 4, 5, 5, 6, 7, 8, 10, 11, 12], 1, 11),
    (10, "luma"): ([1, 3, 4, 5, 7, 7, 7, 9, 10, 11, 11, 11, 12, 12, 14,
                    14], [3, 4, 5, 6, 7, 7, 9, 12, 15, 15], 1, 13),
    (25, "chroma"): ([1, 3, 5, 6, 7, 8, 8, 9, 10, 11, 12, 12, 12, 12, 14,
                      14], [2, 5, 7, 7, 8, 8, 9, 12, 12, 14], 1, 12),
    (25, "luma"): ([1, 3, 4, 5, 6, 7, 7, 9, 9, 10, 10, 10, 10, 10, 11,
                    13], [2, 3, 4, 5, 6, 8, 10, 11, 14, 14], 2, 11),
    (50, "chroma"): ([1, 3, 4, 4, 6, 7, 8, 8, 9, 10, 10, 10, 10, 12, 16,
                      16], [2, 3, 4, 7, 7, 8, 8, 11, 12, 14], 2, 11),
    (50, "luma"): ([1, 3, 4, 5, 6, 7, 7, 7, 8, 8, 9, 10, 11, 11, 14, 16],
                   [2, 3, 4, 5, 7, 9, 10, 12, 14, 14], 2, 12),
    (75, "chroma"): ([1, 3, 5, 6, 7, 8, 8, 9, 9, 10, 10, 10, 10, 11, 12,
                      16], [2, 3, 3, 5, 7, 8, 9, 11, 13, 13], 2, 7),
    (75, "luma"): ([1, 3, 4, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9, 9, 10, 12],
                   [2, 3, 3, 4, 6, 8, 9, 12, 12, 13], 3, 7),
    (90, "chroma"): ([1, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 8, 9, 9, 9],
                     [2, 3, 4, 5, 6, 8, 10, 11, 12, 12], 3, 7),
    (90, "luma"): ([1, 3, 4, 4, 5, 6, 7, 7, 8, 8, 9, 10, 10, 10, 11, 13],
                   [2, 3, 3, 4, 5, 6, 10, 11, 13, 13], 4, 11),
    (95, "chroma"): ([1, 2, 4, 5, 6, 7, 7, 8, 9, 10, 10, 10, 10, 11, 13,
                      16], [2, 3, 5, 5, 5, 6, 9, 11, 11, 13], 3, 9),
    (95, "luma"): ([1, 3, 4, 5, 6, 7, 8, 9, 9, 9, 9, 11, 11, 11, 12, 16],
                   [2, 2, 4, 4, 5, 6, 7, 11, 12, 13], 4, 10),
    (100, "chroma"): ([1, 3, 4, 5, 6, 7, 8, 8, 9, 10, 11, 11, 11, 16, 16,
                       16], [2, 3, 3, 3, 5, 6, 7, 11, 12, 13], 4, 9),
    (100, "luma"): ([1, 3, 5, 6, 7, 8, 9, 9, 11, 11, 12, 16, 16, 16, 16,
                     16], [2, 2, 3, 3, 5, 7, 8, 11, 12, 14], 6, 10),
}


def affine_ac_spec(r_len, l0, len_eob: int, len_zrl: int):
    """DHT (bits, values) for the hybrid computable code.

    Canonical order: by code length; within a class EOB first, then ZRL,
    then run-0 symbols by size, then (run, size) ascending — exactly the
    order the runtime rank formulas of gpujpeg_tpu assume.
    """
    r_len = [int(x) for x in r_len]
    l0 = [int(x) for x in l0]
    assert all(r_len[i] <= r_len[i + 1] for i in range(1, 15)), \
        "r_len[1:] must be monotone nondecreasing"
    syms = [(int(len_eob), (-2, 0), 0x00), (int(len_zrl), (-1, 0), 0xF0)]
    for s in range(1, 11):
        syms.append((l0[s - 1], (0, s), s))
    for r in range(1, 16):
        for s in range(1, 11):
            syms.append((min(16, r_len[r] + s), (r, s), (r << 4) | s))
    syms.sort(key=lambda t: (t[0], t[1]))
    bits = np.zeros(17, np.int32)
    values = np.zeros(len(syms), np.int32)
    for i, (l, _, v) in enumerate(syms):
        bits[l] += 1
        values[i] = v
    # all-ones code must stay unused (padding-bit safety)
    kraft = sum(int(bits[l]) << (16 - l) for l in range(1, 17))
    assert kraft <= (1 << 16) - 1, "Kraft budget exceeds all-ones reserve"
    return bits, values

def affine_params_for_quality(quality: int, luma: bool):
    """Nearest trained bucket's (r_len, l0, len_eob, len_zrl)."""
    kind = "luma" if luma else "chroma"
    qs = sorted({q for (q, k) in AFFINE_AC_PARAMS if k == kind})
    qb = min(qs, key=lambda q: (abs(q - quality), q))
    return AFFINE_AC_PARAMS[(qb, kind)]

def ac_spec(luma: bool, quality: int, family: str = "tuned"):
    """(bits, values) for the AC table of the given family."""
    if family == "annexk":
        return huffman_spec_for("ac", luma)
    if family == "tuned":
        return affine_ac_spec(*affine_params_for_quality(quality, luma))
    raise ValueError(family)


@functools.lru_cache(maxsize=None)
def _affine_spec_index():
    """{(bits, values) bytes-key: params} over every trained bucket."""
    idx = {}
    for params in AFFINE_AC_PARAMS.values():
        bits, values = affine_ac_spec(*params)
        key = (bits.astype(np.int64).tobytes(),
               np.asarray(values, np.int64).tobytes())
        idx.setdefault(key, tuple(tuple(p) if isinstance(p, (list, tuple))
                                  else int(p) for p in params))
    return idx


def match_affine_ac(bits, values):
    """If (bits, values) is byte-identical to a trained tuned-family AC
    table, return its params (r_len, l0, len_eob, len_zrl); else None."""
    key = (np.asarray(bits, np.int64).tobytes(),
           np.asarray(values, np.int64).tobytes())
    return _affine_spec_index().get(key)


def dc_values_identity(values) -> bool:
    """True when huffval[j] == j for all j (the Annex-K DC property)."""
    v = np.asarray(values, np.int64)
    return bool(np.array_equal(v, np.arange(len(v))))
