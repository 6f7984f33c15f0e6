// Shared pieces of the port's two Huffman decode kernels
// (huffdec_scan.cu, huffdec_block.cu): the canonical tables in shared
// memory, a bit reader over one segment row, and the token decode.
//
// Tables: four of ops/huffdec_kernel.decode_tables (DC luma, DC chroma, AC
// luma, AC chroma), each int32[kTableWords] = mono[17] | valoff[17] |
// huffval[256] (utils/tables.kernel_decode_table).  For a left-aligned
// 16-bit peek the code length is 1 + #{l in 1..15 : peek16 > mono[l]}, the
// code is invalid when peek16 > mono[16], and the symbol is
// huffval[(peek16 >> (16 - clen)) + valoff[clen]].  For the tuned tables
// the decoder accepts this gives the JAX package's (clen, sym) exactly
// (gpujpeg_tpu/ops/huffdec_kernel.py: affine_ac_decode,
// dc_identity_decode); clen 0 marks an invalid code.
//
// Classes: a block takes table set 0 ("luma") or 1 for its DC and its AC
// token.  Segment s has flags dc_luma[s] / ac_luma[s]; block slot j of the
// segment also takes bit j % bpm of a slot pattern (one 32-bit mask for DC
// and one for AC; bpm <= 10 in baseline JPEG), and its class is luma when
// both are set.  A non-interleaved scan passes bpm = 1 and masks 1 (the
// segment's flag decides, one component a row); an interleaved scan
// passes flags 1 and the pattern of one MCU's blocks, as the JAX package's
// luma_patterns (gpujpeg_tpu/ops/huffdec_kernel.py: _scan_kernel_body,
// flags(blk)).
//
// Rows: the host-order words of stream/segments.pack_segments_matrix
// (stream byte k is byte k of the row); a word is byteswapped as it is
// loaded, and words past the row read as 0.

#pragma once

#include <cstdint>

namespace gj {

constexpr int kTableWords = 17 + 17 + 256;
constexpr int kTablesWords = 4 * kTableWords;

__device__ __forceinline__ void load_tables(const int32_t* __restrict__ src,
                                            int32_t* dst) {
    for (int i = threadIdx.x; i < kTablesWords; i += blockDim.x)
        dst[i] = src[i];
    __syncthreads();
}

__device__ __forceinline__ const int32_t* dc_table(const int32_t* tab,
                                                  int seg_luma, uint32_t pat,
                                                  int slot) {
    return tab + ((seg_luma && ((pat >> slot) & 1u)) ? 0 : 1) * kTableWords;
}

__device__ __forceinline__ const int32_t* ac_table(const int32_t* tab,
                                                  int seg_luma, uint32_t pat,
                                                  int slot) {
    return tab + ((seg_luma && ((pat >> slot) & 1u)) ? 2 : 3) * kTableWords;
}

struct RowReader {
    const uint32_t* row;
    int W;

    __device__ __forceinline__ uint32_t word(int wi) const {
        return wi < W ? __byte_perm(row[wi], 0, 0x0123) : 0u;
    }

    // the 32 bits of the row from bit `cursor` on
    __device__ __forceinline__ uint32_t peek32(int cursor) const {
        const int wi = cursor >> 5;
        const int r = cursor & 31;
        const uint64_t w = ((uint64_t)word(wi) << 32) | word(wi + 1);
        return (uint32_t)((w << r) >> 32);
    }
};

__device__ __forceinline__ void decode_token(const int32_t* t,
                                             uint32_t peek32, int& clen,
                                             int& sym) {
    const int p16 = (int)(peek32 >> 16);
    int l = 1;
#pragma unroll
    for (int i = 1; i < 16; ++i) l += p16 > t[i] ? 1 : 0;
    const int code = p16 >> (16 - l);
    const int idx = min(max(code + t[17 + l], 0), 255);
    sym = t[34 + idx];
    clen = p16 > t[16] ? 0 : l;
}

}  // namespace gj
