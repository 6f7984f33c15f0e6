// Shared pieces of the port's two Huffman decode kernels
// (huffdec_scan.cu, huffdec_block.cu): the canonical tables in shared
// memory, the canonical decode of one token, and the register bit window
// that both read their segment rows through.
//
// Tables: the 2 * kSets of ops/huffdec_kernel.decode_tables for kSets = 2
// or 4 table sets (the DC tables, then the AC tables: DC luma, DC chroma,
// AC luma, AC chroma for two), each int32[kTableWords] = mono[17] |
// valoff[17] | huffval[256] (utils/tables.kernel_decode_table), any
// baseline DHT table.  For a left-aligned 16-bit peek the code length is
// 1 + #{l in 1..15 : peek16 > mono[l]}, the code is invalid when peek16 >
// mono[16], and the symbol is huffval[(peek16 >> (16 - clen)) +
// valoff[clen]].  For the tuned tables this gives the JAX package's (clen,
// sym) exactly (gpujpeg_tpu/ops/huffdec_kernel.py: affine_ac_decode,
// dc_identity_decode); clen 0 marks an invalid code.  Both kernels look a
// token up in a lookahead table built on the host first (huffdec_kernel
// scan_lut, block_lut) and take this decode only where the table has no
// entry.
//
// Classes: a block takes one of the kSets table sets for its DC and its
// AC token.  Segment s has selectors dc_sel[s] / ac_sel[s]; block slot j
// of the segment also takes field j % bpm of a slot pattern (one 32-bit
// mask for DC and one for AC; bpm <= 10 in baseline JPEG):
//   kSets = 2: a selector is a luma flag, a field one bit, and the block
//     takes set 0 ("luma") when both are set, else set 1.  A
//     non-interleaved scan passes bpm = 1 and masks 1 (the segment's flag
//     decides, one component a row); an interleaved scan passes flags 1
//     and the pattern of one MCU's blocks, as the JAX package's
//     luma_patterns (gpujpeg_tpu/ops/huffdec_kernel.py:
//     _scan_kernel_body, flags(blk));
//   kSets = 4: a selector is a set index, a field 2 bits (slot j at bits
//     2j, 2j + 1), and the block takes set (selector + field) & 3; a
//     non-interleaved scan passes masks 0, an interleaved one selectors 0.
// set_of gives a slot's set; its DC table is that set, its AC table kSets
// plus it.
//
// Rows: the host-order words of stream/segments.pack_segments_matrix
// (stream byte k is byte k of the row); a word is byteswapped as it is
// loaded, and words past the row read as 0.

#pragma once

#include <cstdint>

namespace gj {

constexpr int kTableWords = 17 + 17 + 256;

// the words of the 2 * kSets canonical tables
template <int kSets>
constexpr int kTablesWords = 2 * kSets * kTableWords;

template <int kSets>
__device__ __forceinline__ void load_tables(const int32_t* __restrict__ src,
                                            int32_t* dst) {
    for (int i = threadIdx.x; i < kTablesWords<kSets>; i += blockDim.x)
        dst[i] = src[i];
    __syncthreads();
}

// the table set of slot `slot` of a segment with selector sel, in the
// pattern mask pat (the classes above)
template <int kSets>
__device__ __forceinline__ int set_of(int sel, uint32_t pat, int slot) {
    if constexpr (kSets == 2)
        return sel && ((pat >> slot) & 1u) ? 0 : 1;
    else
        return (sel + (int)((pat >> (2 * slot)) & 3u)) & 3;
}

// The canonical tables packed (the four-set instances of both kernels):
// a table's mono[17] | valoff[17] as int32 (kPackedWords) and its 256
// symbols as bytes, 3.1 KB for eight tables instead of 9.3 KB.
constexpr int kPackedWords = 34;

// One token from canonical table t (the layout above) and a left-aligned
// 16-bit peek: (clen, sym), the code length found by a binary search of
// the monotone mono[1..15].
__device__ __forceinline__ void decode_one(const int32_t* t, int p16,
                                           int& clen, int& sym) {
    int c = 0;                         // #{l in 1..15 : p16 > mono[l]}
#pragma unroll
    for (int half = 8; half >= 1; half >>= 1)
        if (c + half <= 15 && p16 > t[c + half]) c += half;
    const int l = c + 1;
    const int code = p16 >> (16 - l);
    const int idx = min(max(code + t[17 + l], 0), 255);
    sym = t[34 + idx];
    clen = p16 > t[16] ? 0 : l;
}

// decode_one on a packed table: mv its mono | valoff, hv its symbols
struct Packed {
    const int32_t* mv;
    const uint8_t* hv;
    __device__ __forceinline__ void decode(int p16, int& clen,
                                           int& sym) const {
        int c = 0;                     // decode_one's search
#pragma unroll
        for (int half = 8; half >= 1; half >>= 1)
            if (c + half <= 15 && p16 > mv[c + half]) c += half;
        const int l = c + 1;
        const int idx = min(max((p16 >> (16 - l)) + mv[17 + l], 0), 255);
        sym = hv[idx];
        clen = p16 > mv[16] ? 0 : l;
    }
};

// The bits of one segment row, MSB first: 64 bits (buf) with at least 32
// valid at each step of a walk that refills when n < 32, fed a 32-bit
// word at a time from a 16-byte quad held in registers; the next quad's
// load is issued when the current one is first used, four words ahead.
// Loads are 16-byte aligned: a row starts at any word, so the first quad
// may begin up to 3 words before it (those words are skipped), and a load
// never leaves the aligned 16 bytes of a word the row owns.  Words at and
// past W read as 0; quads wholly past the row are not loaded.
struct BitWindow {
    const uint4* q;      // the 16-byte-aligned quad holding the row's word 0
    int lead;            // words of quad 0 before the row (0..3)
    int W;
    int k;               // index of quad cur (from q)
    uint4 cur;           // quad k as loaded, masked; the next word in .x
    uint4 next;          // quad k + 1 as loaded
    uint64_t buf;        // the window; bits past n are 0
    int n;

    __device__ __forceinline__ uint4 fetch(int kk) const {
        // load quad kk only when it holds a word of the row
        const int r0 = 4 * kk - lead;
        if (max(r0, 0) < W) return __ldg(q + kk);
        return make_uint4(0u, 0u, 0u, 0u);
    }

    // quad kk with its words at and past the row's end zeroed (only the
    // quad that holds the row's last word has any)
    __device__ __forceinline__ uint4 mask(uint4 v, int kk) const {
        const int r0 = 4 * kk - lead;
        if (r0 + 3 >= W) {
            v.y = r0 + 1 < W ? v.y : 0u;
            v.z = r0 + 2 < W ? v.z : 0u;
            v.w = 0u;
        }
        return v;
    }

    // the next word of the row, byteswapped to stream order; the fourth
    // moves to the next quad and issues the load of the one after
    __device__ __forceinline__ uint32_t take(int& j) {
        const uint32_t w = __byte_perm(cur.x, 0, 0x0123);
        cur.x = cur.y;
        cur.y = cur.z;
        cur.z = cur.w;
        if (++j == 4) {
            j = 0;
            ++k;
            cur = mask(next, k);
            next = fetch(k + 1);
        }
        return w;
    }

    // append 32 bits (n < 32)
    __device__ __forceinline__ void refill(int& j) {
        buf |= (uint64_t)take(j) << (32 - n);
        n += 32;
    }

    // the row's words from word 0 on: 64 valid bits
    __device__ __forceinline__ void init(const uint32_t* row, int W_,
                                         int& j) {
        const uintptr_t addr = (uintptr_t)row;
        q = (const uint4*)(addr & ~(uintptr_t)15);
        lead = (int)((addr >> 2) & 3);
        W = W_;
        k = 0;
        cur = mask(fetch(0), 0);
        next = fetch(1);
        j = 0;
        for (int i = 0; i < lead; ++i) take(j);
        buf = 0;
        n = 0;
        refill(j);
        refill(j);
    }

    // the row of W_ words from bit `bit` on (0 <= bit): the window of
    // the row's word bit >> 5, with bit & 31 bits shifted out (at least
    // 33 valid)
    __device__ __forceinline__ void start_at(const uint32_t* row, int W_,
                                             int bit, int& j) {
        const int wi = bit >> 5;
        init(row + wi, W_ - wi, j);
        buf <<= bit & 31;
        n -= bit & 31;
    }
};

}  // namespace gj
