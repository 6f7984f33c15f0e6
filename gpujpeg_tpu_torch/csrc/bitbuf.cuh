// The warp bit buffer of the port's two Huffman encode kernels
// (huffman_segments.cu, pack_stuff_rows.cu), as in the reference GPUJPEG's
// warp-per-segment serialisation: a warp places its tokens by a scan of
// their bit counts and ORs each, MSB first, into a bit buffer of 32-bit
// words in shared memory (put_bits); when the buffer holds enough whole
// words, and at the row's end after the F.1.2.3 1-bit pad, its bytes go out
// with a 0x00 after every 0xFF (T.81 F.1.2.3), warp-parallel (flush_bytes).
// Each kernel sizes its buffer and its flush threshold by the most bits one
// of its rounds can add.

#pragma once

#include <cstdint>

namespace gj {

constexpr unsigned kAll = 0xFFFFFFFFu;

// OR the n low bits of v (1 <= n <= 32, nothing above them) into the bit
// buffer at bit p, MSB first
__device__ __forceinline__ void put_bits(uint32_t* buf, int p, uint32_t v,
                                         int n) {
    const int w = p >> 5, sh = 32 - (p & 31) - n;
    if (sh >= 0) {
        atomicOr(buf + w, v << sh);
    } else {
        atomicOr(buf + w, v >> -sh);
        atomicOr(buf + w + 1, v << (32 + sh));
    }
}

// the first nbytes bytes of the bit buffer, stuffed, to out[outpos..];
// advances outpos and nff (warp-wide, every lane gets the same values).
// Lane l takes word l of each 32-word pass: a pass with no 0xFF byte and a
// word-aligned outpos stores whole words; otherwise a warp scan of each
// word's byte count (its bytes plus one per 0xFF) places every byte.
template <bool kStore>
__device__ __forceinline__ void flush_bytes(const uint32_t* buf, int nbytes,
                                            uint8_t* out, int& outpos,
                                            int& nff, int lane) {
    const int nw = (nbytes + 3) >> 2;
    for (int w0 = 0; w0 < nw; w0 += 32) {
        const int w = w0 + lane;
        int nb = nbytes - 4 * w;
        nb = nb < 0 ? 0 : nb > 4 ? 4 : nb;
        const uint32_t word = nb ? buf[w] : 0u;
        // 0xFF bytes among the first nb (stream order: the high byte first)
        const uint32_t inb = nb ? ~0u << (32 - 8 * nb) : 0u;
        const int ff = __popc(__vcmpeq4(word, ~0u) & inb) >> 3;
        const int left = nbytes - 4 * w0;
        const int chunk = left < 128 ? left : 128;
        if (!__any_sync(kAll, ff) && (outpos & 3) == 0) {
            // no stuffing: whole words as words, a last part word by bytes
            uint8_t* const o = out + outpos + 4 * lane;
            if (kStore && nb == 4)
                *reinterpret_cast<uint32_t*>(o) = __byte_perm(word, 0, 0x0123);
            else if (kStore)
                for (int q = 0; q < nb; ++q)
                    o[q] = (uint8_t)(word >> (24 - 8 * q));
            outpos += chunk;
            continue;
        }
        const int mine = nb + ff;
        int incl = mine;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(kAll, incl, d);
            if (lane >= d) incl += up;
        }
        int o = outpos + incl - mine;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (kStore && q < nb) {
                const uint32_t byte = (word >> (24 - 8 * q)) & 0xFFu;
                out[o++] = (uint8_t)byte;
                if (byte == 0xFFu) out[o++] = 0;
            }
        }
        const int total = __shfl_sync(kAll, incl, 31);
        nff += total - chunk;
        outpos += total;
    }
}

}  // namespace gj
