// The bit writer of the port's two Huffman encode kernels
// (huffman_segments.cu, pack_stuff_rows.cu): tokens go in MSB first, every
// finished byte goes straight into the thread's row, a 0x00 follows every
// 0xFF (0xFF -> 0xFF00 stuffing, T.81 F.1.2.3), and bytes are stored four at
// a time as little-endian 32-bit words, so a row's stride must be a
// multiple of 4.
//
// acc keeps the pending bits in its low `nbits` bits (fewer than 8 between
// calls); a token of up to 27 bits therefore always fits, and the bits
// shifted out above are never read again.

#pragma once

#include <cstdint>

namespace gj {

struct RowWriter {
    uint32_t* row;
    uint64_t acc = 0;   // low `nbits` bits are pending
    int nbits = 0;
    uint32_t word = 0;  // bytes of the current 32-bit word, little-endian
    int nout = 0;       // bytes written to the row
    int nff = 0;        // stuffed zero bytes

    __device__ explicit RowWriter(uint32_t* r) : row(r) {}

    __device__ __forceinline__ void put_byte(uint32_t b) {
        word |= b << (8 * (nout & 3));
        ++nout;
        if ((nout & 3) == 0) {
            row[(nout >> 2) - 1] = word;
            word = 0;
        }
    }

    __device__ __forceinline__ void emit(uint32_t bits, int len) {
        acc = (acc << len) | bits;
        nbits += len;
        while (nbits >= 8) {
            nbits -= 8;
            const uint32_t b = (uint32_t)(acc >> nbits) & 0xFFu;
            put_byte(b);
            if (b == 0xFFu) {
                put_byte(0);
                ++nff;
            }
        }
    }

    // code entry (len << 16 | code) followed by `size` value bits
    __device__ __forceinline__ void emit_entry(uint32_t e, int size,
                                               uint32_t vb) {
        emit(((e & 0xFFFFu) << size) | vb, (int)(e >> 16) + size);
    }

    // F.1.2.3: pad the last byte with 1-bits (stuffed like any other)
    __device__ __forceinline__ void pad() {
        if (nbits > 0) {
            const int p = 8 - nbits;
            emit((1u << p) - 1u, p);
        }
    }

    // RST marker (not stuffed); marker 0 appends nothing
    __device__ __forceinline__ void marker(uint32_t m) {
        if (m) {
            put_byte(0xFFu);
            put_byte(m);
        }
    }

    // store the partial last word
    __device__ __forceinline__ void flush() {
        if (nout & 3) row[nout >> 2] = word;
    }
};

}  // namespace gj
