// Huffman decode phase C for Hopper (sm_90a): the 64 zig-zag coefficients
// of every block, straight out of its segment's row.
//
// Replaces the JAX package's Pallas block decoder
// (gpujpeg_tpu/ops/huffdec_kernel.py: _block_kernel_body in its
// segment-row mode, with_cursor=True, launched by make_block_kernel).  On
// the TPU a block is a vector lane whose coefficients are OR-inserted
// into a VMEM tile through one-hot compares, and its segment row has to be
// expanded into every lane; here one thread decodes one block: it reads
// its segment's row from bit bstart[s][j] (phase A's boundary) up to
// bstart[s][j+1], keeps the 64 coefficients in a local array, and stores
// them at the end into the (64, L) layout, where at a fixed coefficient
// neighbouring threads store neighbouring int16s.  No per-block buffers
// (the JAX package's phase B) are made.
//
// Semantics as _block_kernel_body: the DC token is decoded first and is
// bad on an invalid code, an overrun of the block's end or a symbol above
// 15; a block whose cursor reaches its end right after DC is done; then
// at most MAX_AC_STEPS = 66 AC tokens, each bad on an invalid code, an
// overrun, a coefficient index past 63 or a new position past 64; only
// good tokens that are neither EOB nor ZRL and carry value bits write a
// coefficient; a block still unfinished after the 66 steps is an error;
// slots j >= nblocks[s] are all zero with err 0.  DC is differential (the
// caller integrates it per component along the segment).  A block's
// table class comes from its segment's flags and the slot pattern
// (huffdec.cuh), as the JAX kernel's per-block class rows.
//
// Bound: bytes.  At 8K Q75 the kernel reads the 25.7 MB word matrix and
// 7.0 MB of bstart and writes 199.1 MB of coefficients and 6.2 MB of
// error flags, about 0.071 ms at 3.35 TB/s.  The serial token walk of a
// block (up to 64 dependent table lookups) and the 128-byte local array,
// which the compiler keeps in local memory, cost more; the final stores
// coalesce, and the row reads of the 8 threads of one segment hit the
// same L1 lines.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "huffdec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxAcSteps = 66;

// `size` value bits after a `clen`-bit code, sign-extended (T.81 F.2.2.1)
__device__ __forceinline__ int value_bits(uint32_t peek, int clen,
                                          int size) {
    if (size == 0) return 0;
    const uint32_t vu = (peek << clen) >> (32 - size);
    return vu < (1u << (size - 1)) ? (int)vu - (1 << size) + 1 : (int)vu;
}

__global__ void __launch_bounds__(kThreads)
huffdec_block_kernel(const uint32_t* __restrict__ words, int64_t nseg, int W,
                     const int32_t* __restrict__ bstart, int bps,
                     const int32_t* __restrict__ nblocks,
                     const int32_t* __restrict__ dc_luma,
                     const int32_t* __restrict__ ac_luma, int bpm,
                     uint32_t dc_pat, uint32_t ac_pat,
                     const int32_t* __restrict__ tables,
                     int16_t* __restrict__ coefs,
                     int32_t* __restrict__ err_out) {
    __shared__ int32_t tab[gj::kTablesWords];
    gj::load_tables(tables, tab);
    const int64_t L = nseg * bps;
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= L) return;
    const int64_t s = b / bps;
    const int j = (int)(b - s * bps);
    const int slot = j % bpm;
    int16_t c[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) c[k] = 0;
    bool err = false;
    if (j < nblocks[s]) {
        const gj::RowReader rd{words + s * (int64_t)W, W};
        const int32_t* bs = bstart + s * (int64_t)(bps + 1) + j;
        const int bend = bs[1];
        int cursor = bs[0];
        // DC token
        uint32_t peek = rd.peek32(cursor);
        int clen, sym;
        gj::decode_token(gj::dc_table(tab, dc_luma[s], dc_pat, slot), peek,
                         clen, sym);
        int size = sym & 15;
        bool done;
        if (clen == 0 || cursor + clen + size > bend || sym > 15) {
            err = true;
            done = true;
        } else {
            c[0] = (int16_t)value_bits(peek, clen, size);
            cursor += clen + size;
            done = cursor >= bend;
        }
        const int32_t* act = gj::ac_table(tab, ac_luma[s], ac_pat, slot);
        int pos = 1;
        for (int step = 0; step < kMaxAcSteps && !done; ++step) {
            peek = rd.peek32(cursor);
            gj::decode_token(act, peek, clen, sym);
            size = sym & 15;
            const int after = cursor + clen + size;
            const bool is_eob = sym == 0;
            const bool is_zrl = sym == 0xF0;
            const int coef_idx = pos + (sym >> 4);
            const int new_pos = is_eob ? 64 : is_zrl ? pos + 16
                                                     : coef_idx + 1;
            if (clen == 0 || after > bend || coef_idx > 63 || new_pos > 64) {
                err = true;
                break;
            }
            if (!is_eob && !is_zrl && size > 0)
                c[coef_idx] = (int16_t)value_bits(peek, clen, size);
            cursor = after;
            pos = new_pos;
            done = new_pos >= 64;
        }
        err = err || !done;
    }
#pragma unroll
    for (int k = 0; k < 64; ++k) coefs[k * L + b] = c[k];
    err_out[b] = err ? 1 : 0;
}

}  // namespace

extern "C" int gj_huffdec_block(const void* words, int64_t nseg, int W,
                                const void* bstart, int bps,
                                const void* nblocks, const void* dc_luma,
                                const void* ac_luma, int bpm, int dc_pat,
                                int ac_pat, const void* tables, void* coefs,
                                void* err, void* stream) {
    // words: (nseg, W) host-order u32 rows; bstart: (nseg, bps+1) i32;
    // nblocks, dc_luma, ac_luma: (nseg,) i32; bpm, dc_pat, ac_pat: the
    // slot pattern (huffdec.cuh); tables: (4, 290) i32; coefs: (64,
    // nseg*bps) i16; err: (nseg*bps,) i32
    const int64_t L = nseg * bps;
    if (L > 0) {
        const int64_t grid = (L + kThreads - 1) / kThreads;
        huffdec_block_kernel<<<(unsigned)grid, kThreads, 0,
                               (cudaStream_t)stream>>>(
            (const uint32_t*)words, nseg, W, (const int32_t*)bstart, bps,
            (const int32_t*)nblocks, (const int32_t*)dc_luma,
            (const int32_t*)ac_luma, bpm, (uint32_t)dc_pat,
            (uint32_t)ac_pat, (const int32_t*)tables,
            (int16_t*)coefs, (int32_t*)err);
    }
    return (int)cudaGetLastError();
}
