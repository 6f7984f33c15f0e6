// Huffman decode phase A for Hopper (sm_90a): the start bit of every block
// of every restart segment.
//
// Replaces the JAX package's Pallas boundary scan
// (gpujpeg_tpu/ops/huffdec_kernel.py: _scan_kernel_body, launched by
// make_scan_kernel).  On the TPU every segment is a vector lane that walks
// its tokens in lockstep with 1,023 others, refilling its window through
// a select chain over the row's words; here one thread walks one segment
// row, as the reference decoder does (gpujpeg_huffman_gpu_decoder.cu:
// 390-536), reading its row through the L1 cache and decoding each token
// from the class's canonical table in shared memory (huffdec.cuh); a
// block's class comes from its segment's flags and, in an interleaved
// scan, from the slot pattern of its MCU (huffdec.cuh).  The
// byteswap of the big-endian stream happens on load, in place of the JAX
// package's separate pass over the matrix.
//
// Semantics as _scan_kernel_body: bstart[s][0] = 0, bstart[s][b+1] is the
// bit cursor after block b, entries past the last decoded block hold
// nbits[s]; a token is bad when its code is invalid, its bits end past
// nbits[s], its coefficient index passes 63 or its new position passes
// 64, and err[s] is set on a bad token or when the segment ends short of
// nblocks[s] blocks.  The scan does not check a DC symbol above 15 (the
// block kernel does).  Every token advances the cursor, so the walk needs
// no step cap: the TPU loop's max_steps never binds.
//
// Bound: bytes.  At 8K Q75 the kernel reads the 25.7 MB word matrix and
// writes 7.0 MB of bstart, about 0.010 ms at 3.35 TB/s.  In practice it
// is bound by the serial walk: a thread decodes bps blocks of up to 64
// tokens each, one dependent table lookup after another, and the threads
// of a warp diverge on their token counts.  The design keeps that walk
// short (one thread per segment: 194,400 threads at 8K, 1,519 CTAs of
// 128) and its tables in shared memory.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "huffdec.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
huffdec_scan_kernel(const uint32_t* __restrict__ words, int64_t nseg, int W,
                    const int32_t* __restrict__ nbits_a,
                    const int32_t* __restrict__ nblocks_a,
                    const int32_t* __restrict__ dc_luma,
                    const int32_t* __restrict__ ac_luma, int bpm,
                    uint32_t dc_pat, uint32_t ac_pat,
                    const int32_t* __restrict__ tables, int bps,
                    int32_t* __restrict__ bstart, bool* __restrict__ err) {
    __shared__ int32_t tab[gj::kTablesWords];
    gj::load_tables(tables, tab);
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= nseg) return;
    const gj::RowReader rd{words + s * (int64_t)W, W};
    const int nbits = nbits_a[s];
    const int nb = nblocks_a[s];
    const int sdc = dc_luma[s], sac = ac_luma[s];
    int32_t* out = bstart + s * (int64_t)(bps + 1);
    out[0] = 0;
    int cursor = 0, blk = 0, pos = 0, slot = 0;   // slot = blk % bpm
    bool bad = false;
    while (blk < nb) {
        const uint32_t peek = rd.peek32(cursor);
        const bool is_dc = pos == 0;
        int clen, sym;
        gj::decode_token(is_dc ? gj::dc_table(tab, sdc, dc_pat, slot)
                               : gj::ac_table(tab, sac, ac_pat, slot),
                         peek, clen, sym);
        const int run = sym >> 4;
        const int after = cursor + clen + (sym & 15);
        const bool is_eob = !is_dc && sym == 0;
        const bool is_zrl = !is_dc && sym == 0xF0;
        const int coef_idx = is_dc ? 0 : pos + run;
        const int new_pos = is_dc ? 1
                            : is_eob ? 64
                            : is_zrl ? pos + 16 : coef_idx + 1;
        if (clen == 0 || after > nbits || coef_idx > 63 || new_pos > 64) {
            bad = true;
            break;
        }
        cursor = after;
        if (new_pos >= 64) {
            ++blk;
            if (++slot == bpm) slot = 0;
            if (blk <= bps) out[blk] = after;
            pos = 0;
        } else {
            pos = new_pos;
        }
    }
    for (int b = blk + 1; b <= bps; ++b) out[b] = nbits;
    err[s] = bad || blk < nb;
}

}  // namespace

extern "C" int gj_huffdec_scan(const void* words, int64_t nseg, int W,
                               const void* nbits, const void* nblocks,
                               const void* dc_luma, const void* ac_luma,
                               int bpm, int dc_pat, int ac_pat,
                               const void* tables, int bps, void* bstart,
                               void* err, void* stream) {
    // words: (nseg, W) host-order u32 rows; nbits, nblocks, dc_luma,
    // ac_luma: (nseg,) i32 with nblocks <= bps; bpm, dc_pat, ac_pat: the
    // slot pattern (huffdec.cuh); tables: (4, 290) i32; bstart: (nseg,
    // bps+1) i32; err: (nseg,) bool
    if (nseg > 0) {
        const int64_t grid = (nseg + kThreads - 1) / kThreads;
        huffdec_scan_kernel<<<(unsigned)grid, kThreads, 0,
                              (cudaStream_t)stream>>>(
            (const uint32_t*)words, nseg, W, (const int32_t*)nbits,
            (const int32_t*)nblocks, (const int32_t*)dc_luma,
            (const int32_t*)ac_luma, bpm, (uint32_t)dc_pat,
            (uint32_t)ac_pat, (const int32_t*)tables, bps,
            (int32_t*)bstart, (bool*)err);
    }
    return (int)cudaGetLastError();
}
