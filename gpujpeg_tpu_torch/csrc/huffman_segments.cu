// Huffman coder for Hopper (sm_90a): int16 zig-zag coefficients, one
// restart segment per row -> stuffed byte rows.
//
// Replaces the entropy half of the JAX package's entropy megakernel
// (gpujpeg_tpu/ops/fusedpack.py: _entropy_kernel_body, launched by
// make_entropy_kernel) in all three of its modes: the DCT-fused mode of a
// non-interleaved scan (entropy_fused_u8, after csrc/fdct_quant.cu), the
// interleaved mode (entropy_fused_u8_il, MCU-ordered rows of a whole scan)
// and the coefficient-input mode (entropy_fused).  Per row: DC difference
// per component, run/size tokens with ZRL and EOB, bit packing, F.1.2.3
// 1-bit padding, 0xFF -> 0xFF00 stuffing and the caller's RST marker.  On
// the TPU this was a data-parallel token map plus a merge tree of shifts
// and rolls, with static per-sublane class masks for the interleaved
// mode; on the card it is the reference GPUJPEG's serialisation design:
// one thread walks one segment row (B blocks of 64 coefficients) in
// order, looks each symbol up in its block's class's DC (12) and AC (256)
// tables of (len << 16 | code) entries held in shared memory, keeps a
// 64-bit bit buffer, and writes finished bytes straight into its row, four
// at a time as 32-bit words (row_writer.cuh, shared with
// pack_stuff_rows.cu).
//
// The contract, per block b of row s, slot j = b % bpm of its MCU:
//   class:     luts0 iff bit j of luma_pat is set and (row_luma is null or
//              row_luma[s] != 0); else luts1
//   component: bits 2j..2j+1 of comp_pat; the DC predictor is the last
//              block of the same component in the row, 0 at the row start
//              (T.81 F.1.1.5.1; at 4:2:0 the four Y slots of an MCU
//              predict from one another)
//   valid:     valid[s * B + b] != 0, or, when valid is null, s * B + b <
//              nblocks; a block that is not valid emits no token, but its
//              DC still feeds the next difference of its component (the
//              megakernel forms the difference before it masks)
//   marker:    after the padded row, 0xFF markers[s] unless markers[s] is 0
// A non-interleaved scan is the one-slot special case (bpm 1, one class,
// prefix validity, markers 0xD0 + s % 8 but none after the last row).
//
// Rows have a worst-case stride (each slot's class's longest coding,
// doubled for stuffing, plus 2 for the marker; ops/fusedpack.py computes
// it), so no row can overflow and no capacity protocol is needed.  The
// kernel writes row_bytes[s] and raises needs[0] / needs[1] to the largest
// stuffed-zero count / row length (atomicMax; the caller zeroes needs).
// Bytes past a row's length are unspecified.
//
// Bound: bytes.  At 8K Q75 the kernel reads 66.4 MB of coefficients a
// plane (199 MB for an interleaved 4:4:4 scan) and writes the realised
// stream (a few MB); the serial walk makes the launch latency-bound in
// practice (one thread a row: 129,600 rows at 4:2:0 fill about 1,000
// warps on 132 SMs), which the per-frame numbers in PERF.md show.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "row_writer.cuh"

namespace {

constexpr int kLutWords = 272;   // DC entries at [0, 16), AC at [16, 272)
constexpr int kThreads = 128;

__device__ __forceinline__ void size_and_bits(int v, int& size,
                                              uint32_t& vb) {
    const int a = v < 0 ? -v : v;
    size = a ? 32 - __clz(a) : 0;
    vb = (uint32_t)(v < 0 ? v - 1 : v) & ((1u << size) - 1u);
}

__global__ void __launch_bounds__(kThreads)
huffman_segments_kernel(const int16_t* __restrict__ coefs, int64_t nrows,
                        int B, int64_t nblocks,
                        const uint8_t* __restrict__ valid,
                        const uint32_t* __restrict__ luts0,
                        const uint32_t* __restrict__ luts1,
                        const int32_t* __restrict__ row_luma, int bpm,
                        uint32_t luma_pat, uint32_t comp_pat,
                        const int32_t* __restrict__ markers, int stride,
                        uint8_t* __restrict__ rows,
                        int32_t* __restrict__ row_bytes,
                        int32_t* __restrict__ needs) {
    __shared__ uint32_t lut[2 * kLutWords];
    for (int i = threadIdx.x; i < kLutWords; i += blockDim.x) {
        lut[i] = luts0[i];
        lut[kLutWords + i] = luts1[i];
    }
    __syncthreads();
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= nrows) return;
    const int16_t* seg = coefs + s * (int64_t)B * 64;
    const uint32_t row_pat = (row_luma == nullptr || row_luma[s]) ? luma_pat
                                                                 : 0u;
    // blocks past the last valid one emit nothing and feed no later block
    int nb = B;
    if (valid == nullptr) {
        const int64_t left = nblocks - s * B;
        nb = left < B ? (left > 0 ? (int)left : 0) : B;
    }
    gj::RowWriter w(
        reinterpret_cast<uint32_t*>(rows + s * (int64_t)stride));
    int p0 = 0, p1 = 0, p2 = 0, p3 = 0;      // DC predictor per component
    int j = 0;                               // slot of block b in its MCU
    for (int b = 0; b < nb; ++b, j = (j + 1 == bpm) ? 0 : j + 1) {
        const uint32_t* dcl = lut + (((row_pat >> j) & 1u) ? 0 : kLutWords);
        const uint32_t* ac = dcl + 16;
        const int comp = (int)((comp_pat >> (2 * j)) & 3u);
        const int4* blk = reinterpret_cast<const int4*>(seg + b * 64);
        const int dc = (int)(int16_t)(blk[0].x & 0xFFFF);
        const int pred = comp == 0 ? p0 : comp == 1 ? p1 : comp == 2 ? p2
                                                                     : p3;
        p0 = comp == 0 ? dc : p0;
        p1 = comp == 1 ? dc : p1;
        p2 = comp == 2 ? dc : p2;
        p3 = comp == 3 ? dc : p3;
        if (valid != nullptr && !valid[s * B + b]) continue;
        int size;
        uint32_t vb;
        size_and_bits(dc - pred, size, vb);  // DC: difference
        w.emit_entry(dcl[size < 11 ? size : 11], size, vb);
        int run = 0;
        for (int q = 0; q < 8; ++q) {
            const int4 pk = blk[q];          // 8 coefficients, 16 bytes
            const int words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                if (q == 0 && e == 0) continue;   // the DC, coded above
                const int v = (int)(int16_t)(words[e >> 1] >> (16 * (e & 1)));
                if (v == 0) {
                    ++run;
                    continue;
                }
                while (run >= 16) {          // ZRL only before a nonzero
                    w.emit_entry(ac[0xF0], 0, 0);
                    run -= 16;
                }
                size_and_bits(v, size, vb);
                w.emit_entry(ac[(run << 4) | (size < 15 ? size : 15)], size,
                             vb);
                run = 0;
            }
        }
        if (run > 0) w.emit_entry(ac[0x00], 0, 0);   // EOB: slot 63 is 0
    }
    w.pad();                                 // F.1.2.3: 1-bits
    w.marker((uint32_t)markers[s]);          // not stuffed; 0 = none
    w.flush();
    row_bytes[s] = w.nout;
    atomicMax(&needs[0], w.nff);
    atomicMax(&needs[1], w.nout);
}

}  // namespace

extern "C" int gj_huffman_segments(const void* coefs, int64_t nrows, int B,
                                   int64_t nblocks, const void* valid,
                                   const void* luts0, const void* luts1,
                                   const void* row_luma, int bpm,
                                   int64_t luma_pat, int64_t comp_pat,
                                   const void* markers, int stride,
                                   void* rows, void* row_bytes, void* needs,
                                   void* stream) {
    // coefs: (nrows, B*64) int16; valid: (nrows, B) u8 or null (then the
    // first nblocks blocks are valid); luts0/1: int32[272] each; row_luma:
    // (nrows,) i32 or null; 1 <= bpm <= 16, B % bpm == 0; luma_pat: bit j
    // = slot j may take luts0; comp_pat: 2 bits a slot; markers: (nrows,)
    // i32; rows: (nrows, stride) u8 with stride % 4 == 0; row_bytes:
    // (nrows,) i32; needs: (2,) i32
    if (nrows > 0) {
        const int64_t grid = (nrows + kThreads - 1) / kThreads;
        huffman_segments_kernel<<<(unsigned)grid, kThreads, 0,
                                  (cudaStream_t)stream>>>(
            (const int16_t*)coefs, nrows, B, nblocks, (const uint8_t*)valid,
            (const uint32_t*)luts0, (const uint32_t*)luts1,
            (const int32_t*)row_luma, bpm, (uint32_t)luma_pat,
            (uint32_t)comp_pat, (const int32_t*)markers, stride,
            (uint8_t*)rows, (int32_t*)row_bytes, (int32_t*)needs);
    }
    return (int)cudaGetLastError();
}
