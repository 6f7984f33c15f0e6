// Huffman coder for Hopper (sm_90a): int16 zig-zag coefficients of one
// component, one restart segment per row -> stuffed byte rows.
//
// Replaces the entropy half of the JAX package's DCT-fused megakernel
// (gpujpeg_tpu/ops/fusedpack.py: _entropy_kernel_body, launched by
// make_entropy_kernel through entropy_fused_u8): DC difference within the
// segment, run/size tokens with ZRL and EOB, bit packing, F.1.2.3 1-bit
// padding, 0xFF -> 0xFF00 stuffing and the RST marker.  On the TPU this was
// a data-parallel token map plus a merge tree of shifts and rolls; on the
// card it is the reference GPUJPEG's serialisation design: one thread walks
// one segment row (rst * 64 coefficients) in order, looks each symbol up
// in the class's DC (12) and AC (256) tables of (len << 16 | code) entries
// held in shared memory, keeps a 64-bit bit buffer, and writes finished
// bytes straight into its row, four at a time as 32-bit words
// (row_writer.cuh, shared with pack_stuff_rows.cu).
//
// Rows have a worst-case stride (the tables' longest codes plus value
// bits, doubled for stuffing, plus 2 for the marker; ops/fusedpack.py
// computes it), so no row can overflow and no capacity protocol is needed.
// The kernel writes row_bytes[s] and raises needs[0] / needs[1] to the
// largest stuffed-zero count / row length (atomicMax; the caller zeroes
// needs).  Bytes past a row's length are unspecified.
//
// Bound: bytes.  At 8K Q75 each of 3 planes reads 66.4 MB of coefficients
// and writes its realised stream (a few MB); the serial walk makes the
// launch latency-bound in practice, which the per-frame numbers in
// PERF.md show.
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
huffman_segments_kernel(const int16_t* __restrict__ coefs, int64_t nseg,
                        int rst, int64_t nblocks,
                        const uint32_t* __restrict__ luts,
                        int stride, uint8_t* __restrict__ rows,
                        int32_t* __restrict__ row_bytes,
                        int32_t* __restrict__ needs) {
    __shared__ uint32_t lut[kLutWords];
    for (int i = threadIdx.x; i < kLutWords; i += blockDim.x)
        lut[i] = luts[i];
    __syncthreads();
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= nseg) return;
    const int64_t left = nblocks - s * rst;
    const int nb = left < rst ? (int)left : rst;
    const int16_t* seg = coefs + s * (int64_t)rst * 64;
    gj::RowWriter w(
        reinterpret_cast<uint32_t*>(rows + s * (int64_t)stride));
    const uint32_t* ac = lut + 16;
    int prev_dc = 0;
    for (int b = 0; b < nb; ++b) {
        const int4* blk = reinterpret_cast<const int4*>(seg + b * 64);
        int run = 0;
        for (int q = 0; q < 8; ++q) {
            const int4 pk = blk[q];          // 8 coefficients, 16 bytes
            const int words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int v = (int)(int16_t)(words[e >> 1] >> (16 * (e & 1)));
                int size;
                uint32_t vb;
                if (q == 0 && e == 0) {      // DC: difference in the row
                    const int diff = v - prev_dc;
                    prev_dc = v;
                    size_and_bits(diff, size, vb);
                    w.emit_entry(lut[size < 11 ? size : 11], size, vb);
                    continue;
                }
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
    // RST(s % 8), not stuffed; none after the scan's last
    w.marker(s < nseg - 1 ? 0xD0u + (uint32_t)(s & 7) : 0u);
    w.flush();
    row_bytes[s] = w.nout;
    atomicMax(&needs[0], w.nff);
    atomicMax(&needs[1], w.nout);
}

}  // namespace

extern "C" int gj_huffman_segments(const void* coefs, int64_t nseg, int rst,
                                   int64_t nblocks, const void* luts,
                                   int stride, void* rows, void* row_bytes,
                                   void* needs, void* stream) {
    // coefs: (nseg, rst*64) int16; luts: int32[272]; rows: (nseg, stride)
    // u8 with stride % 4 == 0; row_bytes: (nseg,) i32; needs: (2,) i32
    if (nseg > 0) {
        const int64_t grid = (nseg + kThreads - 1) / kThreads;
        huffman_segments_kernel<<<(unsigned)grid, kThreads, 0,
                                  (cudaStream_t)stream>>>(
            (const int16_t*)coefs, nseg, rst, nblocks,
            (const uint32_t*)luts, stride, (uint8_t*)rows,
            (int32_t*)row_bytes, (int32_t*)needs);
    }
    return (int)cudaGetLastError();
}
