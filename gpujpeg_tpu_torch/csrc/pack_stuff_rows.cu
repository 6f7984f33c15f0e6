// Token-row packer for Hopper (sm_90a): rows of Huffman tokens (right-
// aligned bits + bit lengths, one restart segment per row) -> stuffed byte
// rows.
//
// Replaces the JAX package's Pallas deep-stuff kernel
// (gpujpeg_tpu/ops/fusedpack.py: _deep_stuff_kernel_body, launched by
// make_deep_stuff_kernel through pack_stuff_fused / pack_stuff_fused_pre),
// the back end of its non-megakernel encode (interleaved subsampled scans,
// Annex-K tables).  On the TPU the tokens of a row were merged pairwise up
// a tree of in-place span doublings over sublanes, then padded, stuffed by
// a roll/select chain and given their marker, all under sticky capacities
// (l0, z_cap, w_out) that grew and recompiled on overflow.  On the card it
// is the reference GPUJPEG's serialisation: one thread walks one row's
// tokens in order through the bit writer of huffman_segments.cu
// (row_writer.cuh), which emits finished bytes with their 0x00 stuffing,
// then pads with 1-bits (F.1.2.3) and appends the row's RST marker.  Rows
// have a worst-case stride (ops/fusedpack.pack_stride: the longest coding
// of each block slot's class, doubled for stuffing, plus the marker), so
// no row can overflow and the capacity protocol is gone.
//
// Input: bits and lens (R, T) int32, T % 4 == 0, lens[r][t] == 0 meaning no
// token, bits above a token's length ignored; markers (R,) int32, the
// second byte of the RST marker after row r (0 = none).  Output: rows (R,
// stride) u8 (bytes past a row's length unspecified), row_bytes (R,) i32,
// and needs[0] / needs[1] raised to the largest stuffed-zero count / row
// length (atomicMax; the caller zeroes needs).
//
// Bound: bytes.  At 8K 4:2:0 Q75 the kernel reads every length (199 MB:
// 129,600 rows of 384 int32 slots), the bits of only those 4-slot quads
// that hold a token, and writes the realised stream (about 7 MB).  A
// thread reads its row 16 bytes at a time (four slots), so each load uses
// whole sectors; the rows' serial bit walks and the 1.5 KB between
// neighbouring threads' reads keep it short of that bound.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "row_writer.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pack_stuff_rows_kernel(const int32_t* __restrict__ bits,
                       const int32_t* __restrict__ lens, int64_t R, int T,
                       const int32_t* __restrict__ markers, int stride,
                       uint8_t* __restrict__ rows,
                       int32_t* __restrict__ row_bytes,
                       int32_t* __restrict__ needs) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const int4* b4 = reinterpret_cast<const int4*>(bits + r * T);
    const int4* l4 = reinterpret_cast<const int4*>(lens + r * T);
    gj::RowWriter w(
        reinterpret_cast<uint32_t*>(rows + r * (int64_t)stride));
    for (int q = 0; q < T / 4; ++q) {
        const int4 lv = l4[q];
        if ((lv.x | lv.y | lv.z | lv.w) == 0) continue;
        const int4 bv = b4[q];
        const int ls[4] = {lv.x, lv.y, lv.z, lv.w};
        const int bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int n = ls[e];
            if (n > 0) w.emit((uint32_t)bs[e] & ((1u << n) - 1u), n);
        }
    }
    w.pad();
    w.marker((uint32_t)markers[r]);
    w.flush();
    row_bytes[r] = w.nout;
    atomicMax(&needs[0], w.nff);
    atomicMax(&needs[1], w.nout);
}

}  // namespace

extern "C" int gj_pack_stuff_rows(const void* bits, const void* lens,
                                  int64_t R, int T, const void* markers,
                                  int stride, void* rows, void* row_bytes,
                                  void* needs, void* stream) {
    // bits, lens: (R, T) i32, T % 4 == 0, lens in [0, 27]; markers: (R,)
    // i32; rows: (R, stride) u8 with stride % 4 == 0; row_bytes: (R,) i32;
    // needs: (2,) i32
    if (R > 0) {
        const int64_t grid = (R + kThreads - 1) / kThreads;
        pack_stuff_rows_kernel<<<(unsigned)grid, kThreads, 0,
                                 (cudaStream_t)stream>>>(
            (const int32_t*)bits, (const int32_t*)lens, R, T,
            (const int32_t*)markers, stride, (uint8_t*)rows,
            (int32_t*)row_bytes, (int32_t*)needs);
    }
    return (int)cudaGetLastError();
}
