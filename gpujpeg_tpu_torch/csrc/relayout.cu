// Relayout and primitive kernels for Hopper (sm_90a): the H100
// counterparts of the JAX package's TPU probes in tools/, which measured
// the relayouts and primitives of its encode feed and pre kernel.  No
// codec path launches them: the port's interleaved feed relayout is the
// MCU-order store of fdct_quant.cu, and its pre kernel reads RGB bytes
// directly.  Four entry points, one library:
//
//   gj_xbd_relayout   tools/proto_xbdkernel.py (make_fn -> _kernel) and
//                     tools/profile_transpose.py (pallas_t -> kern_body):
//                     packed u32 plane (H, W/4) -> the megakernel's feed
//                     layout xbd (rst*16, nbh*nsr)
//   gj_transpose_u32  tools/profile_transpose.py (pallas_2d -> kern2) and
//                     tools/profile_prims.py (f_t -> k_t): 2-D transpose
//   gj_pair_sum_rows  tools/profile_prims.py (f_s2 -> k_s2): x[0::2] +
//                     x[1::2], u32 with wraparound (the decimation
//                     primitive)
//   gj_pack_u8_quads  tools/profile_prims.py (f_b -> k_b): the low bytes of
//                     four rows into one u32 word, row 4i in the low byte
//
// Bound: bytes, all four (each word read once and written once at 3.35
// TB/s; no arithmetic to speak of).  The TPU kernels shaped their blocks
// by the (8, 128) tiling and its lane/sublane transposes; here each kernel
// moves words so that a warp's global loads and stores are contiguous,
// and the transposing ones turn the access order around in shared memory
// with one pad word a row against bank conflicts.  Simple first: 4-byte
// accesses in the two transposing kernels, 16-byte vectors in the two
// row kernels where the rows allow them.
//
// Words are u32 bit patterns (int32 tensors in the wrappers).  Plain C
// interface for ctypes; each launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---- xbd relayout ----------------------------------------------------------
// in (H, W4) words, H = nbh * 8, W4 = nsr * rst * 2; out (rst * 16, nbh *
// nsr): out[b * 16 + r * 2 + k][g * nsr + sr] = in[g * 8 + r][(sr * rst +
// b) * 2 + k].  A CTA takes block row g and kSeg segments sr0.. of it: it
// reads the 8 rows' kSeg * 2 rst words (contiguous runs), keeps them in
// shared memory at a row pitch of 2 rst + 1 words a segment (so the
// store's reads, one segment a lane, fall in distinct banks), and writes
// each of the rst * 16 output rows' kSeg contiguous words.
constexpr int kSeg = 32;          // segments a CTA (one a lane)
constexpr int kXbdThreads = 256;

__global__ void __launch_bounds__(kXbdThreads)
xbd_relayout_kernel(const uint32_t* __restrict__ in, int W4, int nsr,
                    int rst, int64_t out_pitch, uint32_t* __restrict__ out) {
    extern __shared__ uint32_t s[];  // [r][seg][2 rst + 1]
    const int g = blockIdx.y, sr0 = blockIdx.x * kSeg;
    const int nseg = min(kSeg, nsr - sr0);
    const int q = 2 * rst, pitch = q + 1;
    const int run = nseg * q;                      // words a row
    for (int e = threadIdx.x; e < 8 * run; e += kXbdThreads) {
        const int r = e / run, c = e - r * run;
        const int j = c / q;
        s[(r * kSeg + j) * pitch + c - j * q] =
            in[(int64_t)(g * 8 + r) * W4 + (int64_t)sr0 * q + c];
    }
    __syncthreads();
    uint32_t* const o = out + (int64_t)g * nsr + sr0;
    for (int e = threadIdx.x; e < 16 * rst * kSeg; e += kXbdThreads) {
        const int row = e / kSeg, j = e - row * kSeg;  // row = b*16 + r*2 + k
        if (j < nseg) {
            const int b = row >> 4, r = (row >> 1) & 7, k = row & 1;
            o[row * out_pitch + j] = s[(r * kSeg + j) * pitch + b * 2 + k];
        }
    }
}

// ---- 2-D transpose ---------------------------------------------------------
// in (R, C) -> out (C, R).  A CTA of 32 x 4 threads moves a 32 x 32 tile
// through shared memory (one pad word a row), 8 rows a thread, reading
// and writing 128-byte rows.
constexpr int kT = 32, kTRows = 4;

__global__ void __launch_bounds__(kT * kTRows)
transpose_kernel(const uint32_t* __restrict__ in, int R, int C,
                 uint32_t* __restrict__ out) {
    __shared__ uint32_t tile[kT][kT + 1];
    const int c0 = blockIdx.x * kT, r0 = blockIdx.y * kT;
    const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
    for (int i = 0; i < kT; i += kTRows) {
        const int r = r0 + ty + i, c = c0 + tx;
        if (r < R && c < C) tile[ty + i][tx] = in[(int64_t)r * C + c];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kT; i += kTRows) {
        const int c = c0 + ty + i, r = r0 + tx;   // out row c, column r
        if (c < C && r < R) out[(int64_t)c * R + r] = tile[tx][ty + i];
    }
}

// ---- row pair sums and byte quads ------------------------------------------
// Both walk the output in a grid-stride loop, 4 words (one 16-byte
// vector) a step when C % 4 == 0 and the pointers are 16-byte aligned,
// else one word.
constexpr int kRowThreads = 256;

template <bool kVec>
__global__ void __launch_bounds__(kRowThreads)
pair_sum_kernel(const uint32_t* __restrict__ in, int64_t rows_out, int C,
                uint32_t* __restrict__ out) {
    const int w = kVec ? 4 : 1;
    const int cw = C / w;
    const int64_t n = rows_out * cw;
    for (int64_t e = blockIdx.x * (int64_t)kRowThreads + threadIdx.x; e < n;
         e += (int64_t)gridDim.x * kRowThreads) {
        const int64_t i = e / cw;
        const int c = (int)(e - i * cw) * w;
        const uint32_t* const a = in + 2 * i * C + c;
        if (kVec) {
            const uint4 x = *reinterpret_cast<const uint4*>(a);
            const uint4 y = *reinterpret_cast<const uint4*>(a + C);
            *reinterpret_cast<uint4*>(out + i * C + c) =
                make_uint4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
        } else {
            out[i * C + c] = a[0] + a[C];
        }
    }
}

__device__ __forceinline__ uint32_t quad(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
    return (a & 255u) | (b & 255u) << 8 | (c & 255u) << 16 | d << 24;
}

template <bool kVec>
__global__ void __launch_bounds__(kRowThreads)
pack_quads_kernel(const uint32_t* __restrict__ in, int64_t rows_out, int C,
                  uint32_t* __restrict__ out) {
    const int w = kVec ? 4 : 1;
    const int cw = C / w;
    const int64_t n = rows_out * cw;
    for (int64_t e = blockIdx.x * (int64_t)kRowThreads + threadIdx.x; e < n;
         e += (int64_t)gridDim.x * kRowThreads) {
        const int64_t i = e / cw;
        const int c = (int)(e - i * cw) * w;
        const uint32_t* const a = in + 4 * i * C + c;
        if (kVec) {
            uint4 v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
                v[k] = *reinterpret_cast<const uint4*>(a + k * C);
            *reinterpret_cast<uint4*>(out + i * C + c) = make_uint4(
                quad(v[0].x, v[1].x, v[2].x, v[3].x),
                quad(v[0].y, v[1].y, v[2].y, v[3].y),
                quad(v[0].z, v[1].z, v[2].z, v[3].z),
                quad(v[0].w, v[1].w, v[2].w, v[3].w));
        } else {
            out[i * C + c] = quad(a[0], a[C], a[2 * C], a[3 * C]);
        }
    }
}

// CTAs of a grid-stride row kernel: enough to cover the card a few times
int row_grid(int64_t steps) {
    const int64_t want = (steps + kRowThreads - 1) / kRowThreads;
    return (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// in: (H, W4) words, H a multiple of 8, W4 a multiple of 2 rst; out:
// (rst * 16, H / 8 * W4 / (2 rst)) words.  rst at most 23 (the CTA's
// shared memory stays within 48 KB).
extern "C" int gj_xbd_relayout(const void* in, int H, int W4, int rst,
                               void* out, void* stream) {
    if (H % 8 || rst < 1 || rst > 23 || W4 % (2 * rst))
        return (int)cudaErrorInvalidValue;
    const int nbh = H / 8, nsr = W4 / (2 * rst);
    if (nbh == 0 || nsr == 0) return (int)cudaGetLastError();
    if (nbh > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((nsr + kSeg - 1) / kSeg, nbh);
    const size_t smem = (size_t)8 * kSeg * (2 * rst + 1) * 4;
    xbd_relayout_kernel<<<grid, kXbdThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)in, W4, nsr, rst, (int64_t)nbh * nsr,
        (uint32_t*)out);
    return (int)cudaGetLastError();
}

// in: (R, C) words; out: (C, R) words
extern "C" int gj_transpose_u32(const void* in, int R, int C, void* out,
                                void* stream) {
    if (R < 0 || C < 0) return (int)cudaErrorInvalidValue;
    if (R == 0 || C == 0) return (int)cudaGetLastError();
    const dim3 grid((C + kT - 1) / kT, (R + kT - 1) / kT);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    transpose_kernel<<<grid, dim3(kT, kTRows), 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, R, C, (uint32_t*)out);
    return (int)cudaGetLastError();
}

// in: (R, C) words, R even; out: (R / 2, C) words
extern "C" int gj_pair_sum_rows(const void* in, int64_t R, int C, void* out,
                                void* stream) {
    if (R < 0 || R % 2 || C < 0) return (int)cudaErrorInvalidValue;
    const int64_t rows = R / 2;
    const bool vec = C % 4 == 0 && aligned16(in) && aligned16(out);
    const int64_t steps = rows * (vec ? C / 4 : C);
    if (steps == 0) return (int)cudaGetLastError();
    auto* st = (cudaStream_t)stream;
    if (vec)
        pair_sum_kernel<true><<<row_grid(steps), kRowThreads, 0, st>>>(
            (const uint32_t*)in, rows, C, (uint32_t*)out);
    else
        pair_sum_kernel<false><<<row_grid(steps), kRowThreads, 0, st>>>(
            (const uint32_t*)in, rows, C, (uint32_t*)out);
    return (int)cudaGetLastError();
}

// in: (R, C) words (their low bytes are used), R a multiple of 4; out:
// (R / 4, C) words
extern "C" int gj_pack_u8_quads(const void* in, int64_t R, int C, void* out,
                                void* stream) {
    if (R < 0 || R % 4 || C < 0) return (int)cudaErrorInvalidValue;
    const int64_t rows = R / 4;
    const bool vec = C % 4 == 0 && aligned16(in) && aligned16(out);
    const int64_t steps = rows * (vec ? C / 4 : C);
    if (steps == 0) return (int)cudaGetLastError();
    auto* st = (cudaStream_t)stream;
    if (vec)
        pack_quads_kernel<true><<<row_grid(steps), kRowThreads, 0, st>>>(
            (const uint32_t*)in, rows, C, (uint32_t*)out);
    else
        pack_quads_kernel<false><<<row_grid(steps), kRowThreads, 0, st>>>(
            (const uint32_t*)in, rows, C, (uint32_t*)out);
    return (int)cudaGetLastError();
}
