// Fused decode back half for Hopper (sm_90a): quantized zig-zag
// coefficients of 3 components, chroma decimated by dx, dy in {1, 2} ->
// interleaved 8-bit pixels.  Dequantization, inverse DCT, nearest chroma
// upsampling, the colour transform and the store in one pass.
//
// Replaces the JAX package's Pallas decode tail
// (gpujpeg_tpu/ops/prepost_kernel.py: _dpost_kernel_body, launched by
// _cached_dpost_kernel through decode_post_fused).  On the TPU the IDCT was
// an MXU matmul over 128-lane-aligned tiles of block rows, with the
// upsampling folded into (dx*dy*64, 64) chroma matrices
// (_dpost_matrices) and lane-parity selects, followed by sublane-strided
// stores to fold blocks into raster rows and an RGBX word store that the
// caller sliced to RGB; here one thread computes one sample of one luma
// block and the chroma samples that pixel takes, and stores its 3 bytes
// where they belong, so the block count needs no alignment and a ragged
// last segment is simply skipped.
//
// Upsampling: the pixel of luma block (by, bx), sample (r, c) takes chroma
// block (by / dy, bx / dx), sample ((by % dy) * 8 + r) / dy,
// ((bx % dx) * 8 + c) / dx: nearest upsampling, the plain version's rule
// (ops/sample.postprocess) wherever ops/prepost_kernel.
// decode_post_supported holds.  Each of the dx * dy pixels that share a
// chroma sample recomputes it (its own 64-FMA chain): 3 chains a pixel at
// every decimation, so 4:2:0 does twice the chroma arithmetic it needs.
//
// The result must equal the plain version (ops/dct.dequantize_idct, then
// ops/sample.postprocess) bit for bit, so the arithmetic order is fixed:
// the FMA chain of idct.cuh (shared with idct_planes.cu), then the integer
// colour transform of colorspace.cuh.
//
// Design, after fdct_quant.cu: a CTA of 256 threads takes 32 luma blocks
// at a time (grid-stride) and, for each, the chroma blocks its pixels take,
// loads their coefficients from the (64, L) layout (a warp reads one
// coefficient of 32 neighbouring blocks), dequantizes them into shared
// memory as rows of 64 floats, and then thread (j, s) computes sample s of
// blocks j, j+4, ..., keeping column s of N in 64 registers for the whole
// launch and reading the dequantized rows as float4 broadcasts.  At dx = dy
// = 1 the chroma chains use the same column; otherwise the chroma sample
// differs from s with the block's parity, so the chroma chains read their
// column of N from a copy in shared memory.  The three components' FMA
// chains run side by side.
//
// Bound: operations.  At 8K 4:4:4 every one of 3 x 33.2 M samples takes 64
// FMA: 12.7 GFLOP, about 0.19 ms at 67 TFLOP/s of non-tensor f32 (the bytes,
// 199.1 MB of coefficients in and 99.5 MB of pixels out, take about 0.089
// ms at 3.35 TB/s).  At 4:2:0 the 49.8 M samples need 6.4 GFLOP, about
// 0.095 ms; the bytes (99.5 MB in, 99.5 MB out) 0.059 ms.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "colorspace.cuh"
#include "idct.cuh"

namespace {

constexpr int kGroup = 32;        // luma blocks per iteration
constexpr int kThreads = 256;
constexpr int kRow = 68;          // floats per dequantized row (16B-aligned)

struct Offsets {
    int64_t c[3];
};

template <bool kSub>
__global__ void __launch_bounds__(kThreads)
dpost_rgb_kernel(const int16_t* __restrict__ coefs, int64_t L, Offsets off,
                 int64_t nblk, int bpr, int dx, int dy, int H, int W,
                 const float* __restrict__ qtabs,
                 const float* __restrict__ nmat, gj::ColorParams p,
                 uint8_t* __restrict__ out) {
    __shared__ __align__(16) float ys[3][kGroup][kRow];
    __shared__ float qs[3][64];
    __shared__ float nsh[kSub ? 64 * 64 : 1];
    const int tid = threadIdx.x;
    const int s = tid & 63;          // sample: row s >> 3, column s & 7
    const int jj = tid >> 6;
    for (int i = tid; i < 3 * 64; i += kThreads) qs[i >> 6][i & 63] =
        qtabs[i];
    if (kSub)
        for (int i = tid; i < 64 * 64; i += kThreads) nsh[i] = nmat[i];
    float n[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) n[k] = nmat[k * 64 + s];
    __syncthreads();
    const int cbpr = bpr / dx;       // chroma blocks per row
    const int64_t ngroups = (nblk + kGroup - 1) / kGroup;
    for (int64_t g = blockIdx.x; g < ngroups; g += gridDim.x) {
        const int64_t i0 = g * kGroup;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            for (int e = tid; e < 64 * kGroup; e += kThreads) {
                const int k = e / kGroup;
                const int gi = e % kGroup;
                int64_t i = i0 + gi;
                if (kSub && c > 0 && i < nblk) {
                    const int64_t by = i / bpr, bx = i - by * bpr;
                    i = (by / dy) * cbpr + bx / dx;
                }
                const int v = i0 + gi < nblk ? coefs[k * L + off.c[c] + i]
                                             : 0;
                ys[c][gi][k] = (float)v * qs[c][k];
            }
        }
        __syncthreads();
        for (int gi = jj; gi < kGroup; gi += kThreads / 64) {
            const int64_t i = i0 + gi;
            if (i >= nblk) break;
            const int64_t by = i / bpr, bx = i - by * bpr;
            float a[3];
            if (kSub) {
                // chroma sample of this pixel in its chroma block
                const int sr = ((int)(by % dy) * 8 + (s >> 3)) / dy;
                const int sc = ((int)(bx % dx) * 8 + (s & 7)) / dx;
                const float* nc = nsh + sr * 8 + sc;   // column, stride 64
                const float* y0 = ys[0][gi];
                const float* y1 = ys[1][gi];
                const float* y2 = ys[2][gi];
                a[0] = a[1] = a[2] = 0.f;
#pragma unroll
                for (int k = 0; k < 64; k += 4) {
                    const float4 v0 = *reinterpret_cast<const float4*>(y0 + k);
                    const float4 v1 = *reinterpret_cast<const float4*>(y1 + k);
                    const float4 v2 = *reinterpret_cast<const float4*>(y2 + k);
                    const float m0 = nc[k * 64], m1 = nc[(k + 1) * 64],
                                m2 = nc[(k + 2) * 64], m3 = nc[(k + 3) * 64];
                    a[0] = fmaf(v0.x, n[k], a[0]);
                    a[1] = fmaf(v1.x, m0, a[1]);
                    a[2] = fmaf(v2.x, m0, a[2]);
                    a[0] = fmaf(v0.y, n[k + 1], a[0]);
                    a[1] = fmaf(v1.y, m1, a[1]);
                    a[2] = fmaf(v2.y, m1, a[2]);
                    a[0] = fmaf(v0.z, n[k + 2], a[0]);
                    a[1] = fmaf(v1.z, m2, a[1]);
                    a[2] = fmaf(v2.z, m2, a[2]);
                    a[0] = fmaf(v0.w, n[k + 3], a[0]);
                    a[1] = fmaf(v1.w, m3, a[1]);
                    a[2] = fmaf(v2.w, m3, a[2]);
                }
            } else {
                const float* const yr[3] = {ys[0][gi], ys[1][gi], ys[2][gi]};
                gj::idct_chains<3>(yr, n, a);
            }
            int v0 = gj::idct_to_sample(a[0]), v1 = gj::idct_to_sample(a[1]),
                v2 = gj::idct_to_sample(a[2]);
            gj::convert(p, v0, v1, v2);
            const int64_t y = by * 8 + (s >> 3), x = bx * 8 + (s & 7);
            if (y < H && x < W) {
                uint8_t* px = out + (y * W + x) * 3;
                px[0] = (uint8_t)v0;
                px[1] = (uint8_t)v1;
                px[2] = (uint8_t)v2;
            }
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int gj_dpost_rgb(const void* coefs, int64_t L,
                            const int64_t* offsets, int64_t nblk, int bpr,
                            int dx, int dy, int H, int W, const void* qtabs,
                            const void* nmat, const int* params, void* out,
                            void* stream) {
    // coefs: (64, L) i16 with DC integrated; offsets: host int64[3], the
    // column of each component's first block; nblk: luma blocks, bpr of
    // them a block row (chroma: nblk / (dx dy) blocks, bpr / dx a row);
    // dx, dy in {1, 2}; qtabs: (3, 64) f32 zig-zag; nmat: (64, 64) f32,
    // N[k][s]; params: host int32[26] (ops/color.kernel_params); out:
    // (H, W, 3) u8
    gj::ColorParams p;
    static_assert(sizeof(gj::ColorParams) == 26 * sizeof(int), "layout");
    std::memcpy(&p, params, sizeof(p));
    Offsets off;
    for (int c = 0; c < 3; ++c) off.c[c] = offsets[c];
    if (dx < 1 || dx > 2 || dy < 1 || dy > 2 || bpr % dx)
        return (int)cudaErrorInvalidValue;
    const int64_t ngroups = (nblk + kGroup - 1) / kGroup;
    if (ngroups > 0) {
        const int64_t grid = ngroups < 4096 ? ngroups : 4096;
        if (dx * dy > 1)
            dpost_rgb_kernel<true><<<(unsigned)grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
                (const int16_t*)coefs, L, off, nblk, bpr, dx, dy, H, W,
                (const float*)qtabs, (const float*)nmat, p, (uint8_t*)out);
        else
            dpost_rgb_kernel<false><<<(unsigned)grid, kThreads, 0,
                                      (cudaStream_t)stream>>>(
                (const int16_t*)coefs, L, off, nblk, bpr, dx, dy, H, W,
                (const float*)qtabs, (const float*)nmat, p, (uint8_t*)out);
    }
    return (int)cudaGetLastError();
}
