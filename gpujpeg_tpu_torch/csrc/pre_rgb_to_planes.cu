// Encode preprocessor for Hopper (sm_90a): interleaved 8-bit RGB pixels ->
// one zero-padded uint8 plane per component, colour-transformed.
//
// Replaces the JAX package's Pallas preprocessor
// (gpujpeg_tpu/ops/prepost_kernel.py: _pre_kernel_body, launched by
// _cached_pre_kernel), which needed in-VMEM transposes and sublane bitcasts
// to reach packed u32 planes on a TPU.  On the card a plane of bytes is the
// same memory as those packed words read little-endian, so the kernel is a
// plain elementwise pass: one thread per group of 4 output samples reads 4
// pixels (12 bytes), applies the reference's fixed-point transform
// (gpujpeg_colorspace.h:64-101, the same integer matrices as
// ops/color.py; colorspace.cuh) and stores one 32-bit word into each of the 3 planes.
// Samples past the image's real width or height are written as 0, which is
// the zero padding up to (data_h, data_w).
//
// Bound: bytes.  An 8K frame reads 99.5 MB and writes 99.5 MB, about
// 0.06 ms at 3.35 TB/s; the integer arithmetic is ~30 operations a sample.
// The design keeps every store a coalesced 32-bit word; the 3-byte pixel
// reads are byte loads that the L1 merges.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "colorspace.cuh"

namespace {

using gj::ColorParams;
using gj::convert;

__global__ void __launch_bounds__(256)
pre_rgb_to_planes_kernel(const uint8_t* __restrict__ raw, int H, int W,
                         int data_h, int data_w, ColorParams p,
                         uint8_t* __restrict__ out) {
    const int64_t groups_per_row = data_w / 4;
    const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= (int64_t)data_h * groups_per_row) return;
    const int y = (int)(gid / groups_per_row);
    const int x0 = (int)(gid % groups_per_row) * 4;
    uint32_t w0 = 0, w1 = 0, w2 = 0;
    if (y < H) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int x = x0 + j;
            if (x < W) {
                const uint8_t* px = raw + ((int64_t)y * W + x) * 3;
                int c0 = px[0], c1 = px[1], c2 = px[2];
                convert(p, c0, c1, c2);
                w0 |= (uint32_t)c0 << (8 * j);
                w1 |= (uint32_t)c1 << (8 * j);
                w2 |= (uint32_t)c2 << (8 * j);
            }
        }
    }
    const int64_t plane = (int64_t)data_h * data_w;
    const int64_t o = (int64_t)y * data_w + x0;
    *reinterpret_cast<uint32_t*>(out + o) = w0;
    *reinterpret_cast<uint32_t*>(out + plane + o) = w1;
    *reinterpret_cast<uint32_t*>(out + 2 * plane + o) = w2;
}

}  // namespace

extern "C" int gj_pre_rgb_to_planes(const void* raw, int H, int W,
                                    int data_h, int data_w,
                                    const int* params, void* out,
                                    void* stream) {
    // params: int32[26] = from-matrix[9], from-base[3], to-matrix[9],
    // to-base[3], use_from, use_to (ops/color.kernel_params), host memory
    ColorParams p;
    static_assert(sizeof(ColorParams) == 26 * sizeof(int), "layout");
    std::memcpy(&p, params, sizeof(p));
    const int64_t total = (int64_t)data_h * (data_w / 4);
    if (total > 0) {
        const int threads = 256;
        const int64_t blocks = (total + threads - 1) / threads;
        pre_rgb_to_planes_kernel<<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
            (const uint8_t*)raw, H, W, data_h, data_w, p, (uint8_t*)out);
    }
    return (int)cudaGetLastError();
}
