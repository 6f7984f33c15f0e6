// Encode preprocessor for Hopper (sm_90a): interleaved 8-bit RGB pixels ->
// zero-padded uint8 planes of the components that share one decimation
// (dx, dy), colour-transformed.
//
// Replaces the JAX package's Pallas preprocessor
// (gpujpeg_tpu/ops/prepost_kernel.py: _pre_kernel_body, launched by
// _cached_pre_kernel), which needed in-VMEM transposes and sublane bitcasts
// to reach packed u32 planes on a TPU.  On the card a plane of bytes is the
// same memory as those packed words read little-endian, so the kernel is a
// plain elementwise pass: one thread per group of 4 output samples reads
// the 4 source pixels (y * dy, x * dx) (12 bytes at 4:4:4), applies the
// reference's fixed-point transform (gpujpeg_colorspace.h:64-101, the same
// integer matrices as ops/color.py; colorspace.cuh) and stores one 32-bit
// word into each requested plane.  Decimation is pure selection, as in the
// reference (gpujpeg_preprocessor.cu:51-64), so it commutes with the
// transform.  Samples whose source lies past the image's width or height
// are written as 0, which is the zero padding up to (data_h, data_w).  The
// wrapper (ops/prepost_kernel.py) launches once per decimation group, as
// the JAX package groups its components: once at 4:4:4, twice (luma;
// chroma) at 4:2:0.
//
// Bound: bytes.  An 8K 4:4:4 frame reads 99.5 MB and writes 99.5 MB, about
// 0.06 ms at 3.35 TB/s; at 4:2:0 the chroma launch reads a quarter of the
// pixels and both write 49.8 MB.  The integer arithmetic is ~30 operations
// a sample.  The design keeps every store a coalesced 32-bit word; the
// 3-byte pixel reads are byte loads that the L1 merges.
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

struct Outs {
    uint8_t* p[3];   // plane of component k, or null when not requested
};

__global__ void __launch_bounds__(256)
pre_rgb_to_planes_kernel(const uint8_t* __restrict__ raw, int H, int W,
                         int dx, int dy, int data_h, int data_w,
                         ColorParams p, Outs out) {
    const int64_t groups_per_row = data_w / 4;
    const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= (int64_t)data_h * groups_per_row) return;
    const int y = (int)(gid / groups_per_row);
    const int x0 = (int)(gid % groups_per_row) * 4;
    const int sy = y * dy;
    uint32_t w0 = 0, w1 = 0, w2 = 0;
    if (sy < H) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int sx = (x0 + j) * dx;
            if (sx < W) {
                const uint8_t* px = raw + ((int64_t)sy * W + sx) * 3;
                int c0 = px[0], c1 = px[1], c2 = px[2];
                convert(p, c0, c1, c2);
                w0 |= (uint32_t)c0 << (8 * j);
                w1 |= (uint32_t)c1 << (8 * j);
                w2 |= (uint32_t)c2 << (8 * j);
            }
        }
    }
    const int64_t o = (int64_t)y * data_w + x0;
    if (out.p[0]) *reinterpret_cast<uint32_t*>(out.p[0] + o) = w0;
    if (out.p[1]) *reinterpret_cast<uint32_t*>(out.p[1] + o) = w1;
    if (out.p[2]) *reinterpret_cast<uint32_t*>(out.p[2] + o) = w2;
}

}  // namespace

extern "C" int gj_pre_rgb_to_planes(const void* raw, int H, int W, int dx,
                                    int dy, int data_h, int data_w,
                                    const int* params, void* out0,
                                    void* out1, void* out2, void* stream) {
    // raw: (H, W, 3) u8; (dx, dy): the group's decimation; out_k: (data_h,
    // data_w) u8 plane of component k with data_w % 4 == 0, or null;
    // params: int32[26] = from-matrix[9], from-base[3], to-matrix[9],
    // to-base[3], use_from, use_to (ops/color.kernel_params), host memory
    ColorParams p;
    static_assert(sizeof(ColorParams) == 26 * sizeof(int), "layout");
    std::memcpy(&p, params, sizeof(p));
    Outs out{{(uint8_t*)out0, (uint8_t*)out1, (uint8_t*)out2}};
    const int64_t total = (int64_t)data_h * (data_w / 4);
    if (total > 0) {
        const int threads = 256;
        const int64_t blocks = (total + threads - 1) / threads;
        pre_rgb_to_planes_kernel<<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
            (const uint8_t*)raw, H, W, dx, dy, data_h, data_w, p, out);
    }
    return (int)cudaGetLastError();
}
