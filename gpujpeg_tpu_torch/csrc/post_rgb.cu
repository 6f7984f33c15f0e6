// Decode postprocessor for Hopper (sm_90a): three uint8 component planes
// (any chroma decimation) -> interleaved 8-bit pixels.  Nearest-neighbour
// chroma upsampling, the colour transform and a 3-byte store.
//
// Replaces the JAX package's Pallas postprocessor
// (gpujpeg_tpu/ops/prepost_kernel.py: _post_kernel_body, launched by
// _cached_post_kernel through postprocess_packed), the tail of its
// interleaved decode.  On the TPU the kernel read packed u32 planes,
// repeated chroma samples along sublanes after a transpose, took the
// y-upsample from a row gather in XLA, needed W % (16 dx) == 0 and wrote
// RGBX words that the caller sliced to RGB.  Here one thread makes one
// pixel of any width: it reads sample (y / fy_c, x / fx_c) of each
// component c's plane, converts (colorspace.cuh) and stores its 3 bytes
// where they belong.  The factors come from the wrapper
// (ops/prepost_kernel.postprocess_packed): fy_c = ceil(H / height_c),
// fx_c = ceil(W / width_c), the nearest-neighbour rule of the plain
// version (ops/sample.postprocess, after the JAX package's
// sample._upsample_to); for dx, dy <= 2 that is the Pallas kernel's
// min(y / dy, height_c - 1), x / dx.
//
// Bound: bytes.  At 8K 4:2:0 the kernel reads the 33.2 MB luma plane and
// two 8.3 MB chroma planes (each chroma sample is read by 4 pixels, from
// the L1) and writes the 99.5 MB image, about 0.045 ms at 3.35 TB/s.
// Neighbouring threads read neighbouring bytes and store neighbouring
// 3-byte pixels, which the L2 merges into full lines.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "colorspace.cuh"

namespace {

struct Planes {
    const uint8_t* p[3];
    int stride[3];    // data_w of each plane
    int fy[3], fx[3];
};

__global__ void __launch_bounds__(256)
post_rgb_kernel(Planes pl, int H, int W, gj::ColorParams p,
                uint8_t* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)H * W) return;
    const int y = (int)(i / W);
    const int x = (int)(i - (int64_t)y * W);
    int v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
        v[c] = pl.p[c][(int64_t)(y / pl.fy[c]) * pl.stride[c]
                       + x / pl.fx[c]];
    gj::convert(p, v[0], v[1], v[2]);
    uint8_t* px = out + i * 3;
    px[0] = (uint8_t)v[0];
    px[1] = (uint8_t)v[1];
    px[2] = (uint8_t)v[2];
}

}  // namespace

extern "C" int gj_post_rgb(const void* y, const void* cb, const void* cr,
                           const int* geo, int H, int W, const int* params,
                           void* out, void* stream) {
    // y, cb, cr: (data_h_c, data_w_c) u8 planes; geo: host int32[9] =
    // data_w_c[3], fy_c[3], fx_c[3]; params: host int32[26]
    // (ops/color.kernel_params); out: (H, W, 3) u8
    gj::ColorParams p;
    static_assert(sizeof(gj::ColorParams) == 26 * sizeof(int), "layout");
    std::memcpy(&p, params, sizeof(p));
    Planes pl;
    pl.p[0] = (const uint8_t*)y;
    pl.p[1] = (const uint8_t*)cb;
    pl.p[2] = (const uint8_t*)cr;
    for (int c = 0; c < 3; ++c) {
        pl.stride[c] = geo[c];
        pl.fy[c] = geo[3 + c];
        pl.fx[c] = geo[6 + c];
    }
    const int64_t total = (int64_t)H * W;
    if (total > 0) {
        const int threads = 256;
        const int64_t blocks = (total + threads - 1) / threads;
        post_rgb_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(pl, H, W, p,
                                                  (uint8_t*)out);
    }
    return (int)cudaGetLastError();
}
