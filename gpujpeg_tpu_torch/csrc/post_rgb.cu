// Decode postprocessor for Hopper (sm_90a): three uint8 component planes
// (any chroma decimation) -> interleaved 8-bit pixels.  Nearest-neighbour
// chroma upsampling, the colour transform and the pixel store.
//
// Replaces the JAX package's Pallas postprocessor
// (gpujpeg_tpu/ops/prepost_kernel.py: _post_kernel_body, launched by
// _cached_post_kernel through postprocess_packed), the tail of its
// interleaved decode.  On the TPU the kernel read packed u32 planes,
// repeated chroma samples along sublanes after a transpose, took the
// y-upsample from a row gather in XLA, needed W % (16 dx) == 0 and wrote
// RGBX words that the caller sliced to RGB.  Here a thread makes 16
// neighbouring pixels of one row of any image: pixel (y, x) takes sample
// (y / fy_c, x / fx_c) of each component c's plane, converts
// (colorspace.cuh) and stores 3 bytes.  The factors come from the wrapper
// (ops/prepost_kernel.postprocess_packed): fy_c = ceil(H / height_c),
// fx_c = ceil(W / width_c), the nearest-neighbour rule of the plain
// version (ops/sample.postprocess, after the JAX package's
// sample._upsample_to); for dx, dy <= 2 that is the Pallas kernel's
// min(y / dy, height_c - 1), x / dx.
//
// Bound: bytes.  At 8K 4:2:0 the kernel reads the 33.2 MB luma plane and
// two 8.3 MB chroma planes and writes the 99.5 MB image, about 0.045 ms
// at 3.35 TB/s (4:4:4: three 33.2 MB planes, about 0.059 ms).  At one
// pixel a thread the work was instructions: a 64-bit division for the
// pixel's row, six 32-bit divisions by the factors, three byte loads and
// three byte stores a pixel.  So:
//   - a 2-D grid (rows x groups of 16 columns): no division for y or x;
//   - luma at (1, 1) and both chroma planes at one (fy, fx) in {1, 2}^2
//     (every layout the decoder takes) are template instances where the
//     upsampling is a shift; anything else takes one generic instance
//     whose factors are divided once a thread (for its row and its first
//     column) and stepped without division along its 16 pixels;
//   - 8-byte loads: every plane's data_w is a multiple of 8 (whole
//     blocks), so a group's 16 luma bytes are two aligned 8-byte loads and
//     its chroma bytes one (fx = 2) or two; the generic instance, and
//     planes off 8-byte alignment, read bytes;
//   - 16-byte stores: when W % 16 == 0 (8K, HD) a group's 48 bytes start
//     on a 16-byte boundary and go out as three 16-byte stores; otherwise
//     the pixels of the group that lie inside the row go out as bytes.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "colorspace.cuh"

namespace {

constexpr int kGroup = 16;         // pixels a thread
constexpr int kThreads = 256;

struct Planes {
    const uint8_t* p[3];
    int stride[3];    // data_w of each plane
    int fy[3], fx[3];
};

__device__ __forceinline__ uint32_t byte_of(uint2 v, int i) {
    return ((i < 4 ? v.x : v.y) >> (8 * (i & 3))) & 0xFFu;
}

// the 16 samples of a group, for one plane: byte i is sample x0 + i (SX =
// 0) or x0 / 2 + i (SX = 1, only bytes 0..7 are used); the second 8 bytes
// are read only when the group's pixels need them
template <int SX>
__device__ __forceinline__ void load16(const uint8_t* rowp, int xs, bool two,
                                       uint2& a, uint2& b) {
    a = __ldg(reinterpret_cast<const uint2*>(rowp + xs));
    b = make_uint2(0u, 0u);
    if (SX == 0 && two) b = __ldg(reinterpret_cast<const uint2*>(rowp + xs + 8));
}

// write a group's 48 bytes: three 16-byte stores (vec), or the bytes of
// its first n pixels
__device__ __forceinline__ void store_group(uint8_t* px, const uint32_t (&o)[12],
                                            bool vec, int n) {
    if (vec) {
        uint4* d = reinterpret_cast<uint4*>(px);
        d[0] = make_uint4(o[0], o[1], o[2], o[3]);
        d[1] = make_uint4(o[4], o[5], o[6], o[7]);
        d[2] = make_uint4(o[8], o[9], o[10], o[11]);
    } else {
#pragma unroll
        for (int i = 0; i < 3 * kGroup; ++i)
            if (i < 3 * n) px[i] = (uint8_t)(o[i >> 2] >> (8 * (i & 3)));
    }
}

__device__ __forceinline__ void put_pixel(uint32_t (&o)[12], int i, int r,
                                          int g, int b) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const int byte = 3 * i + k;
        const uint32_t v = (uint32_t)(k == 0 ? r : k == 1 ? g : b);
        o[byte >> 2] |= v << (8 * (byte & 3));
    }
}

// luma at (1, 1), both chroma planes at (1 << SY, 1 << SX); planes 8-byte
// aligned with strides that are multiples of 8
template <int SY, int SX>
__global__ void __launch_bounds__(kThreads)
post_rgb_shift(Planes pl, int H, int W, gj::ColorParams p,
               uint8_t* __restrict__ out) {
    const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kGroup;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x0 >= W || y >= H) return;
    const int n = min(kGroup, W - x0);
    const bool two = n > 8;
    uint2 l0, l1, b0, b1, r0, r1;
    load16<0>(pl.p[0] + (int64_t)y * pl.stride[0], x0, two, l0, l1);
    const int yc = y >> SY, xc = x0 >> SX;
    load16<SX>(pl.p[1] + (int64_t)yc * pl.stride[1], xc, two, b0, b1);
    load16<SX>(pl.p[2] + (int64_t)yc * pl.stride[2], xc, two, r0, r1);
    uint32_t o[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) o[k] = 0u;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
        const int ci = i >> SX;
        int c0 = (int)byte_of(i < 8 ? l0 : l1, i & 7);
        int c1 = (int)byte_of(ci < 8 ? b0 : b1, ci & 7);
        int c2 = (int)byte_of(ci < 8 ? r0 : r1, ci & 7);
        gj::convert(p, c0, c1, c2);
        put_pixel(o, i, c0, c1, c2);
    }
    store_group(out + ((int64_t)y * W + x0) * 3, o, (W & 15) == 0, n);
}

// any factors, any plane alignment
__global__ void __launch_bounds__(kThreads)
post_rgb_generic(Planes pl, int H, int W, gj::ColorParams p,
                 uint8_t* __restrict__ out) {
    const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kGroup;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x0 >= W || y >= H) return;
    const int n = min(kGroup, W - x0);
    const uint8_t* rowp[3];
    int col[3], rem[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        rowp[c] = pl.p[c] + (int64_t)(y / pl.fy[c]) * pl.stride[c];
        col[c] = x0 / pl.fx[c];
        rem[c] = x0 - col[c] * pl.fx[c];
    }
    uint32_t o[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) o[k] = 0u;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
        if (i < n) {
            int v[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                v[c] = rowp[c][col[c]];
                if (++rem[c] == pl.fx[c]) {
                    rem[c] = 0;
                    ++col[c];
                }
            }
            gj::convert(p, v[0], v[1], v[2]);
            put_pixel(o, i, v[0], v[1], v[2]);
        }
    }
    store_group(out + ((int64_t)y * W + x0) * 3, o, (W & 15) == 0, n);
}

}  // namespace

extern "C" int gj_post_rgb(const void* y, const void* cb, const void* cr,
                           const int* geo, int H, int W, const int* params,
                           void* out, void* stream) {
    // y, cb, cr: (data_h_c, data_w_c) u8 planes; geo: host int32[9] =
    // data_w_c[3], fy_c[3], fx_c[3]; params: host int32[26]
    // (ops/color.kernel_params); out: (H, W, 3) u8, 16-byte aligned
    gj::ColorParams p;
    static_assert(sizeof(gj::ColorParams) == 26 * sizeof(int), "layout");
    std::memcpy(&p, params, sizeof(p));
    Planes pl;
    pl.p[0] = (const uint8_t*)y;
    pl.p[1] = (const uint8_t*)cb;
    pl.p[2] = (const uint8_t*)cr;
    bool aligned = true;
    for (int c = 0; c < 3; ++c) {
        pl.stride[c] = geo[c];
        pl.fy[c] = geo[3 + c];
        pl.fx[c] = geo[6 + c];
        aligned = aligned && ((uintptr_t)pl.p[c] & 7) == 0
                  && (pl.stride[c] & 7) == 0;
    }
    if ((int64_t)H * W <= 0) return (int)cudaGetLastError();
    // 16 columns a thread; a block spans up to kThreads groups of a row
    // and as many rows as fill it
    const int groups = (W + kGroup - 1) / kGroup;
    const int bx = std::min(kThreads, (groups + 31) / 32 * 32);
    const dim3 block(bx, kThreads / bx);
    const dim3 grid((groups + bx - 1) / bx, (H + block.y - 1) / block.y);
    cudaStream_t st = (cudaStream_t)stream;
    uint8_t* o = (uint8_t*)out;
    const int sy = pl.fy[1], sx = pl.fx[1];
    const bool shift = aligned && pl.fy[0] == 1 && pl.fx[0] == 1
                       && pl.fy[2] == sy && pl.fx[2] == sx
                       && (sy == 1 || sy == 2) && (sx == 1 || sx == 2);
    if (!shift)
        post_rgb_generic<<<grid, block, 0, st>>>(pl, H, W, p, o);
    else if (sy == 1 && sx == 1)
        post_rgb_shift<0, 0><<<grid, block, 0, st>>>(pl, H, W, p, o);
    else if (sy == 1)
        post_rgb_shift<0, 1><<<grid, block, 0, st>>>(pl, H, W, p, o);
    else if (sx == 1)
        post_rgb_shift<1, 0><<<grid, block, 0, st>>>(pl, H, W, p, o);
    else
        post_rgb_shift<1, 1><<<grid, block, 0, st>>>(pl, H, W, p, o);
    return (int)cudaGetLastError();
}
