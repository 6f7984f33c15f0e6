// Decode postprocessor for Hopper (sm_90a): 1, 3 or 4 uint8 component
// planes (any chroma decimation) -> the raw 8-bit image of any of the
// seven pixel formats.  Nearest-neighbour chroma upsampling, the colour
// transform and the pixel store.
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
//     (the RGB layouts of 4:4:4 to 4:2:0) are template instances where
//     the upsampling is a shift; other factors, and planes off 8-byte
//     alignment, take the generic instance below;
//   - 8-byte loads: every plane's data_w is a multiple of 8 (whole
//     blocks), so a group's 16 luma bytes are two aligned 8-byte loads and
//     its chroma bytes one (fx = 2) or two;
//   - 16-byte stores: when W % 16 == 0 (8K, HD) a group's 48 bytes start
//     on a 16-byte boundary and go out as three 16-byte stores; otherwise
//     the pixels of the group that lie inside the row go out as bytes.
// Those are the RGB instances (3 planes to P444_U8_P012).  Every other
// output and layout takes one generic instance a store kind, a pixel a
// thread (a
// pair for UYVY) with a row's pixels on consecutive threads, byte loads,
// a 4-byte store for RGBA and UYVY, byte stores otherwise, factors as
// shifts where they are powers of two, after ops/sample.postprocess: one
// component is filled to three with 128 unless the output is U8; the
// first three channels of three or more are converted, a 4th goes
// through raw; then
//   - interleaved (U8, RGB, RGBA, at unit bytes a pixel): byte k of a
//     pixel is channel k, or 255 (alpha) past the channels;
//   - UYVY: u y0 v y1 a pixel pair, u and v from its first pixel;
//   - planar: sample (y, x) of plane i is channel i of pixel (y dh_i,
//     x dw_i), libyuv plane sizes (sample.pack_channels).
// Bounds at 8K (33.2 Mpx, 3.35 TB/s): to RGBA 0.0693 ms from 4:4:4 planes
// and 0.0545 ms from 4:2:0, to U8 0.0198 ms, 4:2:0 to P420 planar 0.0297
// ms, 4:2:2 to UYVY 0.0396 ms.
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
    const uint8_t* p[4];
    int stride[4];    // data_w of each plane
    int fy[4], fx[4];
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

// A divisor of the generic instances: a shift when it is a power of two
// (every repeat factor and sampling step of the JPEG layouts at sizes
// that are not tiny), else a division
struct Div {
    int d, s;            // s >= 0: d == 1 << s
};

__device__ __forceinline__ int divide(int x, Div q) {
    return q.s >= 0 ? x >> q.s : x / q.d;
}

Div divisor(int d) {
    Div q{d, -1};
    if (d > 0 && (d & (d - 1)) == 0)
        for (q.s = 0; (1 << q.s) < d; ++q.s) {}
    return q;
}

// The output's kinds (ops/prepost_kernel.post_target)
enum Kind { kInterleaved = 0, kUyvy = 1, kPlanar = 2 };

struct Target {
    int kind, unit;      // store kind; bytes a pixel of an interleaved one
    int ncomp, nch;      // planes; channels before packing (3 for one
                         // component to anything but U8)
    int64_t off[3];      // planar: first byte of each plane
    int pw[3];           // planar: plane widths
    Div dh[3], dw[3];    // planar: the image's sampling steps
    Div fy[4], fx[4];    // each plane's repeat factors
};

// pixel (y, x) of the converted image: v[k] for k < nch (one component
// to 3 channels: 128 chroma), then the colour transform of the first
// three when there are three or more
__device__ __forceinline__ void pixel(const Planes& pl, const Target& t,
                                      const gj::ColorParams& p, int y, int x,
                                      int (&v)[4]) {
    v[0] = v[1] = v[2] = 128;
    v[3] = 255;
#pragma unroll
    for (int c = 0; c < 4; ++c)
        if (c < t.ncomp)
            v[c] = pl.p[c][(int64_t)divide(y, t.fy[c]) * pl.stride[c]
                           + divide(x, t.fx[c])];
    if (t.nch >= 3) gj::convert(p, v[0], v[1], v[2]);
}

// byte k of an interleaved pixel: channel k, or 255 (alpha) past the
// channels
__device__ __forceinline__ uint32_t out_byte(const Target& t,
                                             const int (&v)[4], int k) {
    return (uint32_t)(k < t.nch ? v[k] : 255);
}

// any store kind, 1 to 4 planes, any factors, any plane alignment: a
// pixel a thread (a pixel pair for UYVY), a row's pixels on consecutive
// threads so that a warp's loads and stores are consecutive bytes, a
// grid row an image row
template <int KIND>
__global__ void __launch_bounds__(kThreads)
post_generic(Planes pl, Target t, int H, int W, gj::ColorParams p,
             uint8_t* __restrict__ out) {
    const int x = blockIdx.x * kThreads + threadIdx.x;
    for (int y = blockIdx.y; y < H; y += gridDim.y) {
        int v[4];
        if (KIND == kUyvy) {
            // u y0 v y1 of pixels 2x, 2x + 1 in one aligned word (W even)
            if (2 * x >= W) return;
            int w[4];
            pixel(pl, t, p, y, 2 * x, v);
            pixel(pl, t, p, y, 2 * x + 1, w);
            *reinterpret_cast<uint32_t*>(out + (int64_t)y * 2 * W + 4 * x) =
                (uint32_t)v[1] | (uint32_t)v[0] << 8 | (uint32_t)v[2] << 16
                | (uint32_t)w[0] << 24;
            continue;
        }
        if (x >= W) return;
        pixel(pl, t, p, y, x, v);
        if (KIND == kInterleaved) {
            uint8_t* px = out + ((int64_t)y * W + x) * t.unit;
            if (t.unit == 4) {
                *reinterpret_cast<uint32_t*>(px) =
                    out_byte(t, v, 0) | out_byte(t, v, 1) << 8
                    | out_byte(t, v, 2) << 16 | out_byte(t, v, 3) << 24;
            } else {
                px[0] = (uint8_t)out_byte(t, v, 0);
                if (t.unit > 1) px[1] = (uint8_t)out_byte(t, v, 1);
                if (t.unit > 2) px[2] = (uint8_t)out_byte(t, v, 2);
            }
        } else {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const int yk = divide(y, t.dh[k]), xk = divide(x, t.dw[k]);
                if (yk * t.dh[k].d == y && xk * t.dw[k].d == x)
                    out[t.off[k] + (int64_t)yk * t.pw[k] + xk] =
                        (uint8_t)v[k];
            }
        }
    }
}

}  // namespace

extern "C" int gj_post_rgb(const void* p0, const void* p1, const void* p2,
                           const void* p3, const int* geo, int H, int W,
                           const int64_t* dst, const int* params, void* out,
                           void* stream) {
    // p_c: (data_h_c, data_w_c) u8 planes (null past the last component);
    // geo: host int32[16] = components, store kind, unit, channels, then
    // data_w_c[4], fy_c[4], fx_c[4]; dst: host int64[16], for a planar
    // output each plane's first byte, width, row step and column step
    // (ops/prepost_kernel.post_target); params: host int32[26]
    // (ops/color.kernel_params); out: the raw image, 16-byte aligned
    gj::ColorParams p;
    static_assert(sizeof(gj::ColorParams) == 26 * sizeof(int), "layout");
    std::memcpy(&p, params, sizeof(p));
    Target t;
    t.ncomp = geo[0];
    t.kind = geo[1];
    t.unit = geo[2];
    t.nch = geo[3];
    if (t.ncomp < 1 || t.ncomp > 4 || t.kind < kInterleaved
            || t.kind > kPlanar || t.unit < 1 || t.unit > 4 || t.nch < 1
            || t.nch > 4)
        return (int)cudaErrorInvalidValue;
    for (int k = 0; k < 3; ++k) {
        t.off[k] = dst[k];
        t.pw[k] = (int)dst[3 + k];
        t.dh[k] = divisor((int)dst[6 + k]);
        t.dw[k] = divisor((int)dst[9 + k]);
        if (t.kind == kPlanar && (dst[6 + k] < 1 || dst[9 + k] < 1))
            return (int)cudaErrorInvalidValue;
    }
    Planes pl;
    const void* ps[4] = {p0, p1, p2, p3};
    bool aligned = true;
    for (int c = 0; c < 4; ++c) {
        pl.p[c] = (const uint8_t*)ps[c];
        pl.stride[c] = geo[4 + c];
        pl.fy[c] = geo[8 + c];
        pl.fx[c] = geo[12 + c];
        t.fy[c] = divisor(pl.fy[c]);
        t.fx[c] = divisor(pl.fx[c]);
        if (c >= t.ncomp) continue;
        if (!pl.p[c] || pl.fy[c] < 1 || pl.fx[c] < 1)
            return (int)cudaErrorInvalidValue;
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
    const bool shift = t.kind == kInterleaved && t.ncomp == 3 && t.nch == 3
                       && t.unit == 3 && aligned && pl.fy[0] == 1
                       && pl.fx[0] == 1 && pl.fy[2] == sy && pl.fx[2] == sx
                       && (sy == 1 || sy == 2) && (sx == 1 || sx == 2);
    if (!shift) {
        if (t.kind == kUyvy && (W & 1)) return (int)cudaErrorInvalidValue;
        const int cols = t.kind == kUyvy ? W / 2 : W;
        const dim3 ggrid((cols + kThreads - 1) / kThreads,
                         (unsigned)std::min(H, 65535));
        if (t.kind == kInterleaved)
            post_generic<kInterleaved><<<ggrid, kThreads, 0, st>>>(
                pl, t, H, W, p, o);
        else if (t.kind == kUyvy)
            post_generic<kUyvy><<<ggrid, kThreads, 0, st>>>(pl, t, H, W, p,
                                                            o);
        else
            post_generic<kPlanar><<<ggrid, kThreads, 0, st>>>(pl, t, H, W,
                                                              p, o);
        return (int)cudaGetLastError();
    }
    if (sy == 1 && sx == 1)
        post_rgb_shift<0, 0><<<grid, block, 0, st>>>(pl, H, W, p, o);
    else if (sy == 1)
        post_rgb_shift<0, 1><<<grid, block, 0, st>>>(pl, H, W, p, o);
    else if (sx == 1)
        post_rgb_shift<1, 0><<<grid, block, 0, st>>>(pl, H, W, p, o);
    else
        post_rgb_shift<1, 1><<<grid, block, 0, st>>>(pl, H, W, p, o);
    return (int)cudaGetLastError();
}
