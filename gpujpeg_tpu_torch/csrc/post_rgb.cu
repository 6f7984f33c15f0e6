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
// output takes a vector instance where its layout allows (post_packed,
// post_planar; one for each output kind and chroma column repeat fx in
// {1, 2, 4}): 1, 3 or 4 planes, plane 0 (and a 4th) at (1, 1), planes 1
// and 2 at (fy, fx) with fy in {1, 2, 4}, every plane's address and
// width multiples of 8, then
//   - interleaved pixels of 1, 3 or 4 bytes (U8, RGB where the instance
//     above does not apply, RGBA) whose rows hold whole 16-byte vectors,
//     or UYVY at W % 8 == 0: a thread makes 16 pixels of a row from 16
//     bytes of each full-resolution plane and 16 / fx of each chroma row
//     (16-byte loads where a plane's rows start on 16-byte boundaries,
//     else 8-byte ones), converts each pixel once and stores its 16 U
//     bytes (32 for UYVY, u and v from the even pixels) as 16-byte
//     vectors; the group that holds W stores a byte (UYVY: a word) at a
//     time;
//   - planar P444, P422, P420 whose planes start and end on 16-byte
//     multiples: a thread makes 16 pixels of a row as above, stores plane
//     0's 16 samples and, on the rows planes 1 and 2 keep, their 16 or 8
//     samples each; with a colour transform only the pixels those planes
//     keep compute all three components, the rest component 0 alone
//     (without one the input bytes go through).  Each input byte is read
//     once.  A first design gave each thread 16 samples of one output
//     plane: its chroma planes re-read luma, and even without a transform
//     it moved bytes at about half the rate of the interleaved instances
//     (8K P420 with the transform: 0.126-0.129 ms, 4.2-4.4x its bound).
// Each division is a compile-time shift (fy a runtime shift of the row)
// and the components a constant set, a missing chroma plane reading as
// 128 and a missing 4th as 255.  The rest takes one generic instance a
// store kind, a pixel a thread (a pair for UYVY) with a row's pixels on
// consecutive threads, byte loads, a 4-byte store for RGBA and UYVY, byte
// stores otherwise, factors as shifts where they are powers of two, after
// ops/sample.postprocess: one component is filled to three with 128
// unless the output is U8; the first three channels of three or more are
// converted, a 4th goes through raw; then
//   - interleaved (U8, RGB, RGBA, at unit bytes a pixel): byte k of a
//     pixel is channel k, or 255 (alpha) past the channels;
//   - UYVY: u y0 v y1 a pixel pair, u and v from its first pixel;
//   - planar: sample (y, x) of plane i is channel i of pixel (y dh_i,
//     x dw_i), libyuv plane sizes (sample.pack_channels).
// It was the only instance of those outputs before the vector ones, a
// pixel a thread that converted every pixel even for the planes that
// drop it: 3.0-9.4x the bounds below.
// Bounds at 8K (33.2 Mpx, 3.35 TB/s): to RGBA 0.0693 ms from 4:4:4 planes
// and 0.0545 ms from 4:2:0, 0.0792 ms from 4 planes, to U8 0.0198 ms,
// 4:2:0 to P420 planar 0.0297 ms, 4:2:2 to UYVY 0.0396 ms.  A converting
// output carries ~25 integer operations a transformed pixel, which sets
// the time where few bytes come with each pixel (planar 4:2:0).
// The wrapper (ops/prepost_kernel.post_instance) picks the instance and
// passes its id; this entry checks the instance's conditions and refuses
// a launch that breaks them.
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

// ---- vector instances of the other outputs -------------------------------
// (the wrapper's VECTOR_KINDS, in this order): interleaved pixels of
// 1, 3 or 4 bytes (U8, P444_U8_P012, P4444_U8_P0123), UYVY, three planes
// with chroma at a column step of 1 (P444) or 2 (P422, P420)
enum VecTarget {
    kOutU8 = 0, kOutRgb = 1, kOutRgba = 2, kOutUyvy = 3, kOutPlanar = 4,
    kOutPlanarHalf = 5, kVecTargets = 6
};
constexpr int kVecSteps = 3;         // chroma column repeats 1, 2, 4

struct VecPlanes {
    const uint8_t* p[4];
    int stride[4];       // data_w of each plane
    int ncomp, nch;      // planes; channels before packing
    int sy;              // log2 of planes 1 and 2's row repeat
    unsigned v16;        // bit c: plane c's rows start 16-byte aligned
};

template <int N>
__device__ __forceinline__ int byte_in(const uint32_t (&v)[N], int i) {
    return (int)((v[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

// NB bytes of a plane row from column x (x a multiple of min(NB, 16)),
// limit the row's width (a multiple of 8): 16-byte loads when the plane's
// rows start 16-byte aligned (v16) and the bytes lie inside the row, else
// 8-byte loads, each only inside the row (0 past it); 4 bytes as one word
template <int NB>
__device__ __forceinline__ void load_row(const uint8_t* row, int x, int limit,
                                         bool v16,
                                         uint32_t (&v)[NB / 4]) {
    if constexpr (NB == 4) {
        v[0] = __ldg(reinterpret_cast<const uint32_t*>(row + x));
    } else {
        if (NB >= 16 && v16 && x + NB <= limit) {
#pragma unroll
            for (int q = 0; q < NB / 16; ++q) {
                const uint4 t = __ldg(reinterpret_cast<const uint4*>(
                    row + x) + q);
                v[4 * q] = t.x;
                v[4 * q + 1] = t.y;
                v[4 * q + 2] = t.z;
                v[4 * q + 3] = t.w;
            }
            return;
        }
#pragma unroll
        for (int g = 0; g < NB / 8; ++g) {
            uint2 t = make_uint2(0u, 0u);
            if (x + 8 * g < limit)
                t = __ldg(reinterpret_cast<const uint2*>(row + x) + g);
            v[2 * g] = t.x;
            v[2 * g + 1] = t.y;
        }
    }
}

// N words to p, aligned to 4 N bytes (N = 2 or 4)
template <int N>
__device__ __forceinline__ void store_words(uint8_t* p,
                                            const uint32_t (&v)[N]) {
    if constexpr (N == 2)
        *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
    else
        *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

template <int N>
__device__ __forceinline__ void fill_words(uint32_t (&v)[N], uint32_t w) {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = w;
}

// Interleaved and UYVY output from planes 0 (and a 4th) at (1, 1) and
// planes 1 and 2 at (1 << SX, 1 << sy): a thread makes 16 pixels of a row,
// x0 .. x0 + 15.  It loads 16 bytes of each full-resolution plane's row
// and 16 >> SX of each chroma row (a missing plane reads as 128, a missing
// 4th as 255), converts each pixel once, and stores the row's 16 U bytes
// (U8 1, RGB 3, RGBA 4; UYVY 32 bytes a group, u and v from the even
// pixels) as 16-byte vectors; the group that holds W stores its pixels a
// byte (UYVY: a word) at a time.  A block spans rows x groups.
template <int OUT, int SX>
__global__ void __launch_bounds__(kThreads)
post_packed(VecPlanes pl, int H, int W, gj::ColorParams p,
            uint8_t* __restrict__ out) {
    constexpr int U = OUT == kOutU8 ? 1 : OUT == kOutRgb ? 3
                      : OUT == kOutRgba ? 4 : 2;
    constexpr int CB = kGroup >> SX;     // chroma bytes a group
    const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kGroup;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x0 >= W || y >= H) return;
    const int n = min(kGroup, W - x0);
    uint32_t l[4], c1[CB / 4], c2[CB / 4], a[4];
    load_row<16>(pl.p[0] + (int64_t)y * pl.stride[0], x0, pl.stride[0],
                 pl.v16 & 1u, l);
    if (pl.ncomp >= 3) {
        const int64_t yc = y >> pl.sy;
        load_row<CB>(pl.p[1] + yc * pl.stride[1], x0 >> SX, pl.stride[1],
                     pl.v16 & 2u, c1);
        load_row<CB>(pl.p[2] + yc * pl.stride[2], x0 >> SX, pl.stride[2],
                     pl.v16 & 2u, c2);
    } else {
        fill_words(c1, 0x80808080u);
        fill_words(c2, 0x80808080u);
    }
    if (pl.ncomp == 4)
        load_row<16>(pl.p[3] + (int64_t)y * pl.stride[3], x0, pl.stride[3],
                     pl.v16 & 8u, a);
    else
        fill_words(a, 0xFFFFFFFFu);
    const bool conv = pl.nch >= 3 && (p.use_from || p.use_to);
    constexpr int OW = 4 * U;            // words of the group's output
    uint32_t o[OW];
    fill_words(o, 0u);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
        int v0 = byte_in(l, i), v1 = byte_in(c1, i >> SX),
            v2 = byte_in(c2, i >> SX);
        const int v3 = byte_in(a, i);
        if (conv) gj::convert(p, v0, v1, v2);
        if constexpr (OUT == kOutUyvy) {
            // u y0 v y1: the pair's u and v from its even pixel
            const int w = i >> 1;
            if ((i & 1) == 0)
                o[w] |= (uint32_t)v1 | (uint32_t)v0 << 8
                        | (uint32_t)v2 << 16;
            else
                o[w] |= (uint32_t)v0 << 24;
        } else {
            const int vals[4] = {v0, v1, v2, v3};
#pragma unroll
            for (int k = 0; k < U; ++k) {
                const int b = U * i + k;
                o[b >> 2] |= (uint32_t)vals[k] << (8 * (b & 3));
            }
        }
    }
    uint8_t* px = out + ((int64_t)y * W + x0) * U;
    if (n == kGroup) {
#pragma unroll
        for (int q = 0; q < OW / 4; ++q)
            reinterpret_cast<uint4*>(px)[q] =
                make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2],
                           o[4 * q + 3]);
    } else if constexpr (OUT == kOutUyvy) {
#pragma unroll
        for (int w = 0; w < OW; ++w)
            if (2 * w < n) reinterpret_cast<uint32_t*>(px)[w] = o[w];
    } else {
#pragma unroll
        for (int b = 0; b < 4 * OW; ++b)
            if (b < U * n) px[b] = (uint8_t)(o[b >> 2] >> (8 * (b & 3)));
    }
}

// component K of the colour transform of (c0, c1, c2) (gj::convert):
// without a "to" step only row K of the "from" step is computed
template <int K>
__device__ __forceinline__ int convert_one(const gj::ColorParams& p, int c0,
                                           int c1, int c2) {
    if (p.use_to || !p.use_from) {
        gj::convert(p, c0, c1, c2);
        return K == 0 ? c0 : K == 1 ? c1 : c2;
    }
    const int r0 = gj::scale_255_to_256(c0 - p.from_b[0]);
    const int r1 = gj::scale_255_to_256(c1 - p.from_b[1]);
    const int r2 = gj::scale_255_to_256(c2 - p.from_b[2]);
    return gj::clamp255((r0 * p.from_m[3 * K] + r1 * p.from_m[3 * K + 1]
                         + r2 * p.from_m[3 * K + 2] + 128) >> 8);
}

struct PlanarOut {
    int64_t off[3];      // first byte of each output plane
    int w[3];            // output planes' widths
    int dhs;             // log2 of planes 1 and 2's row step
};

// the 16 pixels of a group -> plane 0's 16 samples and, on a row that
// planes 1 and 2 keep (CHROMA), their 16 >> DWS samples: without a colour
// transform the samples are the input planes' bytes; with one, a pixel
// computes only its component 0 (convert_one) unless planes 1 and 2 keep
// it, and then all three
template <int DWS, int SX, bool CHROMA>
__device__ __forceinline__ void planar_group(
        const uint32_t (&l)[4], const uint32_t (&c1)[(kGroup >> SX) / 4],
        const uint32_t (&c2)[(kGroup >> SX) / 4], bool conv,
        const gj::ColorParams& p, uint32_t (&o0)[4],
        uint32_t (&o1)[(kGroup >> DWS) / 4],
        uint32_t (&o2)[(kGroup >> DWS) / 4]) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
        int v0 = byte_in(l, i), v1 = byte_in(c1, i >> SX),
            v2 = byte_in(c2, i >> SX);
        const bool kept = CHROMA && (i & ((1 << DWS) - 1)) == 0;
        if (conv) {
            if (kept)
                gj::convert(p, v0, v1, v2);
            else
                v0 = convert_one<0>(p, v0, v1, v2);
        }
        o0[i >> 2] |= (uint32_t)v0 << (8 * (i & 3));
        if (kept) {
            const int j = i >> DWS;
            o1[j >> 2] |= (uint32_t)v1 << (8 * (j & 3));
            o2[j >> 2] |= (uint32_t)v2 << (8 * (j & 3));
        }
    }
}

// Planar output (P444, P422, P420) from planes 0 at (1, 1) and 1, 2 at
// (1 << SX, 1 << sy), the output's planes 1 and 2 at a column step of
// 1 << DWS and a row step of 1 << dhs: a thread makes 16 pixels x0 ..
// x0 + 15 of image row y, as post_packed does, and stores plane 0's 16
// samples as one vector and, on the rows planes 1 and 2 keep, their
// 16 >> DWS samples each; only the pixels those planes keep convert all
// three components, the rest only component 0.  Each input byte is read
// once and each output byte written once.  A block spans rows x groups.
template <int DWS, int SX>
__global__ void __launch_bounds__(kThreads)
post_planar(VecPlanes pl, PlanarOut t, int H, int W, gj::ColorParams p,
            uint8_t* __restrict__ out) {
    constexpr int CB = kGroup >> SX;     // chroma bytes read a group
    constexpr int OC = kGroup >> DWS;    // chroma samples stored a group
    const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kGroup;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x0 >= W || y >= H) return;
    const int yk = y >> t.dhs;
    const bool crow = (yk << t.dhs) == y;
    const bool conv = pl.nch >= 3 && (p.use_from || p.use_to);
    uint32_t l[4], c1[CB / 4], c2[CB / 4];
    load_row<16>(pl.p[0] + (int64_t)y * pl.stride[0], x0, pl.stride[0],
                 pl.v16 & 1u, l);
    if (pl.ncomp >= 3 && (conv || crow)) {
        const int64_t yc = y >> pl.sy;
        load_row<CB>(pl.p[1] + yc * pl.stride[1], x0 >> SX, pl.stride[1],
                     pl.v16 & 2u, c1);
        load_row<CB>(pl.p[2] + yc * pl.stride[2], x0 >> SX, pl.stride[2],
                     pl.v16 & 2u, c2);
    } else {
        fill_words(c1, 0x80808080u);
        fill_words(c2, 0x80808080u);
    }
    uint32_t o0[4] = {0u, 0u, 0u, 0u}, o1[OC / 4], o2[OC / 4];
    fill_words(o1, 0u);
    fill_words(o2, 0u);
    if (crow)
        planar_group<DWS, SX, true>(l, c1, c2, conv, p, o0, o1, o2);
    else
        planar_group<DWS, SX, false>(l, c1, c2, conv, p, o0, o1, o2);
    store_words(out + t.off[0] + (int64_t)y * t.w[0] + x0, o0);
    if (crow) {
        const int64_t xo = x0 >> DWS;
        store_words(out + t.off[1] + (int64_t)yk * t.w[1] + xo, o1);
        store_words(out + t.off[2] + (int64_t)yk * t.w[2] + xo, o2);
    }
}

using PackedKernel = void (*)(VecPlanes, int, int, gj::ColorParams,
                              uint8_t*);
using PlanarKernel = void (*)(VecPlanes, PlanarOut, int, int,
                              gj::ColorParams, uint8_t*);

#define GJ_POST_STEPS(K, T) {K<T, 0>, K<T, 1>, K<T, 2>}
// instance 2 + kVecSteps * target + log2(chroma column repeat)
const PackedKernel kPostPacked[4][kVecSteps] = {
    GJ_POST_STEPS(post_packed, kOutU8), GJ_POST_STEPS(post_packed, kOutRgb),
    GJ_POST_STEPS(post_packed, kOutRgba),
    GJ_POST_STEPS(post_packed, kOutUyvy)};
const PlanarKernel kPostPlanar[2][kVecSteps] = {
    GJ_POST_STEPS(post_planar, 0), GJ_POST_STEPS(post_planar, 1)};
#undef GJ_POST_STEPS

// log2 of a step in {1, 2, 4}, else -1
int step_shift(int d) {
    return d == 1 ? 0 : d == 2 ? 1 : d == 4 ? 2 : -1;
}

bool aligned(const void* ptr, int bytes) {
    return ((uintptr_t)ptr & (uintptr_t)(bytes - 1)) == 0;
}

}  // namespace

extern "C" int gj_post_rgb(const void* p0, const void* p1, const void* p2,
                           const void* p3, const int* geo, int H, int W,
                           const int64_t* dst, const int* params, void* out,
                           int inst, void* stream) {
    // p_c: (data_h_c, data_w_c) u8 planes (null past the last component);
    // geo: host int32[16] = components, store kind, unit, channels, then
    // data_w_c[4], fy_c[4], fx_c[4]; dst: host int64[16], for a planar
    // output each plane's first byte, width, row step and column step
    // (ops/prepost_kernel.post_target); params: host int32[26]
    // (ops/color.kernel_params); out: the raw image, 16-byte aligned;
    // inst: the instance (ops/prepost_kernel.post_instance): 0 generic, 1
    // the RGB instance, 2 + 3 target + log2(chroma fx) a vector instance;
    // this entry checks its conditions and refuses a launch that breaks
    // them
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
    bool aligned8 = true;
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
        aligned8 = aligned8 && aligned(pl.p[c], 8) && pl.stride[c] % 8 == 0;
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
    if (inst == 0) {
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
    if (inst == 1) {
        const int sy = pl.fy[1], sx = pl.fx[1];
        if (!(t.kind == kInterleaved && t.ncomp == 3 && t.nch == 3
              && t.unit == 3 && aligned8 && pl.fy[0] == 1 && pl.fx[0] == 1
              && pl.fy[2] == sy && pl.fx[2] == sx && (sy == 1 || sy == 2)
              && (sx == 1 || sx == 2)))
            return (int)cudaErrorInvalidValue;
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
    // a vector instance: the planes' layout, then the output's kind and
    // alignment (ops/prepost_kernel.post_instance checks the same)
    const int target = (inst - 2) / kVecSteps, sxl = (inst - 2) % kVecSteps;
    VecPlanes vp;
    vp.ncomp = t.ncomp;
    vp.nch = t.nch;
    vp.sy = t.ncomp >= 3 ? step_shift(pl.fy[1]) : 0;
    vp.v16 = 0;
    bool ok = target < kVecTargets && aligned8 && aligned(out, 16)
              && t.ncomp != 2 && pl.fy[0] == 1 && pl.fx[0] == 1
              && vp.sy >= 0
              && (t.ncomp >= 3 ? pl.fx[1] == (1 << sxl) : sxl == 0)
              && (t.ncomp < 3 || (pl.fy[2] == pl.fy[1]
                                  && pl.fx[2] == pl.fx[1]
                                  && pl.stride[2] == pl.stride[1]))
              && (t.ncomp < 4 || (pl.fy[3] == 1 && pl.fx[3] == 1));
    for (int c = 0; c < 4; ++c) {
        vp.p[c] = pl.p[c];
        vp.stride[c] = pl.stride[c];
        if (c < t.ncomp && pl.stride[c] % 16 == 0 && aligned(pl.p[c], 16))
            vp.v16 |= 1u << c;
    }
    // bit 1: planes 1 and 2 (one chroma row layout)
    if (t.ncomp >= 3 && !(vp.v16 & 4u)) vp.v16 &= ~2u;
    if (target < kOutPlanar) {
        const int units[4] = {1, 3, 4, 2};
        const int kinds[4] = {kInterleaved, kInterleaved, kInterleaved,
                              kUyvy};
        ok = ok && t.kind == kinds[target]
             && (target == kOutUyvy || t.unit == units[target])
             && (int64_t)W * units[target] % 16 == 0;
        if (!ok) return (int)cudaErrorInvalidValue;
        kPostPacked[target][sxl]<<<grid, block, 0, st>>>(vp, H, W, p, o);
        return (int)cudaGetLastError();
    }
    // planar: plane 0 the image, planes 1 and 2 at one (dw, dh), every
    // plane's first byte and width a multiple of 16
    const int dws = target == kOutPlanarHalf ? 1 : 0;
    PlanarOut po;
    po.dhs = step_shift((int)dst[7]);
    ok = ok && t.kind == kPlanar && dst[6] == 1 && dst[9] == 1
         && dst[10] == (1 << dws) && dst[11] == dst[10] && dst[8] == dst[7]
         && (po.dhs == 0 || po.dhs == 1);
    for (int k = 0; k < 3; ++k) {
        po.off[k] = t.off[k];
        po.w[k] = t.pw[k];
        ok = ok && po.off[k] % 16 == 0 && po.w[k] % 16 == 0
             && po.w[k] == (k == 0 ? W : (W + (1 << dws) - 1) >> dws);
    }
    if (!ok) return (int)cudaErrorInvalidValue;
    kPostPlanar[dws][sxl]<<<grid, block, 0, st>>>(vp, po, H, W, p, o);
    return (int)cudaGetLastError();
}
