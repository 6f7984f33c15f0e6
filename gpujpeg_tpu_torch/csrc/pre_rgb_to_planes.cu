// Encode preprocessor for Hopper (sm_90a): a raw 8-bit image in any of the
// seven pixel formats -> the 1 to 4 zero-padded uint8 component planes,
// colour-transformed, each at its own decimation (dx, dy), in one launch a
// frame.
//
// Replaces the JAX package's Pallas preprocessor
// (gpujpeg_tpu/ops/prepost_kernel.py: _pre_kernel_body, launched by
// _cached_pre_kernel once per decimation group), which needed in-VMEM
// transposes and sublane bitcasts to reach packed u32 planes on a TPU.  On
// the card a plane of bytes is the same memory as those packed words read
// little-endian, so the kernel is an elementwise pass over the source
// pixels: sample (y, x) of plane c is pixel (y dy_c, x dx_c) after the
// reference's fixed-point transform (gpujpeg_colorspace.h:64-101, the same
// integer matrices as ops/color.py; colorspace.cuh), or 0 where that pixel
// lies past the image (the zero padding up to the plane's data_h x
// data_w).  Decimation is pure selection, as in the reference
// (gpujpeg_preprocessor.cu:51-64), so it commutes with the transform.
//
// Bound: bytes.  An 8K 4:4:4 frame reads 99.5 MB and writes 99.5 MB,
// about 0.059 ms at 3.35 TB/s; at 4:2:0 it reads 99.5 MB and writes 49.8
// MB, about 0.045 ms.  The transform is ~30 integer operations a sample.
// The earlier design made 4 samples a thread from 12 byte loads and
// launched once per decimation group, so at 4:2:0 the chroma launch read
// the frame a second time.  So:
//   - one launch a frame covers all three planes (a thread writes every
//     plane's samples whose source pixels it covers), each plane with its
//     own (dx, dy), data height and width;
//   - the vector instance (luma at (1, 1), both chroma planes at one (dx,
//     dy) in {1, 2}^2: 4:4:4, 4:2:0, 4:2:2, 4:4:0): a thread covers dy
//     rows x 16 pixels, three 16-byte loads a row, the transform once per
//     pixel it keeps, 16-byte luma stores, 8-byte (dx = 2) or 16-byte
//     (dx = 1) chroma stores.  It needs W % 16 == 0, a 16-byte aligned
//     image, and planes whose width and address hold whole vectors;
//   - vector instances of every other input (kPrePacked, one for each
//     input kind and chroma column step dx in {1, 2, 4}): interleaved rows
//     of 1, 3 or 4 channels (U8, RGB where the vector instance above does
//     not apply, RGBA), UYVY rows, or three planes whose chroma repeats 1
//     or 2 columns (P444; P422, P420), 16-byte aligned rows; 1 to 4
//     components, plane 0 (and a 4th) at (1, 1), planes 1 and 2 at (dx,
//     dy), dy in {1, 2, 4}.  A thread makes one row's 16 pixels: 16-byte
//     loads (16 bytes a channel; planar chroma 16 or 8 a row), each
//     division a compile-time shift, the components a constant loop; the
//     transform once a pixel, only luma off a chroma row (dy > 1) and
//     all three only for the pixels a chroma plane keeps; then a 16-byte
//     store to each full-resolution plane (two 8-byte ones when a plane's
//     rows are off 16-byte boundaries) and 16 / dx bytes to each chroma
//     plane.  Pixels past W or H are 0 by a mask on the packed words, and
//     the group that holds W (rows padded to a pitch that holds whole
//     vectors) loads its pixels a byte at a time, in the same thread.
//     The 8K records' bounds (bytes, read once and written once at 3.35
//     TB/s): a U8 frame reads and writes 33.2 MB (0.0198 ms), UYVY 66.4
//     + 66.4 MB at 4:2:2 (0.0396 ms), P420 planar 49.8 + 49.8 MB (0.0297
//     ms), P444 planar 99.5 + 99.5 MB (0.0594 ms), RGBA to four planes
//     132.7 + 132.7 MB (0.0792 ms).  Converting inputs carry ~25 integer
//     operations a transformed pixel, which can set the time where few
//     bytes come with each pixel (planar 4:2:0);
//   - a generic instance (any decimation, any W, any alignment; byte loads
//     and stores, a pixel a thread with a row's pixels on consecutive
//     threads, divisions as shifts for power-of-two factors) takes the
//     rest, for each
//     input kind: sample-interleaved channels at any row pitch (U8, RGB,
//     RGBA, rows padded by width_padding bytes, or any (H, W, C) tensor),
//     UYVY (both pixels of a pair take its u and v), and three planes at
//     libyuv sizes (each upsampled nearest-neighbour to the image before
//     decimation, as sample.unpack_to_channels does).  Channels past the
//     input's are 128 (greyscale encoded as more components); components
//     0-2 of an image of 3 or 4 components are converted, a 4th and the
//     components of a 1- or 2-component image are the raw channels
//     (sample.preprocess).  It was the only instance of those inputs
//     before the vector ones, a byte a thread with per-pixel runtime
//     divisions: 3.8-13x the bounds above.
// The wrapper (ops/prepost_kernel.pre_instance) picks the instance and
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

using gj::ColorParams;
using gj::convert;

constexpr int kGroup = 16;           // source pixels a thread, along a row
constexpr int kThreads = 256;

struct Planes {
    uint8_t* p[4];
    int dx[4], dy[4];
    int h[4], w[4];      // data height and width
};

__device__ __forceinline__ int byte_at(const uint32_t (&v)[12], int i) {
    return (int)((v[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

// luma at (1, 1), both chroma planes at (1 << SX, 1 << SY)
template <int SX, int SY>
__global__ void __launch_bounds__(kThreads)
pre_vector(const uint8_t* __restrict__ raw, int H, int W, Planes pl,
           ColorParams p) {
    const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kGroup;
    const int y0 = (blockIdx.y * blockDim.y + threadIdx.y) << SY;
#pragma unroll
    for (int r = 0; r < (1 << SY); ++r) {
        const int y = y0 + r;
        const bool luma = y < pl.h[0] && x0 < pl.w[0];
        const bool chroma = r == 0 && (y >> SY) < pl.h[1]
                            && (x0 >> SX) < pl.w[1];
        if (!luma && !chroma) continue;
        uint32_t v[12];
        if (y < H && x0 < W) {
            const uint4* src = reinterpret_cast<const uint4*>(
                raw + ((int64_t)y * W + x0) * 3);
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                const uint4 t = __ldg(src + q);
                v[4 * q] = t.x;
                v[4 * q + 1] = t.y;
                v[4 * q + 2] = t.z;
                v[4 * q + 3] = t.w;
            }
        } else {
#pragma unroll
            for (int q = 0; q < 12; ++q) v[q] = 0u;
        }
        const bool pad = !(y < H && x0 < W);
        uint32_t o0[4] = {0u, 0u, 0u, 0u}, o1[4] = {0u, 0u, 0u, 0u},
                 o2[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
            int c0 = byte_at(v, 3 * i), c1 = byte_at(v, 3 * i + 1),
                c2 = byte_at(v, 3 * i + 2);
            convert(p, c0, c1, c2);
            if (pad) c0 = c1 = c2 = 0;
            o0[i >> 2] |= (uint32_t)c0 << (8 * (i & 3));
            if ((i & ((1 << SX) - 1)) == 0) {
                const int ci = i >> SX;
                o1[ci >> 2] |= (uint32_t)c1 << (8 * (ci & 3));
                o2[ci >> 2] |= (uint32_t)c2 << (8 * (ci & 3));
            }
        }
        if (luma)
            *reinterpret_cast<uint4*>(pl.p[0] + (int64_t)y * pl.w[0] + x0) =
                make_uint4(o0[0], o0[1], o0[2], o0[3]);
        if (chroma) {
            const int64_t off = (int64_t)(y >> SY) * pl.w[1] + (x0 >> SX);
            if (SX) {
                *reinterpret_cast<uint2*>(pl.p[1] + off) =
                    make_uint2(o1[0], o1[1]);
                *reinterpret_cast<uint2*>(pl.p[2] + off) =
                    make_uint2(o2[0], o2[1]);
            } else {
                *reinterpret_cast<uint4*>(pl.p[1] + off) =
                    make_uint4(o1[0], o1[1], o1[2], o1[3]);
                *reinterpret_cast<uint4*>(pl.p[2] + off) =
                    make_uint4(o2[0], o2[1], o2[2], o2[3]);
            }
        }
    }
}

// A divisor of the generic instances: a shift when it is a power of two
// (every decimation and repeat factor of the JPEG layouts), else a
// division
struct Div {
    int d, s;            // s >= 0: d == 1 << s
};

__device__ __forceinline__ int divide(int x, Div q) {
    return q.s >= 0 ? x >> q.s : x / q.d;
}

// The input's kinds (the wrapper's pre_source): sample-interleaved
// channels (U8, P444_U8_P012, P4444_U8_P0123, or any (H, W, C) tensor),
// UYVY, three planes at libyuv sizes.
enum Kind { kInterleaved = 0, kUyvy = 1, kPlanar = 2 };

struct Source {
    int nin;             // channels of an interleaved input
    int64_t pitch;       // bytes a row (packed kinds)
    int64_t off[3];      // planar: first byte of each plane
    int pw[3];           // planar: plane widths
    Div fy[3], fx[3];    // planar: repeat factors up to the image
};

// the planes' decimations as divisors
struct Steps {
    Div dx[4], dy[4];
};

// the channels of source pixel (y, x): v[k] = 128 past the input's
// channels (sample.preprocess's fill for greyscale encoded as more
// components)
template <int KIND>
__device__ __forceinline__ void fetch(const uint8_t* __restrict__ raw,
                                      const Source& s, int y, int x,
                                      int (&v)[4]) {
    if (KIND == kInterleaved) {
        const uint8_t* q = raw + y * s.pitch + (int64_t)x * s.nin;
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = k < s.nin ? q[k] : 128;
    } else if (KIND == kUyvy) {
        // u y0 v y1 for each pixel pair; both pixels take its u and v
        const uint8_t* q = raw + y * s.pitch + (int64_t)(x >> 1) * 4;
        v[0] = q[1 + 2 * (x & 1)];
        v[1] = q[0];
        v[2] = q[2];
        v[3] = 128;
    } else {
        // nearest-neighbour upsampling of each plane (sample._upsample_to)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            v[k] = raw[s.off[k] + (int64_t)divide(y, s.fy[k]) * s.pw[k]
                       + divide(x, s.fx[k])];
        v[3] = 128;
    }
}

// any input kind, 1 to 4 components, any decimation per plane, any W, any
// alignment: a source pixel a thread, the pixels of a row on consecutive
// threads (so a warp's loads and stores are consecutive bytes), a grid
// row a source row; the pixel is fetched and converted once when some
// plane keeps it (components 0-2 of an image of 3 or more components;
// otherwise the channels go through raw)
template <int KIND>
__global__ void __launch_bounds__(kThreads)
pre_generic(const uint8_t* __restrict__ raw, int H, int W, Source s,
            int ncomp, int rows, Planes pl, Steps st, ColorParams p) {
    const int x = blockIdx.x * kThreads + threadIdx.x;
    for (int y = blockIdx.y; y < rows; y += gridDim.y) {
        bool keep[4];
        int64_t off[4];
        bool need = false;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            keep[c] = false;
            off[c] = 0;
            if (c < ncomp) {
                const int yc = divide(y, st.dy[c]);
                const int xc = divide(x, st.dx[c]);
                keep[c] = yc * st.dy[c].d == y && xc * st.dx[c].d == x
                          && yc < pl.h[c] && xc < pl.w[c];
                off[c] = (int64_t)yc * pl.w[c] + xc;
                need = need || keep[c];
            }
        }
        if (!need) continue;
        int v[4] = {0, 0, 0, 0};
        if (y < H && x < W) {
            fetch<KIND>(raw, s, y, x, v);
            if (ncomp >= 3) convert(p, v[0], v[1], v[2]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
            if (keep[c]) pl.p[c][off[c]] = (uint8_t)v[c];
    }
}

// ---- vector instances of the other inputs ---------------------------------
// (the wrapper's VECTOR_KINDS, in this order): interleaved U8, RGB and
// RGBA rows, UYVY rows, three planes with chroma at a column repeat of 1 or
// 2 (P444, P422 / P420)
enum VecSource {
    kVecU8 = 0, kVecRgb = 1, kVecRgba = 2, kVecUyvy = 3, kVecPlanar = 4,
    kVecPlanarHalf = 5, kVecSources = 6
};
constexpr int kVecSteps = 3;         // chroma column steps 1, 2, 4

struct VecIn {
    int64_t pitch;       // interleaved, UYVY: bytes a row
    int64_t off[3];      // planar: first byte of each plane
    int pw[3];           // planar: plane widths (row pitches)
    int fys;             // planar: log2 of the chroma planes' row repeat
};

template <int N>
__device__ __forceinline__ int byte_in(const uint32_t (&v)[N], int i) {
    return (int)((v[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

// N words from p, aligned to 4 N bytes (N = 1, 2 or a multiple of 4)
template <int N>
__device__ __forceinline__ void load_words(const uint8_t* p,
                                           uint32_t (&v)[N]) {
    if constexpr (N == 1) {
        v[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    } else if constexpr (N == 2) {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
        v[0] = t.x;
        v[1] = t.y;
    } else {
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
            const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + q);
            v[4 * q] = t.x;
            v[4 * q + 1] = t.y;
            v[4 * q + 2] = t.z;
            v[4 * q + 3] = t.w;
        }
    }
}

// the first n bytes of p one at a time, the rest 0 (the ragged tail)
template <int N>
__device__ __forceinline__ void load_tail(const uint8_t* p, int n,
                                          uint32_t (&v)[N]) {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = 0u;
#pragma unroll
    for (int b = 0; b < 4 * N; ++b)
        if (b < n) v[b >> 2] |= (uint32_t)__ldg(p + b) << (8 * (b & 3));
}

template <int N>
__device__ __forceinline__ void store_words(uint8_t* p,
                                            const uint32_t (&v)[N]) {
    if constexpr (N == 1) {
        *reinterpret_cast<uint32_t*>(p) = v[0];
    } else if constexpr (N == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
    } else {
        *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
    }
}

// 16 samples at column x of a plane row w bytes wide (w a multiple of 8):
// one 16-byte store when the plane's rows start 16-byte aligned (v16),
// else two 8-byte stores, the second only inside the row
__device__ __forceinline__ void store16(uint8_t* row, int x, int w, bool v16,
                                        const uint32_t (&o)[4]) {
    if (v16) {
        store_words(row + x, o);
        return;
    }
    *reinterpret_cast<uint2*>(row + x) = make_uint2(o[0], o[1]);
    if (x + 8 < w)
        *reinterpret_cast<uint2*>(row + x + 8) = make_uint2(o[2], o[3]);
}

// word q of the mask that keeps the first n bytes
__device__ __forceinline__ uint32_t keep_mask(int n, int q) {
    const int m = n - 4 * q;
    return m >= 4 ? 0xFFFFFFFFu : m <= 0 ? 0u : (1u << (8 * m)) - 1u;
}

// channels 0-3 of pixel i of a group: interleaved channels past the
// input's are 128, UYVY pixels take their pair's u and v, planar chroma
// sample i >> PFX of the loaded chroma bytes
template <int SRC, int RW, int PW>
__device__ __forceinline__ void group_pixel(const uint32_t (&r)[RW],
                                            const uint32_t (&a)[PW],
                                            const uint32_t (&b)[PW], int i,
                                            int& c0, int& c1, int& c2,
                                            int& c3) {
    constexpr int NIN = SRC == kVecU8 ? 1 : SRC == kVecRgb ? 3 : 4;
    c3 = 128;
    if constexpr (SRC == kVecUyvy) {
        const int pair = 4 * (i >> 1);
        c0 = byte_in(r, pair + 1 + 2 * (i & 1));
        c1 = byte_in(r, pair);
        c2 = byte_in(r, pair + 2);
    } else if constexpr (SRC == kVecPlanar || SRC == kVecPlanarHalf) {
        constexpr int PFX = SRC == kVecPlanarHalf ? 1 : 0;
        c0 = byte_in(r, i);
        c1 = byte_in(a, i >> PFX);
        c2 = byte_in(b, i >> PFX);
    } else {
        c0 = byte_in(r, NIN * i);
        c1 = c2 = 128;
        if constexpr (NIN >= 3) {
            c1 = byte_in(r, NIN * i + 1);
            c2 = byte_in(r, NIN * i + 2);
        }
        if constexpr (NIN == 4) c3 = byte_in(r, NIN * i + 3);
    }
}

// the 16 pixels of a group -> luma / 4th-plane words (a byte a pixel) and,
// on a chroma row (CHROMA), the chroma words (a byte every 1 << SX
// pixels); off a chroma row only luma is converted, and only the pixels a
// chroma plane keeps convert all three
template <int SRC, int SX, bool CHROMA, int RW, int PW, int CW>
__device__ __forceinline__ void convert_group(
        const uint32_t (&r)[RW], const uint32_t (&a)[PW],
        const uint32_t (&b)[PW], bool conv, const ColorParams& p,
        uint32_t (&o0)[4], uint32_t (&o1)[CW], uint32_t (&o2)[CW],
        uint32_t (&o3)[4]) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
        int c0, c1, c2, c3;
        group_pixel<SRC>(r, a, b, i, c0, c1, c2, c3);
        if (conv) convert(p, c0, c1, c2);
        o0[i >> 2] |= (uint32_t)c0 << (8 * (i & 3));
        o3[i >> 2] |= (uint32_t)c3 << (8 * (i & 3));
        if (CHROMA && (i & ((1 << SX) - 1)) == 0) {
            const int j = i >> SX;
            o1[j >> 2] |= (uint32_t)c1 << (8 * (j & 3));
            o2[j >> 2] |= (uint32_t)c2 << (8 * (j & 3));
        }
    }
}

// Input kind SRC, 1 to 4 components: plane 0 (and a 4th) at (1, 1), planes
// 1 and 2 at (1 << SX, 1 << sy).  A thread makes one source row's 16
// pixels x0 .. x0 + 15: 16 bytes a channel loaded as 16-byte vectors
// (interleaved and UYVY rows: 16 x channels bytes; planar: 16 luma bytes
// and 16 >> PFX of each chroma row), the transform once a pixel, then 16
// bytes of each full-resolution plane and 16 >> SX of each chroma plane
// stored as one vector, chroma only on rows y % (1 << sy) == 0.  Pixels
// past W or H are 0 (a mask on the packed words); the group that holds W
// loads its pixels a byte at a time.  A block spans rows x groups.
template <int SRC, int SX>
__global__ void __launch_bounds__(kThreads)
pre_packed(const uint8_t* __restrict__ raw, int H, int W, VecIn in,
           int ncomp, int rows, int cols, Planes pl, int sy, unsigned v16,
           ColorParams p) {
    constexpr bool PLANAR = SRC == kVecPlanar || SRC == kVecPlanarHalf;
    constexpr int PFX = SRC == kVecPlanarHalf ? 1 : 0;
    constexpr int BPP = SRC == kVecU8 ? 1 : SRC == kVecRgb ? 3
                        : SRC == kVecRgba ? 4 : SRC == kVecUyvy ? 2 : 1;
    constexpr int RW = 4 * BPP;              // words of a row's 16 pixels
    constexpr int PW = PLANAR ? (kGroup >> PFX) / 4 : 1;
    constexpr int CW = (kGroup >> SX) / 4;   // words of a chroma group
    const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kGroup;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x0 >= cols || y >= rows) return;
    const int yc = y >> sy;
    const bool luma = y < pl.h[0] && x0 < pl.w[0];
    const bool chroma = ncomp >= 2 && (yc << sy) == y && yc < pl.h[1]
                        && (x0 >> SX) < pl.w[1];
    const bool fourth = ncomp == 4 && y < pl.h[3] && x0 < pl.w[3];
    if (!luma && !chroma && !fourth) return;
    const int n = y < H ? max(0, min(kGroup, W - x0)) : 0;
    uint32_t r[RW], a[PW], b[PW];
#pragma unroll
    for (int q = 0; q < PW; ++q) a[q] = b[q] = 0u;
    if (n == kGroup) {
        if constexpr (PLANAR) {
            load_words(raw + in.off[0] + (int64_t)y * in.pw[0] + x0, r);
            const int64_t yy = y >> in.fys;
            load_words(raw + in.off[1] + yy * in.pw[1] + (x0 >> PFX), a);
            load_words(raw + in.off[2] + yy * in.pw[2] + (x0 >> PFX), b);
        } else {
            load_words(raw + (int64_t)y * in.pitch + (int64_t)x0 * BPP, r);
        }
    } else if (!PLANAR && n > 0) {
        load_tail(raw + (int64_t)y * in.pitch + (int64_t)x0 * BPP, n * BPP,
                  r);
    } else {
#pragma unroll
        for (int q = 0; q < RW; ++q) r[q] = 0u;
    }
    const bool conv = ncomp >= 3 && (p.use_from || p.use_to);
    uint32_t o0[4] = {0u, 0u, 0u, 0u}, o3[4] = {0u, 0u, 0u, 0u}, o1[CW],
             o2[CW];
#pragma unroll
    for (int q = 0; q < CW; ++q) o1[q] = o2[q] = 0u;
    if (chroma)
        convert_group<SRC, SX, true>(r, a, b, conv, p, o0, o1, o2, o3);
    else
        convert_group<SRC, SX, false>(r, a, b, conv, p, o0, o1, o2, o3);
    if (n < kGroup) {
        const int nc = (n + (1 << SX) - 1) >> SX;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            o0[q] &= keep_mask(n, q);
            o3[q] &= keep_mask(n, q);
        }
#pragma unroll
        for (int q = 0; q < CW; ++q) {
            o1[q] &= keep_mask(nc, q);
            o2[q] &= keep_mask(nc, q);
        }
    }
    if (luma)
        store16(pl.p[0] + (int64_t)y * pl.w[0], x0, pl.w[0], v16 & 1u, o0);
    if (fourth)
        store16(pl.p[3] + (int64_t)y * pl.w[3], x0, pl.w[3], v16 & 8u, o3);
    if (chroma) {
        const int64_t row = (int64_t)yc * pl.w[1];
        if constexpr (SX == 0) {
            store16(pl.p[1] + row, x0, pl.w[1], v16 & 2u, o1);
            if (ncomp >= 3)
                store16(pl.p[2] + row, x0, pl.w[1], v16 & 2u, o2);
        } else {
            store_words(pl.p[1] + row + (x0 >> SX), o1);
            if (ncomp >= 3) store_words(pl.p[2] + row + (x0 >> SX), o2);
        }
    }
}

using PreKernel = void (*)(const uint8_t*, int, int, VecIn, int, int, int,
                           Planes, int, unsigned, ColorParams);

#define GJ_PRE_STEPS(S) \
    {pre_packed<S, 0>, pre_packed<S, 1>, pre_packed<S, 2>}
// instance 2 + kVecSteps * source + log2(chroma column step)
const PreKernel kPrePacked[kVecSources][kVecSteps] = {
    GJ_PRE_STEPS(kVecU8), GJ_PRE_STEPS(kVecRgb), GJ_PRE_STEPS(kVecRgba),
    GJ_PRE_STEPS(kVecUyvy), GJ_PRE_STEPS(kVecPlanar),
    GJ_PRE_STEPS(kVecPlanarHalf)};
#undef GJ_PRE_STEPS

Div divisor(int d) {
    Div q{d, -1};
    if (d > 0 && (d & (d - 1)) == 0)
        for (q.s = 0; (1 << q.s) < d; ++q.s) {}
    return q;
}

bool aligned(const void* ptr, int bytes) {
    return ((uintptr_t)ptr & (uintptr_t)(bytes - 1)) == 0;
}

// log2 of a step in {1, 2, 4}, else -1
int step_shift(int64_t d) {
    return d == 1 ? 0 : d == 2 ? 1 : d == 4 ? 2 : -1;
}

}  // namespace

extern "C" int gj_pre_rgb_to_planes(const void* raw, int H, int W,
                                    const int* geo, const int64_t* src,
                                    const int* params, void* out0,
                                    void* out1, void* out2, void* out3,
                                    int inst, void* stream) {
    // raw: the image on the card; geo: host int32[16] = (dx, dy, data_h,
    // data_w) of each plane (rows past the last component unused); src:
    // host int64[16] = kind, channels of an interleaved input, row pitch
    // in bytes, components, then for planar input each plane's first
    // byte, width, row factor and column factor (ops/prepost_kernel.
    // pre_source); out_k: (data_h_k, data_w_k) u8 plane of component k
    // (null past the last); params: int32[26] = from-matrix[9],
    // from-base[3], to-matrix[9], to-base[3], use_from, use_to
    // (ops/color.kernel_params), host memory; inst: the instance
    // (ops/prepost_kernel.pre_instance): 0 generic, 1 the RGB vector
    // instance, 2 + 3 source + log2(chroma dx) a vector instance of
    // kPrePacked; this entry checks its conditions and refuses a launch
    // that breaks them
    ColorParams p;
    static_assert(sizeof(ColorParams) == 26 * sizeof(int), "layout");
    std::memcpy(&p, params, sizeof(p));
    const int kind = (int)src[0];
    const int ncomp = (int)src[3];
    if (kind < kInterleaved || kind > kPlanar || ncomp < 1 || ncomp > 4)
        return (int)cudaErrorInvalidValue;
    Source s;
    s.nin = (int)src[1];
    s.pitch = src[2];
    for (int k = 0; k < 3; ++k) {
        s.off[k] = src[4 + k];
        s.pw[k] = (int)src[7 + k];
        s.fy[k] = divisor((int)src[10 + k]);
        s.fx[k] = divisor((int)src[13 + k]);
        if (kind == kPlanar && (src[10 + k] < 1 || src[13 + k] < 1))
            return (int)cudaErrorInvalidValue;
    }
    if (kind == kInterleaved && s.nin < 1) return (int)cudaErrorInvalidValue;
    Planes pl;
    void* outs[4] = {out0, out1, out2, out3};
    int64_t xe = 0, ye = 0;          // the planes' extent in source pixels
    for (int c = 0; c < 4; ++c) {
        pl.p[c] = (uint8_t*)outs[c];
        pl.dx[c] = geo[4 * c];
        pl.dy[c] = geo[4 * c + 1];
        pl.h[c] = geo[4 * c + 2];
        pl.w[c] = geo[4 * c + 3];
        if (c >= ncomp) {
            pl.dx[c] = pl.dy[c] = 1;
            pl.h[c] = pl.w[c] = 0;
            continue;
        }
        if (pl.dx[c] < 1 || pl.dy[c] < 1 || !pl.p[c])
            return (int)cudaErrorInvalidValue;
        xe = std::max(xe, (int64_t)pl.w[c] * pl.dx[c]);
        ye = std::max(ye, (int64_t)pl.h[c] * pl.dy[c]);
    }
    if (xe <= 0 || ye <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const uint8_t* in = (const uint8_t*)raw;
    if (inst == 0) {
        if (xe > (1 << 30) || ye > (1 << 30))
            return (int)cudaErrorInvalidValue;
        Steps steps;
        for (int c = 0; c < 4; ++c) {
            steps.dx[c] = divisor(pl.dx[c]);
            steps.dy[c] = divisor(pl.dy[c]);
        }
        const int rows = (int)ye;
        const dim3 grid((unsigned)((xe + kThreads - 1) / kThreads),
                        (unsigned)std::min(rows, 65535));
        if (kind == kInterleaved)
            pre_generic<kInterleaved><<<grid, kThreads, 0, st>>>(
                in, H, W, s, ncomp, rows, pl, steps, p);
        else if (kind == kUyvy)
            pre_generic<kUyvy><<<grid, kThreads, 0, st>>>(
                in, H, W, s, ncomp, rows, pl, steps, p);
        else
            pre_generic<kPlanar><<<grid, kThreads, 0, st>>>(
                in, H, W, s, ncomp, rows, pl, steps, p);
        return (int)cudaGetLastError();
    }
    const int groups = (int)((xe + kGroup - 1) / kGroup);
    const int bx = std::min(kThreads, (groups + 31) / 32 * 32);
    const dim3 block(bx, kThreads / bx);
    if (inst == 1) {
        const int sx = pl.dx[1], sy = pl.dy[1];
        bool ok = kind == kInterleaved && s.nin == 3 && s.pitch == 3LL * W
                  && ncomp == 3
                  && pl.dx[0] == 1 && pl.dy[0] == 1 && pl.dx[2] == sx
                  && pl.dy[2] == sy && pl.h[2] == pl.h[1]
                  && pl.w[2] == pl.w[1]
                  && (sx == 1 || sx == 2) && (sy == 1 || sy == 2)
                  && W % kGroup == 0 && xe % kGroup == 0 && ye % sy == 0
                  && aligned(raw, 16);
        for (int c = 0; c < 3; ++c) {
            const int vb = kGroup / pl.dx[c];  // bytes of a plane's vector
            ok = ok && pl.w[c] % vb == 0 && aligned(pl.p[c], vb);
        }
        if (!ok) return (int)cudaErrorInvalidValue;
        const dim3 grid((groups + bx - 1) / bx,
                        (unsigned)((ye / sy + block.y - 1) / block.y));
        if (sx == 1 && sy == 1)
            pre_vector<0, 0><<<grid, block, 0, st>>>(in, H, W, pl, p);
        else if (sy == 1)
            pre_vector<1, 0><<<grid, block, 0, st>>>(in, H, W, pl, p);
        else if (sx == 1)
            pre_vector<0, 1><<<grid, block, 0, st>>>(in, H, W, pl, p);
        else
            pre_vector<1, 1><<<grid, block, 0, st>>>(in, H, W, pl, p);
        return (int)cudaGetLastError();
    }
    // a vector instance of kPrePacked: the input's kind and alignment, then
    // the planes' layout (ops/prepost_kernel.pre_instance checks the same)
    const int source = (inst - 2) / kVecSteps, sxl = (inst - 2) % kVecSteps;
    if (source >= kVecSources || xe > (1 << 30) || ye > (1 << 30)
            || !aligned(raw, 16))
        return (int)cudaErrorInvalidValue;
    VecIn vin{};
    bool ok;
    if (source <= kVecRgba) {
        const int nin[3] = {1, 3, 4};
        ok = kind == kInterleaved && s.nin == nin[source]
             && s.pitch % 16 == 0;
        vin.pitch = s.pitch;
    } else if (source == kVecUyvy) {
        ok = kind == kUyvy && s.pitch % 16 == 0;
        vin.pitch = s.pitch;
    } else {
        const int pfx = source == kVecPlanarHalf ? 1 : 0;
        const int cb = kGroup >> pfx;          // chroma bytes a group
        vin.fys = step_shift(src[11]);
        ok = kind == kPlanar && src[10] == 1 && src[13] == 1
             && src[14] == (1 << pfx) && src[15] == src[14]
             && src[12] == src[11] && vin.fys >= 0 && s.pw[0] == W
             && W % kGroup == 0 && s.off[0] % kGroup == 0
             && s.pw[1] == s.pw[2] && s.pw[1] % cb == 0
             && s.off[1] % cb == 0 && s.off[2] % cb == 0;
        for (int k = 0; k < 3; ++k) {
            vin.off[k] = s.off[k];
            vin.pw[k] = s.pw[k];
        }
    }
    const int sy = ncomp >= 2 ? step_shift(pl.dy[1]) : 0;
    ok = ok && pl.dx[0] == 1 && pl.dy[0] == 1 && sy >= 0
         && (ncomp >= 2 ? pl.dx[1] == (1 << sxl) : sxl == 0)
         && (ncomp < 3 || (pl.dx[2] == pl.dx[1] && pl.dy[2] == pl.dy[1]
                           && pl.h[2] == pl.h[1] && pl.w[2] == pl.w[1]))
         && (ncomp < 4 || (pl.dx[3] == 1 && pl.dy[3] == 1));
    unsigned v16 = 0;
    for (int c = 0; c < ncomp; ++c) {
        ok = ok && pl.w[c] % 8 == 0 && aligned(pl.p[c], 8);
        if (pl.w[c] % 16 == 0 && aligned(pl.p[c], 16)) v16 |= 1u << c;
    }
    // bit 1: planes 1 and 2 (one chroma row layout)
    if (ncomp >= 3 && !(v16 & 4u)) v16 &= ~2u;
    if (!ok) return (int)cudaErrorInvalidValue;
    const dim3 grid((groups + bx - 1) / bx,
                    (unsigned)((ye + block.y - 1) / block.y));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    kPrePacked[source][sxl]<<<grid, block, 0, st>>>(
        in, H, W, vin, ncomp, (int)ye, (int)xe, pl, sy, v16, p);
    return (int)cudaGetLastError();
}
