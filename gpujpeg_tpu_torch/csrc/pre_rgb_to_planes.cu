// Encode preprocessor for Hopper (sm_90a): interleaved 8-bit RGB pixels ->
// the three zero-padded uint8 component planes, colour-transformed, each
// at its own decimation (dx, dy), in one launch a frame.
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
//   - a generic instance (any decimation, any W, any alignment; byte loads
//     and stores, 16 pixels of a row a thread) takes the rest.
// The wrapper (ops/prepost_kernel.preprocess_packed) picks the instance;
// this entry checks the vector instance's conditions and refuses a launch
// that breaks them.
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
    uint8_t* p[3];
    int dx[3], dy[3];
    int h[3], w[3];      // data height and width
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

// any decimation per plane, any W, any alignment: one source row y and
// kGroup pixels of it a thread
__global__ void __launch_bounds__(kThreads)
pre_generic(const uint8_t* __restrict__ raw, int H, int W, Planes pl,
            ColorParams p) {
    const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kGroup;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    uint8_t* rowp[3];
    int col[3], rem[3];
    bool keep_row[3];
    bool any = false;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const int yc = y / pl.dy[c];
        keep_row[c] = yc * pl.dy[c] == y && yc < pl.h[c];
        any = any || keep_row[c];
        rowp[c] = pl.p[c] + (int64_t)yc * pl.w[c];
        col[c] = x0 / pl.dx[c];
        rem[c] = x0 - col[c] * pl.dx[c];
    }
    if (!any) return;
    const uint8_t* src = raw + ((int64_t)y * W + x0) * 3;
    for (int i = 0; i < kGroup; ++i) {
        bool keep[3];
        bool need = false;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            keep[c] = keep_row[c] && rem[c] == 0 && col[c] < pl.w[c];
            need = need || keep[c];
        }
        if (need) {
            int v[3] = {0, 0, 0};
            if (y < H && x0 + i < W) {
                v[0] = src[3 * i];
                v[1] = src[3 * i + 1];
                v[2] = src[3 * i + 2];
                convert(p, v[0], v[1], v[2]);
            }
#pragma unroll
            for (int c = 0; c < 3; ++c)
                if (keep[c]) rowp[c][col[c]] = (uint8_t)v[c];
        }
#pragma unroll
        for (int c = 0; c < 3; ++c)
            if (++rem[c] == pl.dx[c]) {
                rem[c] = 0;
                ++col[c];
            }
    }
}

bool aligned(const void* ptr, int bytes) {
    return ((uintptr_t)ptr & (uintptr_t)(bytes - 1)) == 0;
}

}  // namespace

extern "C" int gj_pre_rgb_to_planes(const void* raw, int H, int W,
                                    const int* geo, const int* params,
                                    void* out0, void* out1, void* out2,
                                    int vec, void* stream) {
    // raw: (H, W, 3) u8; geo: host int32[12] = (dx, dy, data_h, data_w)
    // of each plane; out_k: (data_h_k, data_w_k) u8 plane of component k;
    // params: int32[26] = from-matrix[9], from-base[3], to-matrix[9],
    // to-base[3], use_from, use_to (ops/color.kernel_params), host memory;
    // vec: 1 for the vector instance (its conditions are checked here)
    ColorParams p;
    static_assert(sizeof(ColorParams) == 26 * sizeof(int), "layout");
    std::memcpy(&p, params, sizeof(p));
    Planes pl;
    pl.p[0] = (uint8_t*)out0;
    pl.p[1] = (uint8_t*)out1;
    pl.p[2] = (uint8_t*)out2;
    int64_t xe = 0, ye = 0;          // the planes' extent in source pixels
    for (int c = 0; c < 3; ++c) {
        pl.dx[c] = geo[4 * c];
        pl.dy[c] = geo[4 * c + 1];
        pl.h[c] = geo[4 * c + 2];
        pl.w[c] = geo[4 * c + 3];
        if (pl.dx[c] < 1 || pl.dy[c] < 1) return (int)cudaErrorInvalidValue;
        xe = std::max(xe, (int64_t)pl.w[c] * pl.dx[c]);
        ye = std::max(ye, (int64_t)pl.h[c] * pl.dy[c]);
    }
    if (xe <= 0 || ye <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const uint8_t* src = (const uint8_t*)raw;
    const int groups = (int)((xe + kGroup - 1) / kGroup);
    const int bx = std::min(kThreads, (groups + 31) / 32 * 32);
    const dim3 block(bx, kThreads / bx);
    if (!vec) {
        const dim3 grid((groups + bx - 1) / bx,
                        (unsigned)((ye + block.y - 1) / block.y));
        pre_generic<<<grid, block, 0, st>>>(src, H, W, pl, p);
        return (int)cudaGetLastError();
    }
    const int sx = pl.dx[1], sy = pl.dy[1];
    bool ok = pl.dx[0] == 1 && pl.dy[0] == 1 && pl.dx[2] == sx
              && pl.dy[2] == sy && pl.h[2] == pl.h[1] && pl.w[2] == pl.w[1]
              && (sx == 1 || sx == 2) && (sy == 1 || sy == 2)
              && W % kGroup == 0 && xe % kGroup == 0 && ye % sy == 0
              && aligned(raw, 16);
    for (int c = 0; c < 3; ++c) {
        const int vb = kGroup / pl.dx[c];      // bytes of a plane's vector
        ok = ok && pl.w[c] % vb == 0 && aligned(pl.p[c], vb);
    }
    if (!ok) return (int)cudaErrorInvalidValue;
    const dim3 grid((groups + bx - 1) / bx,
                    (unsigned)((ye / sy + block.y - 1) / block.y));
    if (sx == 1 && sy == 1)
        pre_vector<0, 0><<<grid, block, 0, st>>>(src, H, W, pl, p);
    else if (sy == 1)
        pre_vector<1, 0><<<grid, block, 0, st>>>(src, H, W, pl, p);
    else if (sx == 1)
        pre_vector<0, 1><<<grid, block, 0, st>>>(src, H, W, pl, p);
    else
        pre_vector<1, 1><<<grid, block, 0, st>>>(src, H, W, pl, p);
    return (int)cudaGetLastError();
}
