// Fused decode back half for Hopper (sm_90a): quantized zig-zag
// coefficients of 3 components, chroma decimated by dx, dy in {1, 2} ->
// interleaved 8-bit RGB or RGBA pixels.  Dequantization, inverse DCT, nearest chroma
// upsampling, the colour transform and the store in one pass.
//
// Replaces the JAX package's Pallas decode tail
// (gpujpeg_tpu/ops/prepost_kernel.py: _dpost_kernel_body, launched by
// _cached_dpost_kernel through decode_post_fused).  On the TPU the IDCT was
// an MXU matmul over 128-lane-aligned tiles of block rows, with the
// upsampling folded into (dx*dy*64, 64) chroma matrices (_dpost_matrices),
// and an RGBX word store that the caller sliced to RGB.  Here each chroma
// sample is computed once and then upsampled, so no folded matrix is
// needed, the block count needs no alignment and a ragged last segment is
// simply skipped.
//
// The result must equal the plain version (ops/dct.dequantize_idct, then
// ops/sample.postprocess) bit for bit, so the arithmetic order is fixed:
// the FMA chains of tile.cuh's fma_tile8x8 (each in its k order) and its
// sample_u8, then the integer colour transform of colorspace.cuh.  IDCT,
// then upsample, as the plain version does.
//
// Bound: operations.  At 8K 4:4:4 every one of 3 x 33.2 M samples takes 64
// FMA: 12.7 GFLOP, about 0.19 ms at 67 TFLOP/s of non-tensor f32 (the bytes,
// 199.1 MB of coefficients in and 99.5 MB of pixels out, take about 0.089
// ms at 3.35 TB/s).  At 4:2:0 the 49.8 M samples need 6.4 GFLOP, about
// 0.095 ms; the bytes (99.5 MB in, 99.5 MB out) 0.059 ms.  So, as in
// fdct_quant.cu, every instruction beside the chains' FMAs is issue time
// taken from them, and every phase that leaves the FMA pipe idle shows.
//
// Design.  A persistent grid (as many CTAs as fit, a warp for every 32
// blocks of a tile) walks tiles of one chroma block row: TC = 64 / dx
// chroma blocks of each chroma component and the dy x 64 luma blocks under
// them (192 blocks at 4:4:4 and 4:2:0), a strip of 8 dy pixel rows x 512
// pixels.  Per tile:
//   - load: the tile's coefficients come from the (64, L) layout, where a
//     component's raster blocks are consecutive columns, as runs of 8
//     blocks of one coefficient: 16-byte cp.async when every run is
//     16-byte aligned (the 8K layouts), else 2-byte loads.  Tile t + 1's
//     copies are issued as soon as tile t is dequantized, so they fly
//     during t's IDCT, colour and store with one buffer (two would leave
//     room for one CTA an SM, not two);
//   - dequantize once, into the transposed float layout ys[k][block];
//   - IDCT: N sits in shared memory; every block, luma or chroma, takes the
//     same chains, so a warp takes 32 blocks and each thread an 8 x 8
//     register tile (8 blocks x 8 samples, tile.cuh), four float4 reads
//     for 64 FMAs.  The old kernel computed 3 chains a pixel, so at 4:2:0
//     each chroma sample 4 times; now each chroma sample is computed once
//     (49.8 M chains at 8K 4:2:0, not 99.5 M).  A thread's 8 samples are 4
//     neighbouring pixels of two rows of its block; each is rounded and
//     clamped by one saturating conversion and they go to shared memory
//     as two 4-byte words;
//   - colour: 4 neighbouring pixels of the dy rows under one chroma row at
//     a time, chroma at the nearest-neighbour index of
//     ops/prepost_kernel.decode_post's docstring (tile pixel (py, px)
//     takes chroma sample (py / dy, px / dx)); for a YCbCr -> RGB
//     transform the chroma part of each output's sum is formed once per
//     chroma sample (colour_from).  The 12 RGB bytes of 4 pixels (16
//     with alpha 255 for a P4444_U8_P0123 output, the OB = 4 instances)
//     are staged in shared memory (in ys, which the IDCT no longer reads:
//     even the 2048-byte RGBA rows of a 16-row strip fit there, so RGBA
//     costs no shared memory and no CTA an SM);
//   - store: the strip's rows (1536 bytes each, 2048 for RGBA) go out as
//     16-byte stores when W * OB % 16 == 0, else byte by byte; pixels
//     past H or W are not stored (blocks past a row's end compute
//     garbage that no pixel takes).
// The RGBA bytes of an 8K frame (132.7 MB out, 199.1 MB in at 4:4:4;
// 99.5 MB in at 4:2:0) take 0.099 / 0.069 ms at 3.35 TB/s, below the
// operations' 0.19 / 0.095 ms, so RGBA stays bound by its operations.
// PERF.md (Findings) keeps what chip_smoke.py and its probe measured of
// this design on an H100: the IDCT's FMA issue takes most of the time,
// then the colour phase; the bytes take the least.
//
// The stage template argument cuts the kernel for the probe in
// chip_smoke.py (gj_dpost_rgb_probe, at dx = dy = 1 and 2); the codec's
// entry point, gj_dpost_rgb, always launches the full kernel.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "colorspace.cuh"
#include "tile.cuh"

namespace {

constexpr int kLumaCols = 64;     // luma blocks a tile row
constexpr int kPx = 8 * kLumaCols;  // pixels a tile row
constexpr int kQuads = kPx / 4;     // 4-pixel groups a tile row
// bytes a tile row of pixels of OB bytes (3: RGB, 4: RGBA)
template <int OB>
constexpr int kRow = OB * kPx;

template <int DX, int DY>
struct Tile {
    static constexpr int TC = kLumaCols / DX;     // chroma blocks a component
    static constexpr int NL = kLumaCols * DY;     // luma blocks
    static constexpr int NB = NL + 2 * TC;        // blocks
    static constexpr int NT = NB;                 // threads: 8 blocks x 8
                                                  // samples each
    static constexpr int ROWS = 8 * DY;           // pixel rows
    static constexpr int CW = 8 * TC;             // chroma samples a row
    // sample rows are padded by 8 bytes, so that the 4 rows a warp writes
    // fall in different banks
    static constexpr int kYRow = kPx + 8;
    static constexpr int kCRow = CW + 8;
    // shared memory: raw (int16 [k][NB]), ys (float [k][NB], then the RGB
    // rows), ypl (u8 [ROWS][kYRow]), cpl (u8 [2][8][kCRow]), ns (N, [k][s]
    // floats), qs
    static constexpr int kRaw = 64 * NB * 2;
    static constexpr int kYs = 64 * NB * 4;
    static constexpr int kYpl = ROWS * kYRow;
    static constexpr int kCpl = 2 * 8 * kCRow;
    static constexpr int kSmem =
        kRaw + kYs + kYpl + kCpl + 64 * 64 * 4 + 3 * 64 * 4;
    static_assert(NB % 32 == 0 && TC % 8 == 0, "whole warps");
    static_assert(kYs >= ROWS * kRow<4>, "RGBA rows fit in ys");
};

struct Args {
    const int16_t* coefs;
    int64_t L;
    int64_t off[3];       // column of each component's first block
    int bpr, cbpr;        // luma and chroma blocks a row
    int tiles_x, ntiles;  // tiles a chroma block row, tiles
    int H, W;
    bool vec_load, vec_store;
    const float* qtabs;
    const float* nmat;
    gj::ColorParams p;
    uint8_t* out;
};

// column in the (64, L) layout of block i of the tile at chroma block row
// cby, luma column bx0, chroma column cbx0, and whether it exists
template <int DX, int DY>
__device__ __forceinline__ bool tile_column(const Args& a, int i, int cby,
                                            int bx0, int cbx0,
                                            int64_t& col) {
    using T = Tile<DX, DY>;
    if (i < T::NL) {
        const int bx = bx0 + i % kLumaCols;
        col = a.off[0] + (int64_t)(cby * DY + i / kLumaCols) * a.bpr + bx;
        return bx < a.bpr;
    }
    const int cc = (i - T::NL) / T::TC;
    const int cbx = cbx0 + (i - T::NL) % T::TC;
    col = a.off[1 + cc] + (int64_t)cby * a.cbpr + cbx;
    return cbx < a.cbpr;
}

template <int OB>
__device__ __forceinline__ void put_quad(uint8_t* rgb,
                                         const uint32_t (&b)[OB]) {
    uint32_t* const d = reinterpret_cast<uint32_t*>(rgb);
#pragma unroll
    for (int k = 0; k < OB; ++k) d[k] = b[k];
}

// The 12 bytes R0 G0 B0 R1 | G1 B1 R2 G2 | B2 R3 G3 B3 of 4 pixels (OB =
// 3), or their 16 bytes R G B 255 a pixel (OB = 4: P4444_U8_P0123 from 3
// components, alpha 255 as sample.pack_channels fills it)
template <int OB>
__device__ __forceinline__ void pack_quad(const int (&c)[4][3],
                                          uint32_t (&b)[OB]) {
    const auto two = [](int lo, int hi) {
        return __byte_perm(lo, hi, 0x0040);    // bytes lo.0, hi.0
    };
    if constexpr (OB == 3) {
        b[0] = __byte_perm(two(c[0][0], c[0][1]), two(c[0][2], c[1][0]),
                           0x5410);
        b[1] = __byte_perm(two(c[1][1], c[1][2]), two(c[2][0], c[2][1]),
                           0x5410);
        b[2] = __byte_perm(two(c[2][2], c[3][0]), two(c[3][1], c[3][2]),
                           0x5410);
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
            b[u] = __byte_perm(two(c[u][0], c[u][1]), two(c[u][2], 255),
                               0x5410);
    }
}

// Colour of a tile through colorspace.cuh's convert, 4 pixels of a row at
// a time -> 4 OB bytes of rgb (the tile's rows, kRow<OB> bytes each).
template <int DX, int DY, int OB>
__device__ __forceinline__ void colour_any(const gj::ColorParams& p,
                                           const uint8_t* ypl,
                                           const uint8_t* cpl, uint8_t* rgb,
                                           int t) {
    using T = Tile<DX, DY>;
#pragma unroll 1
    for (int e = t; e < T::ROWS * kQuads; e += T::NT) {
        const int py = e / kQuads, px = e % kQuads * 4;
        const uint32_t y4 =
            *reinterpret_cast<const uint32_t*>(ypl + py * T::kYRow + px);
        const uint8_t* const cb = cpl + (py / DY) * T::kCRow;
        const uint8_t* const cr = cb + 8 * T::kCRow;
        int c[4][3];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            c[u][0] = (y4 >> (8 * u)) & 255;
            c[u][1] = cb[(px + u) / DX];
            c[u][2] = cr[(px + u) / DX];
            gj::convert(p, c[u][0], c[u][1], c[u][2]);
        }
        uint32_t b[OB];
        pack_quad<OB>(c, b);
        put_quad<OB>(rgb + py * kRow<OB> + px * OB, b);
    }
}

// The same for a transform of one "from" step (a YCbCr-like space to RGB,
// every decode to RGB): convert's sum for output i,
//     (r0 m[3i] + r1 m[3i+1] + r2 m[3i+2] + 128) >> 8,
// is an exact integer sum, so its chroma part r1 m[3i+1] + r2 m[3i+2] +
// 128 is formed once per chroma sample and added to each pixel's luma
// part; the dx dy pixels that take a chroma sample share that work.  A
// thread takes 4 columns of the dy rows under one chroma row.
template <int DX, int DY, int OB>
__device__ __forceinline__ void colour_from(const gj::ColorParams& p,
                                            const uint8_t* ypl,
                                            const uint8_t* cpl,
                                            uint8_t* rgb, int t) {
    using T = Tile<DX, DY>;
    constexpr int NC = 4 / DX;        // chroma samples of 4 columns
#pragma unroll 4
    for (int e = t; e < 8 * kQuads; e += T::NT) {
        const int cy = e / kQuads, px = e % kQuads * 4;
        const uint8_t* const cb = cpl + cy * T::kCRow + px / DX;
        const uint8_t* const cr = cb + 8 * T::kCRow;
        // the NC chroma samples of each component in one load
        const uint32_t cb4 = NC == 4 ? *reinterpret_cast<const uint32_t*>(cb)
                                     : *reinterpret_cast<const uint16_t*>(cb);
        const uint32_t cr4 = NC == 4 ? *reinterpret_cast<const uint32_t*>(cr)
                                     : *reinterpret_cast<const uint16_t*>(cr);
        int pre[NC][3];
#pragma unroll
        for (int v = 0; v < NC; ++v) {
            const int r1 = gj::scale_255_to_256(
                (int)((cb4 >> (8 * v)) & 255u) - p.from_b[1]);
            const int r2 = gj::scale_255_to_256(
                (int)((cr4 >> (8 * v)) & 255u) - p.from_b[2]);
#pragma unroll
            for (int i = 0; i < 3; ++i)
                pre[v][i] = r1 * p.from_m[3 * i + 1]
                    + r2 * p.from_m[3 * i + 2] + 128;
        }
#pragma unroll
        for (int r = 0; r < DY; ++r) {
            const int py = cy * DY + r;
            const uint32_t y4 =
                *reinterpret_cast<const uint32_t*>(ypl + py * T::kYRow + px);
            int c[4][3];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int r0 = gj::scale_255_to_256(
                    (int)((y4 >> (8 * u)) & 255) - p.from_b[0]);
#pragma unroll
                for (int i = 0; i < 3; ++i)   // clamp255 in one instruction
                    c[u][i] = __vimin_s32_relu(
                        (r0 * p.from_m[3 * i] + pre[u / DX][i]) >> 8, 255);
            }
            uint32_t b[OB];
            pack_quad<OB>(c, b);
            put_quad<OB>(rgb + py * kRow<OB> + px * OB, b);
        }
    }
}

template <int DX, int DY, int kStage, int OB>
__global__ void __launch_bounds__(Tile<DX, DY>::NT)
dpost_rgb_kernel(const Args a) {
    using T = Tile<DX, DY>;
    extern __shared__ __align__(16) uint8_t smem[];
    int16_t* const raw = reinterpret_cast<int16_t*>(smem);
    float* const ys = reinterpret_cast<float*>(smem + T::kRaw);
    uint8_t* const rgb = smem + T::kRaw;              // ys, after the IDCT
    uint8_t* const ypl = smem + T::kRaw + T::kYs;
    uint8_t* const cpl = ypl + T::kYpl;
    float* const ns = reinterpret_cast<float*>(cpl + T::kCpl);
    float* const qs = ns + 64 * 64;
    const int t = threadIdx.x;
    // samples 4 sg.. (row sg / 2, columns (sg % 2) 4..) and 32 + 4 sg..
    // (row 4 + sg / 2) of blocks bl..bl + 7
    const int sg = t & 7;
    const int bl = (t >> 5) * 32 + ((t >> 3) & 3) * 8;
    for (int i = t; i < 3 * 64; i += T::NT) qs[i] = a.qtabs[i];
    for (int i = t; i < 64 * 64; i += T::NT) ns[i] = a.nmat[i];

    // the tile's coefficients into raw (one commit group)
    auto issue = [&](int tile) {
        const int cby = tile / a.tiles_x, tx = tile - cby * a.tiles_x;
        const int bx0 = tx * kLumaCols, cbx0 = tx * T::TC;
        if (a.vec_load) {         // runs of 8 blocks, 16 bytes
            constexpr int CQ = T::NB / 8;
            for (int e = t; e < 64 * CQ; e += T::NT) {
                const int k = e / CQ, q = e - k * CQ;
                int64_t col;
                const bool ok = tile_column<DX, DY>(a, q * 8, cby, bx0, cbx0,
                                                    col);
                gj::cp_async<16>(raw + k * T::NB + q * 8,
                                 ok ? a.coefs + k * a.L + col : a.coefs, ok);
            }
        } else {
            for (int e = t; e < 64 * T::NB; e += T::NT) {
                const int k = e / T::NB, i = e - k * T::NB;
                int64_t col;
                const bool ok = tile_column<DX, DY>(a, i, cby, bx0, cbx0,
                                                    col);
                raw[e] = ok ? a.coefs[k * a.L + col] : (int16_t)0;
            }
        }
        gj::cp_async_commit();
    };

    int tile = blockIdx.x;
    if (tile < a.ntiles) issue(tile);
    for (; tile < a.ntiles; tile += gridDim.x) {
        const int next = tile + gridDim.x;
        gj::cp_async_wait<0>();   // this tile's copies have landed
        __syncthreads();          // ... all of them; ys and rgb are free
        if (kStage != gj::kLoadStore) {
            // dequantize once: ys[k][i] = coef * q[component][k], 4 blocks
            // of one component at a time
#pragma unroll 4
            for (int e = t * 4; e < 64 * T::NB; e += 4 * T::NT) {
                const int k = e / T::NB, i = e - k * T::NB;
                const int c = i < T::NL ? 0 : 1 + (i - T::NL) / T::TC;
                const float q = qs[c * 64 + k];
                const short4 v = *reinterpret_cast<const short4*>(raw + e);
                *reinterpret_cast<float4*>(ys + e) = make_float4(
                    (float)v.x * q, (float)v.y * q, (float)v.z * q,
                    (float)v.w * q);
            }
        }
        __syncthreads();          // raw is free: the next tile's copies fly
        if (next < a.ntiles) issue(next);
        if (kStage != gj::kLoadStore) {
            // blocks bl..bl + 7: luma rows, then Cb, then Cr
            float acc[8][8];
            gj::fma_tile8x8<T::NB>(ys + bl, ns, 4 * sg, acc);
            uint8_t* dst;             // sample row sg / 2 of block bl
            int stride;               // bytes a sample row
            if (bl < T::NL) {
                stride = T::kYRow;
                dst = ypl + (bl / kLumaCols) * 8 * T::kYRow
                    + (bl % kLumaCols) * 8;
            } else {
                stride = T::kCRow;
                dst = cpl + ((bl - T::NL) / T::TC) * 8 * T::kCRow
                    + ((bl - T::NL) % T::TC) * 8;
            }
            dst += (sg >> 1) * stride + (sg & 1) * 4;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                uint32_t lo = 0, hi = 0;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    lo |= gj::sample_u8(acc[i][j]) << (8 * j);
                    hi |= gj::sample_u8(acc[i][4 + j]) << (8 * j);
                }
                *reinterpret_cast<uint32_t*>(dst + i * 8) = lo;
                *reinterpret_cast<uint32_t*>(dst + i * 8 + 4 * stride) = hi;
            }
        }
        __syncthreads();
        if (kStage != gj::kLoadStore) {
            if (a.p.use_from && !a.p.use_to)
                colour_from<DX, DY, OB>(a.p, ypl, cpl, rgb, t);
            else
                colour_any<DX, DY, OB>(a.p, ypl, cpl, rgb, t);
        }
        __syncthreads();
        if (kStage != gj::kNoStore) {
            const int cby = tile / a.tiles_x, tx = tile - cby * a.tiles_x;
            const int y0 = cby * T::ROWS, x0 = tx * kPx;
            const int npx = a.W - x0 < kPx ? a.W - x0 : kPx;
            const int nbytes = OB * npx;
            constexpr int kR = kRow<OB>;
            uint8_t* const row0 = a.out + ((int64_t)y0 * a.W + x0) * OB;
            if (a.vec_store) {
                constexpr int kV = kR / 16;           // 16-byte stores a row
                for (int e = t; e < T::ROWS * kV; e += T::NT) {
                    const int r = e / kV, c = (e - r * kV) * 16;
                    if (y0 + r < a.H && c < nbytes)
                        *reinterpret_cast<uint4*>(
                            row0 + (int64_t)r * a.W * OB + c) =
                            *reinterpret_cast<const uint4*>(rgb + r * kR + c);
                }
            } else {
                for (int e = t; e < T::ROWS * kR; e += T::NT) {
                    const int r = e / kR, c = e - r * kR;
                    if (y0 + r < a.H && c < nbytes)
                        row0[(int64_t)r * a.W * OB + c] = rgb[r * kR + c];
                }
            }
        }
    }
}

template <int DX, int DY, int kStage, int OB>
int run(const Args& a, cudaStream_t stream) {
    using T = Tile<DX, DY>;
    auto* kernel = dpost_rgb_kernel<DX, DY, kStage, OB>;
    const int fit = gj::resident_ctas(kernel, T::NT, T::kSmem);
    if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
    const int grid = a.ntiles < fit ? a.ntiles : fit;
    kernel<<<grid, T::NT, T::kSmem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int kStage, int OB>
int dispatch(int dx, int dy, const Args& a, cudaStream_t stream) {
    if (dx == 1 && dy == 1) return run<1, 1, kStage, OB>(a, stream);
    if (dx == 2 && dy == 2) return run<2, 2, kStage, OB>(a, stream);
    if constexpr (kStage == gj::kFull) {    // the probe takes 1x1 and 2x2
        if (dx == 2 && dy == 1) return run<2, 1, kStage, OB>(a, stream);
        if (dx == 1 && dy == 2) return run<1, 2, kStage, OB>(a, stream);
    }
    return (int)cudaErrorInvalidValue;
}

int launch(int stage, const void* coefs, int64_t L, const int64_t* offsets,
           int64_t nblk, int bpr, int dx, int dy, int H, int W, int ob,
           const void* qtabs, const void* nmat, const int* params, void* out,
           void* stream) {
    // coefs: (64, L) i16 with DC integrated; offsets: host int64[3], the
    // column of each component's first block; nblk: luma blocks, bpr of
    // them a block row (chroma: nblk / (dx dy) blocks, bpr / dx a row);
    // dx, dy in {1, 2}; qtabs: (3, 64) f32 zig-zag; nmat: (64, 64) f32,
    // N[k][s]; params: host int32[26] (ops/color.kernel_params); ob:
    // bytes a pixel, 3 (RGB) or 4 (RGBA, alpha 255; full stage only);
    // out: (H, W, ob) u8
    if ((ob != 3 && (ob != 4 || stage != gj::kFull)) || dx < 1 || dx > 2 || dy < 1 || dy > 2 || bpr <= 0 || bpr % dx
            || nblk % bpr || (nblk / bpr) % dy || nblk / bpr > (1 << 24))
        return (int)cudaErrorInvalidValue;
    Args a;
    a.coefs = (const int16_t*)coefs;
    a.L = L;
    bool aligned = L % 8 == 0 && (uintptr_t)coefs % 16 == 0;
    for (int c = 0; c < 3; ++c) {
        a.off[c] = offsets[c];
        aligned = aligned && offsets[c] % 8 == 0;
    }
    a.bpr = bpr;
    a.cbpr = bpr / dx;
    a.vec_load = aligned && a.bpr % 8 == 0 && a.cbpr % 8 == 0;
    a.vec_store = (int64_t)W * ob % 16 == 0 && (uintptr_t)out % 16 == 0;
    const int tc = kLumaCols / dx;
    a.tiles_x = (a.cbpr + tc - 1) / tc;
    const int64_t ntiles = (nblk / bpr / dy) * a.tiles_x;
    if (ntiles > (1 << 30)) return (int)cudaErrorInvalidValue;
    a.ntiles = (int)ntiles;
    a.H = H;
    a.W = W;
    a.qtabs = (const float*)qtabs;
    a.nmat = (const float*)nmat;
    static_assert(sizeof(gj::ColorParams) == 26 * sizeof(int), "layout");
    std::memcpy(&a.p, params, sizeof(a.p));
    a.out = (uint8_t*)out;
    if (a.ntiles == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    if (ob == 4) return dispatch<gj::kFull, 4>(dx, dy, a, st);
    switch (stage) {
    case gj::kFull: return dispatch<gj::kFull, 3>(dx, dy, a, st);
    case gj::kLoadStore: return dispatch<gj::kLoadStore, 3>(dx, dy, a, st);
    case gj::kNoStore: return dispatch<gj::kNoStore, 3>(dx, dy, a, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int gj_dpost_rgb(const void* coefs, int64_t L,
                            const int64_t* offsets, int64_t nblk, int bpr,
                            int dx, int dy, int H, int W, int ob,
                            const void* qtabs, const void* nmat,
                            const int* params, void* out, void* stream) {
    return launch(gj::kFull, coefs, L, offsets, nblk, bpr, dx, dy, H, W, ob,
                  qtabs, nmat, params, out, stream);
}

// the probe's cut kernels (gj::Stage), same arguments after the stage
extern "C" int gj_dpost_rgb_probe(int stage, const void* coefs, int64_t L,
                                  const int64_t* offsets, int64_t nblk,
                                  int bpr, int dx, int dy, int H, int W,
                                  int ob, const void* qtabs,
                                  const void* nmat, const int* params,
                                  void* out, void* stream) {
    return launch(stage, coefs, L, offsets, nblk, bpr, dx, dy, H, W, ob,
                  qtabs, nmat, params, out, stream);
}
