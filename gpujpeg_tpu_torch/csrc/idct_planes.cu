// Dequantization + inverse DCT for Hopper (sm_90a): the quantized zig-zag
// coefficients of every component of a frame, read out of phase C's (64, L)
// layout -> one (data_h, data_w) uint8 sample plane a component, in one
// launch.
//
// The JAX package computes this step of its interleaved decode tail in
// XLA (gpujpeg_tpu/models/decoder.py: _make_idct_post_fn_t_il, a float32
// jnp.dot at HIGHEST precision, then a byte pack and a block -> plane
// relayout on major dims), not in Pallas.  A library product
// (torch.matmul) sums in another order and changes about 2 samples in
// 10,000, so the port computes it here with the FMA chains of tile.cuh's
// fma_tile8x8 and its sample_u8, which equal the plain version
// (ops/dct.dequantize_idct) and the JAX package bit for bit.
//
// Layout (ops/prepost_kernel.block_layout).  An interleaved scan's columns
// are whole MCUs of bpm blocks, MCU m at columns m * bpm .. m * bpm + bpm
// - 1; slot j of an MCU is block (v, h) of component c's sv x sh blocks,
// j = off_c + v * sh + h (T.81 A.2.3), and MCU m = my * mcux + mx holds
// block (my * sv + v, mx * sh + h) of c's plane.  A non-interleaved frame
// is one run of columns a component, its raster blocks from its first
// column on (the same walk with bpm = sh = sv = 1, mcux = blocks a row).
//
// Bound: operations.  At 8K 4:2:0 a frame takes 64 FMA for each of 49.8 M
// samples: 6.4 GFLOP, about 0.095 ms at 67 TFLOP/s of non-tensor f32; its
// 99.5 MB of coefficients in and 49.8 MB of samples out take about 0.045
// ms at 3.35 TB/s.  At 8K 4:4:4 interleaved: 12.7 GFLOP, about 0.19 ms.
//
// Design, after dpost_rgb.cu.  A persistent grid (tile.cuh's
// resident_ctas) walks tiles of T whole MCUs of one MCU row, T * bpm <= 192
// contiguous columns (T = 192 / bpm rounded down to even: 32 MCUs at 4:2:0,
// 64 at 4:4:4, 192 blocks of one block row when not interleaved), so every
// coefficient sector of the frame is read once.  Per tile:
//   - load: each of the 64 coefficient rows of the tile's 192 columns as
//     16-byte cp.async copies when L, the first columns and the tile's
//     columns are multiples of 8, else 2-byte loads.  Tile t + 1's copies
//     fly during tile t's IDCT and store.  Columns past the tile's last MCU
//     (a ragged tile at a row's end) are loaded and never stored;
//   - dequantize once into the transposed float layout ys[k][column], each
//     column with its component's table;
//   - IDCT: N sits in shared memory, a warp takes 32 columns and each
//     thread an 8 x 8 register tile (8 blocks x 8 samples, tile.cuh), four
//     float4 reads for 64 FMAs; each sample is rounded and clamped by one
//     saturating conversion and 4 samples go to the stage as one word, at
//     the place of their block in its component's strip;
//   - store: a tile of T MCUs is, for each component, a strip of sv * 8
//     rows of T * sh * 8 bytes (at 4:2:0 a 16 x 512 Y strip and two 8 x 256
//     chroma strips); each strip row goes out as 16-byte stores when every
//     plane's width is a multiple of 16, else 8-byte stores.
// The column -> (component, strip place) map depends on the column's slot
// only, and a tile starts on an MCU, so it is one table for the launch.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kCols = 192;          // columns (blocks) of a tile
constexpr int kThreads = kCols;     // 8 blocks x 8 samples a thread
constexpr int kMaxComp = 4;
constexpr int kMaxSlots = 16;
constexpr int kRowPad = 16;         // bytes after each strip row
// shared memory: raw (int16 [k][kCols]), ys (float [k][kCols]), the stage
// (strips of every component: 64 bytes a block plus a row pad), N, the
// quant tables, the column map
constexpr int kRaw = 64 * kCols * 2;
constexpr int kYs = 64 * kCols * 4;
constexpr int kStage = 64 * kCols + 8 * kMaxSlots * kRowPad;
constexpr int kSmem = kRaw + kYs + kStage + 64 * 64 * 4 + kMaxComp * 64 * 4
    + kCols * 4 + 2 * kMaxComp * 4 + kCols;

struct Group {          // a run of MCU rows: the scan, or one component
    int64_t col0;       // column of its first MCU
    int mcux, mcuy;     // MCUs a row, MCU rows
    int tiles_x, tile0; // tiles a row, first tile
    int comp0;          // component of its pattern component 0
};

struct Args {
    const int16_t* coefs;
    int64_t L;
    int ngroups, bpm, T, npc, ntiles, ncomp;
    Group grp[kMaxComp];
    // pattern components (all of an interleaved scan, one otherwise):
    // sampling factors, and each slot's component and (v, h)
    int psh[kMaxComp], psv[kMaxComp];
    int slot_pc[kMaxSlots], slot_v[kMaxSlots], slot_h[kMaxSlots];
    uint8_t* out[kMaxComp];
    int data_w[kMaxComp];
    bool vec_load, vec_store;
    const float* qtabs;
    const float* nmat;
};

struct TileAt {
    int64_t c0;         // first column
    int my, tx, n;      // MCU row, tile of the row, MCUs in the tile
    int comp0;
};

__device__ __forceinline__ TileAt tile_at(const Args& a, int tile) {
    int g = 0;
    while (g + 1 < a.ngroups && tile >= a.grp[g + 1].tile0) ++g;
    const Group& G = a.grp[g];
    const int rel = tile - G.tile0;
    TileAt ta;
    ta.my = rel / G.tiles_x;
    ta.tx = rel - ta.my * G.tiles_x;
    const int m0 = ta.tx * a.T;
    ta.n = G.mcux - m0 < a.T ? G.mcux - m0 : a.T;
    ta.c0 = G.col0 + ((int64_t)ta.my * G.mcux + m0) * a.bpm;
    ta.comp0 = G.comp0;
    return ta;
}

__global__ void __launch_bounds__(kThreads)
idct_planes_kernel(const __grid_constant__ Args a) {
    extern __shared__ __align__(16) uint8_t smem[];
    int16_t* const raw = reinterpret_cast<int16_t*>(smem);
    float* const ys = reinterpret_cast<float*>(smem + kRaw);
    uint8_t* const stage = smem + kRaw + kYs;
    float* const ns = reinterpret_cast<float*>(stage + kStage);
    float* const qs = ns + 64 * 64;
    int* const soff = reinterpret_cast<int*>(qs + kMaxComp * 64);
    int* const prow = soff + kCols;     // bytes a strip row
    int* const pbase = prow + kMaxComp; // first byte of a strip
    uint8_t* const scomp = reinterpret_cast<uint8_t*>(pbase + kMaxComp);
    const int t = threadIdx.x;
    // samples 4 sg.. (row sg / 2, columns (sg % 2) 4..) and 32 + 4 sg..
    // (row 4 + sg / 2) of blocks bl..bl + 7
    const int sg = t & 7;
    const int bl = (t >> 5) * 32 + ((t >> 3) & 3) * 8;
    for (int i = t; i < a.ncomp * 64; i += kThreads) qs[i] = a.qtabs[i];
    for (int i = t; i < 64 * 64; i += kThreads) ns[i] = a.nmat[i];
    if (t == 0) {
        int base = 0;
        for (int r = 0; r < a.npc; ++r) {
            prow[r] = a.T * a.psh[r] * 8 + kRowPad;
            pbase[r] = base;
            base += a.psv[r] * 8 * prow[r];
        }
    }
    __syncthreads();
    {   // column t of every tile: its pattern component and the stage
        // offset of its block's first sample (-1: past the tile's MCUs)
        const int m = t / a.bpm, j = t - m * a.bpm;
        const int r = a.slot_pc[j];
        scomp[t] = (uint8_t)r;
        soff[t] = m < a.T ? pbase[r] + a.slot_v[j] * 8 * prow[r]
                                + (m * a.psh[r] + a.slot_h[j]) * 8
                          : -1;
    }

    // the tile's coefficients into raw (one commit group)
    auto issue = [&](int tile) {
        const TileAt ta = tile_at(a, tile);
        if (a.vec_load) {         // runs of 8 columns, 16 bytes
            constexpr int CQ = kCols / 8;
            for (int e = t; e < 64 * CQ; e += kThreads) {
                const int k = e / CQ, q = e - k * CQ;
                const int64_t col = ta.c0 + q * 8;
                const bool ok = col < a.L;    // all 8 columns, or none
                gj::cp_async<16>(raw + k * kCols + q * 8,
                                 ok ? a.coefs + k * a.L + col : a.coefs, ok);
            }
        } else {
            for (int e = t; e < 64 * kCols; e += kThreads) {
                const int k = e / kCols, i = e - k * kCols;
                const int64_t col = ta.c0 + i;
                raw[e] = col < a.L ? a.coefs[k * a.L + col] : (int16_t)0;
            }
        }
        gj::cp_async_commit();
    };

    int tile = blockIdx.x;
    if (tile < a.ntiles) issue(tile);
    for (; tile < a.ntiles; tile += gridDim.x) {
        const int next = tile + gridDim.x;
        const TileAt ta = tile_at(a, tile);
        gj::cp_async_wait<0>();   // this tile's copies have landed
        __syncthreads();          // ... all of them; the stage is free
        // dequantize once: ys[k][i] = coef * q[component of i][k]
#pragma unroll 4
        for (int e = t * 4; e < 64 * kCols; e += 4 * kThreads) {
            const int k = e / kCols, i = e - k * kCols;
            const float* const qk = qs + ta.comp0 * 64 + k;
            const short4 v = *reinterpret_cast<const short4*>(raw + e);
            *reinterpret_cast<float4*>(ys + e) = make_float4(
                (float)v.x * qk[scomp[i] * 64],
                (float)v.y * qk[scomp[i + 1] * 64],
                (float)v.z * qk[scomp[i + 2] * 64],
                (float)v.w * qk[scomp[i + 3] * 64]);
        }
        __syncthreads();          // raw is free: the next tile's copies fly
        if (next < a.ntiles) issue(next);
        // the IDCT: 8 blocks x 8 samples a thread, 4 samples a word to the
        // stage
        float acc[8][8];
        gj::fma_tile8x8<kCols>(ys + bl, ns, 4 * sg, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int off = soff[bl + i];
            if (off < 0) continue;
            const int rb = prow[scomp[bl + i]];
            uint32_t lo = 0, hi = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                lo |= gj::sample_u8(acc[i][j]) << (8 * j);
                hi |= gj::sample_u8(acc[i][4 + j]) << (8 * j);
            }
            uint8_t* const d = stage + off + (sg >> 1) * rb + (sg & 1) * 4;
            *reinterpret_cast<uint32_t*>(d) = lo;
            *reinterpret_cast<uint32_t*>(d + 4 * rb) = hi;
        }
        __syncthreads();
        // each component's strip: sv * 8 rows of n * sh * 8 bytes
        for (int r = 0; r < a.npc; ++r) {
            const int comp = ta.comp0 + r;
            const int sh = a.psh[r], rows = a.psv[r] * 8;
            const int rb = prow[r], W = a.data_w[comp];
            const int nbytes = ta.n * sh * 8;
            uint8_t* const dst = a.out[comp] + (int64_t)ta.my * rows * W
                + (int64_t)ta.tx * a.T * sh * 8;
            const uint8_t* const src = stage + pbase[r];
            if (a.vec_store) {
                const int per = nbytes >> 4;
                for (int e = t; e < rows * per; e += kThreads) {
                    const int y = e / per, c = (e - y * per) * 16;
                    *reinterpret_cast<uint4*>(dst + (int64_t)y * W + c) =
                        *reinterpret_cast<const uint4*>(src + y * rb + c);
                }
            } else {
                const int per = nbytes >> 3;
                for (int e = t; e < rows * per; e += kThreads) {
                    const int y = e / per, c = (e - y * per) * 8;
                    *reinterpret_cast<uint2*>(dst + (int64_t)y * W + c) =
                        *reinterpret_cast<const uint2*>(src + y * rb + c);
                }
            }
        }
    }
}

}  // namespace

extern "C" int gj_idct_planes(const void* coefs, int64_t L,
                              const int64_t* geo, const void* qtabs,
                              const void* nmat, void* out0, void* out1,
                              void* out2, void* out3, void* stream) {
    // coefs: (64, L) i16 with DC integrated; geo: host int64, [ncomp,
    // interleaved, then per component: first column (non-interleaved) or
    // first slot (interleaved), sh, sv, MCUs a row, MCU rows, data_w];
    // qtabs: (ncomp, 64) f32 zig-zag; nmat: (64, 64) f32, N[k][s]; out:
    // the (data_h, data_w) u8 planes, data_h = MCU rows * sv * 8
    const int ncomp = (int)geo[0];
    const bool il = geo[1] != 0;
    if (ncomp < 1 || ncomp > kMaxComp || L < 0)
        return (int)cudaErrorInvalidValue;
    void* const out[kMaxComp] = {out0, out1, out2, out3};
    Args a = {};
    a.coefs = (const int16_t*)coefs;
    a.L = L;
    a.ncomp = ncomp;
    a.qtabs = (const float*)qtabs;
    a.nmat = (const float*)nmat;
    bool vec_load = L % 8 == 0 && (uintptr_t)coefs % 16 == 0;
    bool vec_store = true;
    int bpm = 0;
    for (int c = 0; c < ncomp; ++c) {
        const int64_t* g = geo + 2 + 6 * c;
        const int64_t first = g[0], sh = g[1], sv = g[2], mcux = g[3],
                      mcuy = g[4], w = g[5];
        if (sh < 1 || sv < 1 || mcux < 1 || mcuy < 0 || first < 0
                || w != mcux * sh * 8 || (int64_t)mcuy * sv * 8 > (1 << 24)
                || w > (1 << 24) || out[c] == nullptr)
            return (int)cudaErrorInvalidValue;
        a.out[c] = (uint8_t*)out[c];
        a.data_w[c] = (int)w;
        if ((uintptr_t)out[c] % 8) return (int)cudaErrorInvalidValue;
        vec_store = vec_store && w % 16 == 0 && (uintptr_t)out[c] % 16 == 0;
        if (il) {
            if (first != bpm || bpm + sh * sv > kMaxSlots
                    || mcux != geo[2 + 3] || mcuy != geo[2 + 4])
                return (int)cudaErrorInvalidValue;
            for (int v = 0; v < sv; ++v)
                for (int h = 0; h < sh; ++h, ++bpm) {
                    a.slot_pc[bpm] = c;
                    a.slot_v[bpm] = v;
                    a.slot_h[bpm] = h;
                }
            a.psh[c] = (int)sh;
            a.psv[c] = (int)sv;
        } else {
            if (sh != 1 || sv != 1) return (int)cudaErrorInvalidValue;
            a.grp[c] = Group{first, (int)mcux, (int)mcuy, 0, 0, c};
        }
    }
    if (il) {
        a.bpm = bpm;
        a.npc = ncomp;
        a.ngroups = 1;
        a.grp[0] = Group{0, (int)geo[2 + 3], (int)geo[2 + 4], 0, 0, 0};
    } else {
        a.bpm = 1;
        a.npc = 1;
        a.ngroups = ncomp;
        a.psh[0] = a.psv[0] = 1;
    }
    a.T = (kCols / a.bpm) & ~1;
    vec_load = vec_load && a.T * a.bpm % 8 == 0;
    int64_t ntiles = 0;
    for (int g = 0; g < a.ngroups; ++g) {
        Group& G = a.grp[g];
        G.tiles_x = (G.mcux + a.T - 1) / a.T;
        G.tile0 = (int)ntiles;
        ntiles += (int64_t)G.mcuy * G.tiles_x;
        if (ntiles > (1 << 30)) return (int)cudaErrorInvalidValue;
        vec_load = vec_load && G.col0 % 8 == 0
            && (int64_t)G.mcux * a.bpm % 8 == 0;
        // the last MCU of the group lies inside the layout
        if (G.col0 + (int64_t)G.mcux * G.mcuy * a.bpm > L)
            return (int)cudaErrorInvalidValue;
    }
    a.ntiles = (int)ntiles;
    a.vec_load = vec_load;
    a.vec_store = vec_store;
    if (a.ntiles == 0) return (int)cudaGetLastError();
    const int fit = gj::resident_ctas(idct_planes_kernel, kThreads, kSmem);
    if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
    const int grid = a.ntiles < fit ? a.ntiles : fit;
    idct_planes_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
