// Forward DCT + quantization for Hopper (sm_90a): one uint8 component plane
// -> int16 zig-zag coefficients in restart-segment order.
//
// Replaces the DCT half of the JAX package's DCT-fused entropy megakernel
// (gpujpeg_tpu/ops/fusedpack.py: _entropy_kernel_body with dct_nmat > 0,
// launched by make_entropy_kernel through entropy_fused_u8).  On the TPU
// the DCT was a block-diagonal MXU matmul on packed sample patches.
//
// The result must equal the JAX package bit for bit, so the arithmetic
// order is fixed (see ops/dct.py): for coefficient z of a block,
//     acc = 0;  for k = 0..63: acc = fmaf(x[k], Mq[k][z], acc)
//     coef = rintf(__fadd_rn(acc, bias[z]))
// Never build this with --use_fast_math, and never replace the chain by a
// tensor-core or TF32 product: each changes about 2 in 10,000 coefficients.
//
// Bound: operations.  An 8K plane has 33.2 M coefficients of 64 FMA each,
// 4.25 GFLOP: about 0.063 ms at 67 TFLOP/s of non-tensor f32 (its 8.3 MB
// in and 66.4 MB out take 0.022 ms at 3.35 TB/s).  So the FMA pipe must be
// fed: the chains run in non-tensor f32 at one FMA an instruction, and
// every other instruction of the kernel is issue time taken from them.
//
// Design (tile.cuh).  A persistent grid (as many CTAs of 128 threads as
// fit on the card) walks tiles of 128 blocks in raster order, which for a
// non-interleaved scan is restart-segment order (segment s = blocks
// [s*rst, (s+1)*rst)), so a tile's coefficients are one contiguous 16 KB
// run of the output.  Per tile:
//   - load: each block row of 8 samples comes with cp.async into a double
//     buffer, 16 bytes (two blocks) a copy when the plane's rows are
//     16-byte aligned, else 8; tile t + 1 is in flight while t computes.
//     A block's coordinates take one 32-bit division a copy;
//   - convert: each sample becomes a float once, into the transposed
//     layout xs[k][block];
//   - compute: Mq sits in shared memory; each thread runs an 8 x 8 register
//     tile of chains (8 blocks x 8 zig-zag slots, 64 accumulators), so
//     four float4 reads feed 64 FMAs.  With one column of Mq in
//     registers and 8 chains a thread (two float4 reads per 8 FMAs) the
//     shared loads, not the FMAs, set the pace (PERF.md, Findings);
//   - store: each thread stores its 8 blocks' slots from registers, 4
//     slots (8 bytes) at a time, 64 contiguous bytes a block for the 8
//     threads that share it; pad blocks past the plane's last block are 0.
//
// Output map.  A non-interleaved scan stores block b at block slot b.
// For an interleaved scan the kernel stores MCU order itself, the
// counterpart of the JAX package's interleaved feed relayout
// (gpujpeg_tpu/models/encoder.py: make_rows_xbd_il_impl, which stacks each
// component's xbd relayout at MCU granularity): block b of a component's
// plane, at block row by = b / bpr and column bx = b % bpr, goes to slot
//     ((by / sv) * mcux + bx / sh) * bpm + off + (by % sv) * sh + bx % sh
// of the scan's (S * rst, bpm, 64) buffer, where the component has sh x sv
// blocks an MCU at offset off of the MCU's bpm and the plane is mcux MCUs
// wide.  A thread's 8 blocks are consecutive in raster order, so the first
// block's coordinates take one division and the others step along the row
// (sh and sv are powers of two: shifts and masks); the map costs a few
// integer operations a block, never one a coefficient.  The launch with
// off = 0 zeroes the MCUs past the image, [nmcu, S * rst) in all bpm
// slots, with one cudaMemsetAsync of that tail.  The planar store is the
// case bpm = sh = sv = 1, off = 0, mcux = bpr, compiled as its own
// instance (kMcu false), unchanged.
// The stage template argument cuts the kernel for the probe in
// chip_smoke.py (gj_fdct_quant_probe); the codec's entry point,
// gj_fdct_quant, always launches the full kernel.  Without its store the
// kernel folds its results into a checksum that it stores only on a
// condition no run meets, so the arithmetic stays.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kTile = 128;        // blocks a tile, raster order
constexpr int kThreads = kTile;   // 8 blocks x 8 slots a thread
// shared memory: raw[2] ([pixel row r][block j][8 samples]), xs ([sample
// k][block j] floats), ms (Mq, [sample k][slot z])
constexpr int kRaw = 8 * kTile * 8;
constexpr int kSmem = 2 * kRaw + 64 * kTile * 4 + 64 * 64 * 4;

__device__ __forceinline__ uint2 pack4(int a, int b, int c, int d) {
    return make_uint2((uint32_t)(a & 0xffff) | ((uint32_t)b << 16),
                      (uint32_t)(c & 0xffff) | ((uint32_t)d << 16));
}

// the MCU-order output map (see the header): slot of block (by, bx)
struct McuMap {
    int bpm, off, lsh, lsv, mcux;

    __device__ __forceinline__ int slot(int by, int bx) const {
        return (((by >> lsv) * mcux + (bx >> lsh)) * bpm + off
                + ((by & ((1 << lsv) - 1)) << lsh) + (bx & ((1 << lsh) - 1)));
    }
};

// nwork: blocks the tiles cover (planar: the output's nblocks_out, so the
// kernel writes the pad blocks; MCU order: the plane's nblocks)
template <int kStage, bool kMcu>
__global__ void __launch_bounds__(kThreads)
fdct_quant_kernel(const uint8_t* __restrict__ plane, int data_w, int bpr,
                  int nblocks, int nwork, int ntiles, bool wide, McuMap map,
                  const float* __restrict__ mq,
                  const float* __restrict__ bias,
                  int16_t* __restrict__ out) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* const raw0 = smem;
    float* const xs = reinterpret_cast<float*>(smem + 2 * kRaw);
    float* const ms = xs + 64 * kTile;
    const int t = threadIdx.x;
    // slots 4 zg.. and 32 + 4 zg.. of blocks bl..bl + 7
    const int zg = t & 7;
    const int bl = (t >> 5) * 32 + ((t >> 3) & 3) * 8;
    for (int i = t; i < 64 * 64; i += kThreads) ms[i] = mq[i];
    float bz[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
        bz[j] = bias[(j < 4 ? 0 : 28) + 4 * zg + j];
    uint32_t chk = 0;                 // kNoStore's checksum

    // cp.async of tile `tile`'s samples into raw[buf], one commit group
    auto issue = [&](int tile, int buf) {
        const int b0 = tile * kTile;
        uint8_t* const raw = raw0 + buf * kRaw;
        if (wide) {               // 16 bytes: row r of blocks 2p, 2p + 1
#pragma unroll
            for (int e = t; e < 4 * kTile; e += kThreads) {
                const int p = e & (kTile / 2 - 1), r = e / (kTile / 2);
                const int b = b0 + 2 * p;
                const bool ok = b < nblocks;
                const uint8_t* src = plane;
                if (ok) {
                    const int by = b / bpr, bx = b - by * bpr;
                    src = plane + (size_t)(by * 8 + r) * data_w + bx * 8;
                }
                gj::cp_async<16>(raw + (r * kTile + 2 * p) * 8, src, ok);
            }
        } else {                  // 8 bytes: row r of block j
#pragma unroll
            for (int e = t; e < 8 * kTile; e += kThreads) {
                const int j = e & (kTile - 1), r = e / kTile;
                const int b = b0 + j;
                const bool ok = b < nblocks;
                const uint8_t* src = plane;
                if (ok) {
                    const int by = b / bpr, bx = b - by * bpr;
                    src = plane + (size_t)(by * 8 + r) * data_w + bx * 8;
                }
                gj::cp_async<8>(raw + (r * kTile + j) * 8, src, ok);
            }
        }
        gj::cp_async_commit();
    };

    int tile = blockIdx.x;
    if (tile < ntiles) issue(tile, 0);
    for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
        const int cur = it & 1;
        const int next = tile + gridDim.x;
        if (next < ntiles)
            issue(next, cur ^ 1);
        else
            gj::cp_async_commit();
        gj::cp_async_wait<1>();   // this tile's copies have landed
        __syncthreads();          // ... all of them; xs is free
        const int b0 = tile * kTile;
        if (kStage == gj::kLoadStore) {
            // no arithmetic: the tile's first samples as coefficients
            const uint8_t* const raw = raw0 + cur * kRaw;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int b = b0 + bl + i;
                if (b < nwork) {
                    const uint2 v = *reinterpret_cast<const uint2*>(
                        raw + (bl + i) * 8);
                    int16_t* const o = out + (int64_t)b * 64 + 4 * zg;
                    *reinterpret_cast<uint2*>(o) = v;
                    *reinterpret_cast<uint2*>(o + 32) = v;
                }
            }
            __syncthreads();      // raw[cur] is read before its next copy
            continue;
        }
        {
            // one float per sample, transposed: xs[r * 8 + c][j]
            const uint8_t* const raw = raw0 + cur * kRaw;
#pragma unroll
            for (int e = t; e < 8 * kTile; e += kThreads) {
                const int j = e & (kTile - 1), r = e / kTile;
                const uint2 v =
                    *reinterpret_cast<const uint2*>(raw + (r * kTile + j) * 8);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    xs[(r * 8 + c) * kTile + j] =
                        (float)((v.x >> (8 * c)) & 255u);
                    xs[(r * 8 + 4 + c) * kTile + j] =
                        (float)((v.y >> (8 * c)) & 255u);
                }
            }
        }
        __syncthreads();
        float acc[8][8];
        gj::fma_tile8x8<kTile>(xs + bl, ms, 4 * zg, acc);
        int by = 0, bx = 0;       // MCU order: block b0 + bl + i's place
        if (kMcu) {
            by = (b0 + bl) / bpr;
            bx = b0 + bl - by * bpr;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            int v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                v[j] = (int)rintf(__fadd_rn(acc[i][j], bz[j]));
            const uint2 lo = pack4(v[0], v[1], v[2], v[3]);
            const uint2 hi = pack4(v[4], v[5], v[6], v[7]);
            const int b = b0 + bl + i;
            if (kStage == gj::kNoStore) {
                chk ^= lo.x + 3u * lo.y + 5u * hi.x + 7u * hi.y;
            } else if (b < nwork) {
                const bool real = kMcu || b < nblocks;
                const int64_t slot = kMcu ? map.slot(by, bx) : b;
                int16_t* const o = out + slot * 64 + 4 * zg;
                *reinterpret_cast<uint2*>(o) = real ? lo : make_uint2(0, 0);
                *reinterpret_cast<uint2*>(o + 32) =
                    real ? hi : make_uint2(0, 0);
            }
            if (kMcu && ++bx == bpr) {
                bx = 0;
                ++by;
            }
        }
    }
    if (kStage == gj::kNoStore && chk == 0x9e3779b9u)
        out[0] = (int16_t)chk;
}

template <int kStage, bool kMcu>
int launch(const uint8_t* plane, int bpr, int64_t nblocks,
           int64_t nblocks_out, const McuMap& map, const void* mq,
           const void* bias, int16_t* out, cudaStream_t stream) {
    const int64_t nwork = kMcu ? nblocks : nblocks_out;
    const int ntiles = (int)((nwork + kTile - 1) / kTile);
    if (kMcu && map.off == 0) {
        // the MCUs past the image, in all bpm slots
        const int64_t nmcu = nblocks >> (map.lsh + map.lsv);
        const int64_t tail = (int64_t)map.bpm * nmcu;
        if (nblocks_out > tail) {
            const cudaError_t e = cudaMemsetAsync(
                out + tail * 64, 0, (size_t)(nblocks_out - tail) * 128,
                stream);
            if (e != cudaSuccess) return (int)e;
        }
    }
    if (ntiles == 0) return (int)cudaGetLastError();
    const bool wide = bpr % 2 == 0 && (uintptr_t)plane % 16 == 0;
    auto* kernel = fdct_quant_kernel<kStage, kMcu>;
    const int fit = gj::resident_ctas(kernel, kThreads, kSmem);
    if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
    const int grid = ntiles < fit ? ntiles : fit;
    kernel<<<grid, kThreads, kSmem, stream>>>(
        plane, bpr * 8, bpr, (int)nblocks, (int)nwork, ntiles, wide, map,
        (const float*)mq, (const float*)bias, out);
    return (int)cudaGetLastError();
}

int log2_small(int v) {          // 1, 2, 4 -> 0, 1, 2; else -1
    return v == 1 ? 0 : v == 2 ? 1 : v == 4 ? 2 : -1;
}

// plane: (data_h, data_w) u8, both multiples of 8; mq: (64, 64) f32
// row-major (sample k, zig-zag z); bias: (64,) f32; out: (nblocks_out, 64)
// int16 block slots.  bpm = 1 (then sh = sv = 1, off = 0, mcux = bpr):
// block b at slot b, nblocks_out >= the plane's blocks, pad slots 0.
// bpm > 1: the MCU map of the header, nblocks_out a multiple of bpm with
// room for every MCU of the plane.
int dispatch(int stage, const void* plane, int data_h, int data_w,
             int64_t nblocks_out, int bpm, int off, int sh, int sv, int mcux,
             const void* mq, const void* bias, void* out, void* stream) {
    const int bpr = data_w / 8, nbh = data_h / 8;
    const int64_t nblocks = (int64_t)nbh * bpr;
    const McuMap map{bpm, off, log2_small(sh), log2_small(sv), mcux};
    const bool mcu = bpm > 1;
    if (data_w % 8 || data_h % 8 || map.lsh < 0 || map.lsv < 0 || bpm < 1
            || off < 0 || off + sh * sv > bpm || (int64_t)mcux * sh != bpr
            || nbh % sv || nblocks_out > INT_MAX - kTile
            || (!mcu && (sh != 1 || sv != 1 || off != 0))
            || (!mcu && nblocks_out < nblocks)
            || (mcu && (nblocks_out % bpm
                        || nblocks / (sh * sv) * bpm > nblocks_out
                        || stage != gj::kFull)))
        return (int)cudaErrorInvalidValue;
    const auto* p = (const uint8_t*)plane;
    auto* o = (int16_t*)out;
    auto* st = (cudaStream_t)stream;
    if (mcu)
        return launch<gj::kFull, true>(p, bpr, nblocks, nblocks_out, map, mq,
                                       bias, o, st);
    switch (stage) {
    case gj::kFull:
        return launch<gj::kFull, false>(p, bpr, nblocks, nblocks_out, map,
                                        mq, bias, o, st);
    case gj::kLoadStore:
        return launch<gj::kLoadStore, false>(p, bpr, nblocks, nblocks_out,
                                             map, mq, bias, o, st);
    case gj::kNoStore:
        return launch<gj::kNoStore, false>(p, bpr, nblocks, nblocks_out,
                                           map, mq, bias, o, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int gj_fdct_quant(const void* plane, int data_h, int data_w,
                             int64_t nblocks_out, int bpm, int off, int sh,
                             int sv, int mcux, const void* mq,
                             const void* bias, void* out, void* stream) {
    return dispatch(gj::kFull, plane, data_h, data_w, nblocks_out, bpm, off,
                    sh, sv, mcux, mq, bias, out, stream);
}

// the probe's cut kernels (gj::Stage), same arguments after the stage;
// planar map only (bpm = 1) for the cut stages
extern "C" int gj_fdct_quant_probe(int stage, const void* plane, int data_h,
                                   int data_w, int64_t nblocks_out, int bpm,
                                   int off, int sh, int sv, int mcux,
                                   const void* mq, const void* bias,
                                   void* out, void* stream) {
    return dispatch(stage, plane, data_h, data_w, nblocks_out, bpm, off, sh,
                    sv, mcux, mq, bias, out, stream);
}
