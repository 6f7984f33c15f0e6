// DC fix-up for Hopper (sm_90a): differential DC -> absolute, in place.
//
// The decoder's phase C leaves each block's DC as the difference to the
// predictor (T.81 F.1.1.5.1).  Row 0 of the (64, nseg * bps) coefficient
// matrix holds the DCs, one segment row of bps block slots after the
// other; the predictor resets at each segment (restart marker), and in an
// interleaved row each component predicts from its own previous block:
// slot j belongs to component (pat >> 2 (j % bpm)) & 3.  The fix-up is an
// inclusive prefix sum of each component's slots along each row.
//
// Port-only: the JAX package computes it in XLA (gpujpeg_tpu/models/
// decoder.py: _dc_fixup_t :390, _dc_fixup_t_flat :295, _dc_fixup :464),
// and the port's plain version is a torch cumsum
// (gpujpeg_tpu_torch/models/decoder.py: _dc_fixup_t).
//
// Bound: bytes.  The DC row is read and written once: 6.2 MB at 8K 4:4:4
// (1,555,200 int16 slots), about 2 us at 3.35 TB/s, under the launch
// floor (an empty kernel took about 5 us on an H100 80GB HBM3 at 700 W,
// PERF.md).  The shapes span two extremes:
//   - the tuned restart intervals give short rows and many of them (6 to
//     16 slots, 130,000 to 260,000 rows at 8K): one thread a (row,
//     component) walks its row's slots and keeps the sum in a register
//     (dc_fixup_rows); neighbouring threads touch neighbouring rows, so a
//     warp's loads fall in a few sectors;
//   - restart interval 0 gives one row a scan, up to 518,400 slots (planar
//     4:4:4) or 777,600 (interleaved 4:2:0): a thread a row would walk it
//     serially as phase A does.  Rows longer than kShortSlots are cut into
//     tiles of kTile slots, a CTA of kScanThreads threads a tile, kPer
//     consecutive slots a thread.  Pass 1 (dc_fixup_tiles<false>) writes
//     each tile's per-component totals; pass 2 (dc_fixup_tiles<true>) adds
//     the totals of the row's earlier tiles (summed by one warp), scans
//     the tile (a warp scan with shuffles, then a scan of the 32 warps'
//     totals) and stores.  The tiles' totals live in a scratch array that
//     the wrapper allocates: (nseg * tiles, 4) int32.
// Sums are taken modulo 2^32 and stored modulo 2^16, as the torch cumsum
// in int32 and its cast to int16 do, so corrupt streams give the plain
// version's values too.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kShortSlots = 64;     // longest row a thread a (row, comp)
constexpr int kRowThreads = 256;    // dc_fixup_rows' CTA
constexpr int kScanThreads = 1024;  // dc_fixup_tiles' CTA
constexpr int kPer = 8;             // consecutive slots a thread a tile
constexpr int kTile = kScanThreads * kPer;   // 8192 slots a tile
constexpr int kWarps = kScanThreads / 32;
static_assert(kWarps == 32, "one warp scans the warps' totals");

__device__ __forceinline__ int comp_of(uint32_t pat, int m) {
    return (int)((pat >> (2 * m)) & 3u);
}

__device__ __forceinline__ int next_slot(int m, int bpm) {
    return m + 1 == bpm ? 0 : m + 1;
}

__global__ void __launch_bounds__(kRowThreads)
dc_fixup_rows(int16_t* __restrict__ dc, int64_t nseg, int bps, int bpm,
              uint32_t pat, int ncomp) {
    const int64_t t = (int64_t)blockIdx.x * kRowThreads + threadIdx.x;
    if (t >= nseg * ncomp) return;
    const int64_t row = t / ncomp;
    const int c = (int)(t - row * ncomp);
    int16_t* p = dc + row * bps;
    uint32_t acc = 0;
    int m = 0;
    for (int j = 0; j < bps; ++j) {
        if (comp_of(pat, m) == c) {
            acc += (uint32_t)(int32_t)p[j];
            p[j] = (int16_t)(uint16_t)acc;
        }
        m = next_slot(m, bpm);
    }
}

// Each thread's kPer slots: their per-component running sums in v (inclusive,
// local to the thread) and the thread's totals in s.
__device__ __forceinline__ void local_scan(int32_t (&v)[kPer],
                                           uint32_t (&s)[4], int m,
                                           int bpm, uint32_t pat) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int c = comp_of(pat, m);
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (q == c) {
                s[q] += (uint32_t)v[k];
                v[k] = (int32_t)s[q];
            }
        m = next_slot(m, bpm);
    }
}

template <bool kStore>
__global__ void __launch_bounds__(kScanThreads)
dc_fixup_tiles(int16_t* __restrict__ dc, int64_t bps, int bpm, uint32_t pat,
               int tiles, uint32_t* __restrict__ sums) {
    __shared__ uint32_t s_warp[kWarps][4];
    __shared__ uint32_t s_carry[4];
    const int64_t row = blockIdx.x / tiles;
    const int tile = (int)(blockIdx.x - row * tiles);
    int16_t* p = dc + row * bps;
    const int64_t j0 = (int64_t)tile * kTile + (int64_t)threadIdx.x * kPer;
    const int m0 = (int)(j0 % bpm);
    int32_t v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
        v[k] = j0 + k < bps ? (int32_t)p[j0 + k] : 0;
    uint32_t s[4];
    local_scan(v, s, m0, bpm, pat);

    // inclusive scan of the threads' totals within each warp
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t inc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        inc[q] = s[q];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t y = __shfl_up_sync(0xffffffffu, inc[q], d);
            if (lane >= d) inc[q] += y;
        }
    }
    if (lane == 31) {
#pragma unroll
        for (int q = 0; q < 4; ++q) s_warp[warp][q] = inc[q];
    }
    __syncthreads();
    if (warp == 0) {
        // exclusive scan of the 32 warps' totals; lane 31 ends with the
        // tile's total
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint32_t own = s_warp[lane][q];
            uint32_t w = own;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const uint32_t y = __shfl_up_sync(0xffffffffu, w, d);
                if (lane >= d) w += y;
            }
            s_warp[lane][q] = w - own;
            if (!kStore && lane == 31)
                sums[(int64_t)blockIdx.x * 4 + q] = w;
            if (kStore) {
                // the totals of the row's earlier tiles
                uint32_t carry = 0;
                for (int t = lane; t < tile; t += 32)
                    carry += sums[(row * tiles + t) * 4 + q];
#pragma unroll
                for (int d = 16; d > 0; d >>= 1)
                    carry += __shfl_xor_sync(0xffffffffu, carry, d);
                if (lane == 0) s_carry[q] = carry;
            }
        }
    }
    __syncthreads();
    if (!kStore) return;
    uint32_t base[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
        base[q] = s_carry[q] + s_warp[warp][q] + inc[q] - s[q];
    int m = m0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int c = comp_of(pat, m);
        uint32_t add = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (q == c) add = base[q];
        if (j0 + k < bps)
            p[j0 + k] = (int16_t)(uint16_t)((uint32_t)v[k] + add);
        m = next_slot(m, bpm);
    }
}

}  // namespace

// dc: the DC row (row 0 of the (64, nseg * bps) int16 coefficients),
// integrated in place; bpm slots an MCU, pat their components (2 bits a
// slot), ncomp components (threads a row on the short path); sums: the
// (nseg * tiles, 4) int32 scratch of rows longer than kShortSlots, tiles =
// ceil(bps / kTile), else null and 0.
extern "C" int gj_dc_fixup(void* dc, int64_t nseg, int64_t bps, int bpm,
                           int64_t pat, int ncomp, void* sums, int tiles,
                           void* stream) {
    if (nseg <= 0 || bps <= 0) return (int)cudaGetLastError();
    if (bpm < 1 || bpm > 16 || ncomp < 1 || ncomp > 4 || pat < 0
        || pat >= (int64_t)1 << (2 * bpm))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int16_t* d = (int16_t*)dc;
    if (bps <= kShortSlots) {
        const int64_t threads = nseg * ncomp;
        const int64_t blocks = (threads + kRowThreads - 1) / kRowThreads;
        if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
        dc_fixup_rows<<<(unsigned)blocks, kRowThreads, 0, st>>>(
            d, nseg, (int)bps, bpm, (uint32_t)pat, ncomp);
        return (int)cudaGetLastError();
    }
    if (sums == nullptr || tiles != (bps + kTile - 1) / kTile
        || nseg * tiles > INT_MAX)
        return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(nseg * tiles);
    uint32_t* s = (uint32_t*)sums;
    dc_fixup_tiles<false><<<grid, kScanThreads, 0, st>>>(
        d, bps, bpm, (uint32_t)pat, tiles, s);
    dc_fixup_tiles<true><<<grid, kScanThreads, 0, st>>>(
        d, bps, bpm, (uint32_t)pat, tiles, s);
    return (int)cudaGetLastError();
}
