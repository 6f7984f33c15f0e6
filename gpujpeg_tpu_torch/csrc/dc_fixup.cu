// DC fix-up for Hopper (sm_90a): differential DC -> absolute, in place.
//
// The decoder's phase C leaves each block's DC as the difference to the
// predictor (T.81 F.1.1.5.1).  Row 0 of the (64, nseg * bps) coefficient
// matrix holds the DCs, one segment row of bps block slots after the
// other; the predictor resets at each segment (restart marker), and in an
// interleaved row each component predicts from its own previous block:
// slot j belongs to component (pat >> 2 (j % bpm)) & 3 (bps a multiple of
// bpm: a row holds whole MCUs).  The fix-up is an inclusive prefix sum of
// each component's slots along each row.
//
// Port-only: the JAX package computes it in XLA (gpujpeg_tpu/models/
// decoder.py: _dc_fixup_t :390, _dc_fixup_t_flat :295, _dc_fixup :464),
// and the port's plain version is a torch cumsum
// (gpujpeg_tpu_torch/models/decoder.py: _dc_fixup_t).
//
// Bound: bytes.  The DC row is read and written once: 6.2 MB at 8K 4:4:4
// (1,555,200 int16 slots), about 2 us at 3.35 TB/s, under the launch
// floor (an empty kernel took about 5 us on an H100 80GB HBM3 at 700 W,
// PERF.md).  So the design is one launch of one kernel on every shape,
// the row read once and written once in 16-byte vectors (8 slots), and as
// few instructions a slot as the shape allows, since at this size the
// card's instruction rate, not its memory, sets the time (a first design
// with a segmented scan across the warp and CTA on every shape took 2-4
// us more than its loads and stores alone, PERF.md).  A thread takes kV
// consecutive vectors; three layouts (models/decoder.fixup_layout
// mirrors layout() below):
//
//   - kThread: rows of 1, 2, 3, 4, 6, 8, 12 or 24 slots (every restart
//     interval the encoders choose at 8K: 6 or 8), a thread the smallest
//     kV <= kMaxThreadVecs whose 8 kV slots hold whole rows.  Its scan is
//     its own: no shuffle, no barrier, no scratch;
//   - kTileRows: other rows with lcm(bps, 8) <= kTile, one vector a
//     thread, a tile a whole number of rows: a segmented scan per
//     component, reset at every row start, inside the thread, across the
//     warp with shuffles and across the CTA's warps through shared
//     memory; no sum crosses a CTA;
//   - kChained: longer rows (restart interval 0: a scan a row, up to
//     777,600 slots), kChainVecs vectors a thread, tiles of kChainTile
//     slots whose per-component carries pass forward by a decoupled
//     look-back: a tile publishes its aggregate, or, when a row starts in
//     it, its inclusive sums at once (they need nothing before them), and
//     warp 0 of a tile whose first slot is not a row start sums its
//     predecessors' records back to the nearest inclusive one, 32 a load
//     instruction (neighbouring lanes on neighbouring records, so a round
//     of kLookBack records is 32 sectors), with a pause between polls
//     growing to 128 ns (a first design read 8 records a lane, 256
//     sectors a round, and the polling of 660 warps held the L2 busy:
//     0.0405 ms at 8K planar 4:4:4 against 0.0284 for the two launches
//     before it, PERF.md).  The grid is at most the CTAs the card
//     holds at once (gj::resident_ctas), a CTA taking tiles blockIdx.x,
//     + gridDim.x, ..., so the lowest tile not yet published is always
//     running and never waits (the stall guard of lookback.cuh traps a
//     wait past 20 s).  Each record carries the launch's generation,
//     which the wrapper counts up a launch, so a scratch kept between
//     launches needs no memset: a record of an earlier launch never
//     matches.
//
// A thread finds its first slot's place in its row with one 32-bit
// division, the components of its slots with one shift of the MCU's
// component sequence (ext, 2 bits a slot, repeated to 32 slots), and its
// row starts as a bit mask.  Sums are taken modulo 2^32 and stored modulo
// 2^16, as the torch cumsum in int32 and its cast to int16 do, so corrupt
// streams give the plain version's values too.  Where the row is not
// 16-byte aligned, the kTileRows and kChained layouts load and store a
// slot at a time.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().  gj_dc_fixup_probe launches a stage of the
// kernel for chip_smoke.py's probe (tile.cuh gj::Stage: loads and stores
// alone, or everything but the store).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 256;                  // a tile's CTA
constexpr int kVecSlots = 8;                   // slots a 16-byte vector
constexpr int kTile = kThreads * kVecSlots;    // 2048: a kTileRows tile
constexpr int kMaxThreadVecs = 3;              // kThread: 8 to 24 slots
constexpr int kChainVecs = 2;                  // kChained: 16 slots a thread
constexpr int kChainTile = kTile * kChainVecs;
constexpr int kWarps = kThreads / 32;
constexpr int kLookBack = 32 * 8;              // records a look-back round
constexpr unsigned kLanes = 0xFFFFFFFFu;

enum Mode : int { kThread = 0, kTileRows = 1, kChained = 2 };

// a look-back record's status: generation << 2 | kAggregate or kInclusive
constexpr uint32_t kAggregate = 1, kInclusive = 2;

// the aggregate of a span of slots: f, a row starts in it; s[q], the sum
// of component q's slots since the span's last row start (all of them
// when f is 0)
template <int NC>
struct Agg {
    uint32_t f;
    uint32_t s[NC];
};

// the aggregate of span a followed by span b
template <int NC>
__device__ __forceinline__ Agg<NC> combine(const Agg<NC>& a,
                                           const Agg<NC>& b) {
    Agg<NC> r;
    r.f = a.f | b.f;
#pragma unroll
    for (int q = 0; q < NC; ++q) r.s[q] = b.f ? b.s[q] : a.s[q] + b.s[q];
    return r;
}

template <int NC>
__device__ __forceinline__ Agg<NC> shfl_up(const Agg<NC>& a, int d) {
    Agg<NC> r;
    r.f = __shfl_up_sync(kLanes, a.f, d);
#pragma unroll
    for (int q = 0; q < NC; ++q) r.s[q] = __shfl_up_sync(kLanes, a.s[q], d);
    return r;
}

// component c's entry of s (NC registers, selected without local memory)
template <int NC>
__device__ __forceinline__ uint32_t pick(const uint32_t (&s)[NC], int c) {
    uint32_t v = s[0];
#pragma unroll
    for (int q = 1; q < NC; ++q)
        if (q == c) v = s[q];
    return v;
}

__device__ __forceinline__ void publish(uint32_t* status, uint4* vals,
                                        int t, uint32_t code,
                                        const uint32_t* s, int nc) {
    __stcg(vals + t, make_uint4(s[0], nc > 1 ? s[1] : 0u,
                                nc > 2 ? s[2] : 0u, nc > 3 ? s[3] : 0u));
    __threadfence();
    atomicExch(status + t, code);
}

// Warp 0 of tile t: the sums of each component from its row's start (in
// an earlier tile) to the tile's first slot, from the earlier tiles'
// records; load i of lane l reads record t - 1 - (32 i + l)
template <int NC>
__device__ __forceinline__ void look_back(const uint32_t* status,
                                          const uint4* agg,
                                          const uint4* inc, int t,
                                          uint32_t gen,
                                          uint32_t (&carry)[NC]) {
    constexpr int kLoads = kLookBack / 32;
    const int lane = threadIdx.x & 31;
    const uint32_t want_agg = gen << 2 | kAggregate;
    const uint32_t want_inc = gen << 2 | kInclusive;
#pragma unroll
    for (int q = 0; q < NC; ++q) carry[q] = 0;
    int hi = t;
    unsigned pause = 32;
    unsigned long long t_wait = 0;
    for (;;) {
        uint32_t st[kLoads];
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
            const int p = hi - 1 - 32 * i - lane;
            st[i] = p >= 0 ? *(const volatile uint32_t*)(status + p)
                           : want_inc;
        }
        // the nearest inclusive record (load `first`, lane L), and whether
        // every record nearer than it is published
        int first = kLoads, L = 32;
#pragma unroll
        for (int i = kLoads - 1; i >= 0; --i) {
            const unsigned inc_i = __ballot_sync(kLanes, st[i] == want_inc);
            if (inc_i) {
                first = i;
                L = __ffs(inc_i) - 1;
            }
        }
        bool ready = true;
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
            const bool nearer = i < first || (i == first && lane < L);
            if (nearer && st[i] != want_agg) ready = false;
        }
        if (__all_sync(kLanes, ready)) {
            __threadfence();
            uint32_t add[NC];
#pragma unroll
            for (int q = 0; q < NC; ++q) add[q] = 0;
#pragma unroll
            for (int i = 0; i < kLoads; ++i) {
                const int p = hi - 1 - 32 * i - lane;
                const bool nearer = i < first || (i == first && lane < L);
                if (!nearer && !(i == first && lane == L)) continue;
                const uint4 v = nearer ? __ldcg(agg + p) : __ldcg(inc + p);
                const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int q = 0; q < NC; ++q) add[q] += w[q];
            }
#pragma unroll
            for (int q = 0; q < NC; ++q) {
#pragma unroll
                for (int d = 16; d > 0; d >>= 1)
                    add[q] += __shfl_xor_sync(kLanes, add[q], d);
                carry[q] += add[q];
            }
            if (first < kLoads) return;
            hi -= kLookBack;
            continue;
        }
        __nanosleep(pause);
        pause = pause < 128 ? 2 * pause : pause;
        gj::stall_guard(t_wait);
    }
}

// The thread's own segmented scan of its kP slots x, whose row starts
// are the bits of `starts` and whose components the 2-bit fields of seq:
// x[k] becomes the sum of its component since the thread's last row start
// at or before k; -> the thread's aggregate
template <int NC, int kP>
__device__ __forceinline__ Agg<NC> own_scan(uint32_t (&x)[kP],
                                            uint32_t starts, uint64_t seq) {
    Agg<NC> own{};
    own.f = starts != 0;
#pragma unroll
    for (int k = 0; k < kP; ++k) {
        const bool reset = (starts >> k) & 1u;
        if (NC == 1) {
            own.s[0] = (reset ? 0u : own.s[0]) + x[k];
            x[k] = own.s[0];
        } else {
            const int c = (int)((seq >> (2 * k)) & 3u);
#pragma unroll
            for (int q = 0; q < NC; ++q) {
                own.s[q] = (reset ? 0u : own.s[q]) + (q == c ? x[k] : 0u);
                if (q == c) x[k] = own.s[q];
            }
        }
    }
    return own;
}

// the bits k < kP of the row starts of a thread whose first slot is slot
// j0 of its row
template <int kP>
__device__ __forceinline__ uint32_t row_starts(int j0, int bps) {
    uint32_t starts = 0;
    for (int k = j0 ? bps - j0 : 0; k < kP; k += bps) starts |= 1u << k;
    return starts;
}

// kTileRows and kChained: one tile's scan, in place on the thread's kP
// slots x (the tile's slots t0 + tid kP, ...; zeros past its end): each
// thread's own scan, the warps' and the CTA's scans, and for chained
// tiles the look-back over status, agg, inc
template <int NC, int kP, bool kChain>
__device__ __forceinline__ void scan_tile(
        uint32_t (&x)[kP], int t, int t0, int bps, int bpm, uint64_t ext,
        uint32_t* __restrict__ status, uint4* __restrict__ agg,
        uint4* __restrict__ inc, uint32_t gen, Agg<NC>* s_warp,
        uint32_t* s_carry) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // this thread's first slot: its place in its row and its MCU
    const int jt = t0 % bps;
    const int j0 = (int)(((uint32_t)jt + (uint32_t)threadIdx.x * kP)
                         % (uint32_t)bps);
    const uint64_t seq = NC > 1 ? ext >> (2 * (j0 % bpm)) : 0;
    const uint32_t starts = row_starts<kP>(j0, bps);
    const Agg<NC> own = own_scan<NC, kP>(x, starts, seq);
    // slots before the thread's first row start take the carry in
    const uint32_t open = starts ? (starts & (0u - starts)) - 1u
                                 : (1u << kP) - 1u;

    // across the warp, then the warps: this thread's exclusive prefix in
    // the tile (before), and the tile's aggregate (run)
    Agg<NC> incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Agg<NC> y = shfl_up(incl, d);
        if (lane >= d) incl = combine(y, incl);
    }
    Agg<NC> before = shfl_up(incl, 1);
    if (lane == 0) before = Agg<NC>{};
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    Agg<NC> run{};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        if (w == warp) before = combine(run, before);
        run = combine(run, s_warp[w]);
    }

    // the carry into the tile from the row's earlier tiles
    if (kChain) {
        if (threadIdx.x == 0)
            publish(status, run.f ? inc : agg, t,
                    gen << 2 | (run.f ? kInclusive : kAggregate), run.s,
                    NC);
        if (jt != 0) {
            if (warp == 0) {
                uint32_t carry[NC];
                look_back<NC>(status, agg, inc, t, gen, carry);
                if (lane == 0) {
#pragma unroll
                    for (int q = 0; q < NC; ++q) {
                        s_carry[q] = carry[q];
                        carry[q] += run.s[q];
                    }
                    if (!run.f)
                        publish(status, inc, t, gen << 2 | kInclusive, carry,
                                NC);
                }
            }
            __syncthreads();
            if (!before.f) {
#pragma unroll
                for (int q = 0; q < NC; ++q) before.s[q] += s_carry[q];
            }
        }
    }
#pragma unroll
    for (int k = 0; k < kP; ++k)
        if ((open >> k) & 1u)
            x[k] += pick(before.s, NC > 1 ? (int)((seq >> (2 * k)) & 3u)
                                          : 0);
}

// The fix-up of tiles blockIdx.x, + gridDim.x, ... of tile_slots slots
// each (the last one ragged) over the L = nseg * bps < 2^31 slots of the
// DC row, kV vectors a thread, in layout kMode; status, agg, inc: the
// look-back records of kChained tiles, else null
template <int NC, int kV, bool kVec, int kStage, int kMode>
__global__ void __launch_bounds__(kThreads)
dc_fixup_kernel(int16_t* __restrict__ dc, int L, int bps, int bpm,
                uint64_t ext, int tile_slots, int tiles,
                uint32_t* __restrict__ status, uint4* __restrict__ agg,
                uint4* __restrict__ inc, uint32_t gen) {
    constexpr int kP = kV * kVecSlots;
    __shared__ Agg<NC> s_warp[kMode == kThread ? 1 : kWarps];
    __shared__ uint32_t s_carry[NC];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int t0 = t * tile_slots;
        const int end = min(t0 + tile_slots, L);
        const int g0 = t0 + (int)threadIdx.x * kP;
        uint32_t x[kP];
        const bool whole = kVec && g0 + kP <= end;
        if (whole) {
#pragma unroll
            for (int v = 0; v < kV; ++v) {
                const uint4 u = reinterpret_cast<const uint4*>(dc + g0)[v];
                const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
                for (int k = 0; k < kVecSlots; ++k)
                    x[kVecSlots * v + k] = (uint32_t)(int32_t)(int16_t)(
                        w[k / 2] >> (16 * (k & 1)));
            }
        } else {
#pragma unroll
            for (int k = 0; k < kP; ++k)
                x[k] = g0 + k < end ? (uint32_t)(int32_t)dc[g0 + k] : 0u;
        }
        if constexpr (kStage != gj::kLoadStore) {
            if constexpr (kMode == kThread) {
                // whole rows a thread: its first slot starts a row
                own_scan<NC, kP>(x, row_starts<kP>(0, bps), ext);
            } else {
                scan_tile<NC, kP, kMode == kChained>(
                    x, t, t0, bps, bpm, ext, status, agg, inc, gen, s_warp,
                    s_carry);
            }
        }
        if constexpr (kStage == gj::kNoStore) {
            // a store no input takes, so that nothing is left out
            uint32_t h = 0;
#pragma unroll
            for (int k = 0; k < kP; ++k) h = h * 31u + x[k];
            if (h == 0x9E3779B9u && g0 < end) dc[g0] = (int16_t)h;
        } else if (whole) {
#pragma unroll
            for (int v = 0; v < kV; ++v) {
                uint32_t w[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    w[i] = (x[kVecSlots * v + 2 * i] & 0xFFFFu)
                           | (x[kVecSlots * v + 2 * i + 1] << 16);
                reinterpret_cast<uint4*>(dc + g0)[v] =
                    make_uint4(w[0], w[1], w[2], w[3]);
            }
        } else {
#pragma unroll
            for (int k = 0; k < kP; ++k)
                if (g0 + k < end) dc[g0 + k] = (int16_t)(uint16_t)x[k];
        }
        if (kMode != kThread)
            __syncthreads();        // s_warp and s_carry of the next tile
    }
}

// The layout of rows of bps slots (models/decoder.fixup_layout mirrors
// it): its mode, vectors a thread and slots a tile; kThread only where
// the row is 16-byte aligned (vec)
void layout(int64_t bps, bool vec, int& mode, int& vecs, int& tile_slots) {
    for (vecs = 1; vecs <= kMaxThreadVecs; ++vecs)
        if (vec && (kVecSlots * vecs) % bps == 0) {
            mode = kThread;
            tile_slots = kTile * vecs;
            return;
        }
    int64_t a = bps, b = kVecSlots;
    while (b) {
        const int64_t r = a % b;
        a = b;
        b = r;
    }
    const int64_t lcm = bps / a * kVecSlots;
    if (lcm <= kTile) {
        mode = kTileRows;
        vecs = 1;
        tile_slots = (int)(kTile / lcm * lcm);
    } else {
        mode = kChained;
        vecs = kChainVecs;
        tile_slots = kChainTile;
    }
}

template <int NC, int kV, bool kVec, int kStage, int kMode>
int run(int16_t* dc, int L, int bps, int bpm, uint64_t ext, int tile_slots,
        int tiles, uint32_t* scratch, uint32_t gen, cudaStream_t st) {
    auto* kernel = dc_fixup_kernel<NC, kV, kVec, kStage, kMode>;
    int grid = tiles;
    uint32_t* status = nullptr;
    uint4* agg = nullptr;
    uint4* inc = nullptr;
    if (kMode == kChained) {
        // at most the CTAs that fit at once
        const int fit = gj::resident_ctas(kernel, kThreads, 0);
        if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
        grid = tiles < fit ? tiles : fit;
        status = scratch;
        agg = reinterpret_cast<uint4*>(scratch + (tiles + 3) / 4 * 4);
        inc = agg + tiles;
    }
    kernel<<<grid, kThreads, 0, st>>>(dc, L, bps, bpm, ext, tile_slots,
                                      tiles, status, agg, inc, gen);
    return (int)cudaGetLastError();
}

// the instance of (components, layout, alignment, stage)
template <int NC, int kStage>
int by_layout(int mode, int vecs, bool vec, int16_t* dc, int L, int bps,
              int bpm, uint64_t ext, int tile_slots, int tiles,
              uint32_t* scratch, uint32_t gen, cudaStream_t st) {
    if (mode == kThread)
        return vecs == 1
            ? run<NC, 1, true, kStage, kThread>(dc, L, bps, bpm, ext,
                                                tile_slots, tiles, nullptr,
                                                gen, st)
            : vecs == 2
            ? run<NC, 2, true, kStage, kThread>(dc, L, bps, bpm, ext,
                                                tile_slots, tiles, nullptr,
                                                gen, st)
            : run<NC, 3, true, kStage, kThread>(dc, L, bps, bpm, ext,
                                                tile_slots, tiles, nullptr,
                                                gen, st);
    if (mode == kTileRows)
        return vec
            ? run<NC, 1, true, kStage, kTileRows>(dc, L, bps, bpm, ext,
                                                  tile_slots, tiles,
                                                  nullptr, gen, st)
            : run<NC, 1, false, kStage, kTileRows>(dc, L, bps, bpm, ext,
                                                   tile_slots, tiles,
                                                   nullptr, gen, st);
    return vec
        ? run<NC, kChainVecs, true, kStage, kChained>(
              dc, L, bps, bpm, ext, tile_slots, tiles, scratch, gen, st)
        : run<NC, kChainVecs, false, kStage, kChained>(
              dc, L, bps, bpm, ext, tile_slots, tiles, scratch, gen, st);
}

template <int kStage>
int fixup(void* dc, int64_t nseg, int64_t bps, int bpm, int64_t pat,
          void* scratch, int64_t scratch_words, int gen, void* stream) {
    if (nseg < 0 || bps < 1 || bps >= (1 << 30) || bpm < 1 || bpm > 16
        || bps % bpm || pat < 0 || pat >= (int64_t)1 << (2 * bpm))
        return (int)cudaErrorInvalidValue;
    if (nseg == 0) return (int)cudaGetLastError();
    if (nseg * bps > INT_MAX - kChainTile) return (int)cudaErrorInvalidValue;
    // components (1 + the largest in pat), and the component of each slot
    // of 32 from an MCU's first, 2 bits a slot
    int nc = 1;
    uint64_t ext = 0;
    for (int f = 0; f < 32; ++f) {
        const int c = (int)((pat >> (2 * (f % bpm))) & 3);
        nc = c + 1 > nc ? c + 1 : nc;
        ext |= (uint64_t)c << (2 * f);
    }
    const bool vec = ((uintptr_t)dc & 15) == 0;
    int mode, vecs, tile_slots;
    layout(bps, vec, mode, vecs, tile_slots);
    const int L = (int)(nseg * bps);
    const int tiles = (L + tile_slots - 1) / tile_slots;
    const int64_t words = (tiles + 3) / 4 * 4 + 8 * (int64_t)tiles;
    if (mode == kChained && (scratch == nullptr || gen < 1
                             || gen >= (1 << 30) || scratch_words < words))
        return (int)cudaErrorInvalidValue;
    uint32_t* s = (uint32_t*)scratch;
    int16_t* d = (int16_t*)dc;
    cudaStream_t st = (cudaStream_t)stream;
    switch (nc) {
        case 1:
            return by_layout<1, kStage>(mode, vecs, vec, d, L, (int)bps, bpm,
                                        ext, tile_slots, tiles, s, gen, st);
        case 2:
            return by_layout<2, kStage>(mode, vecs, vec, d, L, (int)bps, bpm,
                                        ext, tile_slots, tiles, s, gen, st);
        case 3:
            return by_layout<3, kStage>(mode, vecs, vec, d, L, (int)bps, bpm,
                                        ext, tile_slots, tiles, s, gen, st);
        default:
            return by_layout<4, kStage>(mode, vecs, vec, d, L, (int)bps, bpm,
                                        ext, tile_slots, tiles, s, gen, st);
    }
}

}  // namespace

// dc: the DC row (row 0 of the (64, nseg * bps) int16 coefficients),
// integrated in place; bpm slots an MCU (bps a multiple of it), pat their
// components (2 bits a slot); scratch: uint32 [ceil4(tiles) + 8 tiles] of
// look-back records where the layout chains its tiles
// (models/decoder.fixup_layout), kept between launches on one stream,
// zeroed once when made; gen: the launch's generation, 1 to 2^30 - 1,
// never that of the launch before on the same scratch.
extern "C" int gj_dc_fixup(void* dc, int64_t nseg, int64_t bps, int bpm,
                           int64_t pat, void* scratch,
                           int64_t scratch_words, int gen, void* stream) {
    return fixup<gj::kFull>(dc, nseg, bps, bpm, pat, scratch,
                            scratch_words, gen, stream);
}

extern "C" int gj_dc_fixup_probe(int stage, void* dc, int64_t nseg,
                                 int64_t bps, int bpm, int64_t pat,
                                 void* scratch, int64_t scratch_words,
                                 int gen, void* stream) {
    return stage == gj::kFull
        ? fixup<gj::kFull>(dc, nseg, bps, bpm, pat, scratch, scratch_words,
                           gen, stream)
        : stage == gj::kLoadStore
        ? fixup<gj::kLoadStore>(dc, nseg, bps, bpm, pat, scratch,
                                scratch_words, gen, stream)
        : stage == gj::kNoStore
        ? fixup<gj::kNoStore>(dc, nseg, bps, bpm, pat, scratch,
                              scratch_words, gen, stream)
        : (int)cudaErrorInvalidValue;
}
