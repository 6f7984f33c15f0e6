// Huffman decode phase C for Hopper (sm_90a): the 64 zig-zag coefficients
// of every block, straight out of its segment's row.
//
// Replaces the JAX package's Pallas block decoder
// (gpujpeg_tpu/ops/huffdec_kernel.py: _block_kernel_body in its
// segment-row mode, with_cursor=True, launched by make_block_kernel).  On
// the TPU a block is a vector lane whose coefficients are OR-inserted
// into a VMEM tile through one-hot compares, and its segment row has to be
// expanded into every lane; here one thread decodes one block: it reads
// its segment's row from bit bstart[s][j] (phase A's boundary) up to
// bstart[s][j+1].  No per-block buffers (the JAX package's phase B) are
// made.
//
// Semantics as _block_kernel_body: the DC token is decoded first and is
// bad on an invalid code, an overrun of the block's end or a symbol above
// 15; a block whose cursor reaches its end right after DC is done; then
// AC tokens, each bad on an invalid code, an overrun, a coefficient index
// past 63 or a new position past 64; only good tokens that are neither
// EOB nor ZRL and carry value bits write a coefficient; slots j >=
// nblocks[s] are all zero with err 0.  Every good AC token advances the
// position, so a block ends within 63 of them and the JAX kernel's cap of
// MAX_AC_STEPS = 66 never binds: the walk needs no step count.  A
// coefficient index of at most 63 gives a new position of at most 64, so
// one check covers both.  DC is differential (the caller integrates it
// per component along the segment).  A block's table class comes from
// its segment's selectors and the slot pattern (huffdec.cuh), as the JAX
// kernel's per-block class rows, among two table sets or, in the second
// instance of each stage, four (T.81's table ids 0-3; the JAX package
// decodes such streams on its legacy path).  The tables are any baseline
// DHT tables (the JAX kernel's "generic" mode, _block_kernel_body's
// generic branch).
//
// Bound: bytes.  At 8K Q75 (planar 4:4:4) the kernel reads the 25.7 MB
// word matrix and 7.0 MB of bstart and writes 199.1 MB of coefficients
// and 6.2 MB of error flags, about 0.07 ms at 3.35 TB/s.  What it costs
// beyond that is the serial token walk of each block (about 10 tokens at
// 8K Q75), whose integer instructions a lane issues one after another
// while the lanes of a warp wait for the longest block, and, in the
// earlier design, a 128-byte local array with its 64 zero stores,
// scattered writes and reloads.  So:
//
//   - a lookahead table (ops/huffdec_kernel.block_lut, built on the host)
//     indexed by class and the next BLOCK_LUT_BITS = 9 bits: one token an
//     entry, its advance, code length, run and end of block, and its
//     decoded value where the value bits lie inside the 9 bits too.  One
//     32-bit shared load a token, at a table address held in a register.
//     An entry of 0 (a code longer than 9 bits, an invalid one, a DC
//     symbol above 15) takes the canonical decode (huffdec.cuh
//     gj::decode_one); a value that does not fit comes from the window;
//   - the register bit window of phase A (huffdec.cuh gj::BitWindow),
//     started at the block's first bit: its word, then bstart & 31 bits
//     shifted out;
//   - coefficients in shared memory: each warp owns a tile of 32 blocks x
//     64 coefficients (4 KB, coefficient-major, so row k of the tile is
//     contiguous in the (64, L) output), zero when the warp starts on it;
//     a lane writes only its block's nonzero coefficients, then the warp
//     stores the tile with 16-byte stores (64 contiguous bytes a
//     coefficient row) and zeroes it on the way; no per-thread array;
//   - a persistent grid (tile.cuh gj::resident_ctas): as many CTAs of 8
//     warps as fit on the card, each loading the canonical tables (4.6
//     KB) and the lookahead table (8 KB) once, its warps walking tiles
//     independently (a warp barrier a tile, no CTA barrier).  45.6 KB of
//     static shared memory a CTA; a 10-bit table (16 KB) would leave room
//     for 4 warps only, which was slower on three of the four 8K paths
//     (PERF.md).  The four-set instance holds twice the tables (9.3 KB)
//     and twice the lookahead table (16 KB), so it runs CTAs of 4 warps
//     (16 KB of tiles, 41.3 KB in all) and keeps the static limit.
//
// At restart interval 0 a segment is a whole scan (518,400 blocks of 8K
// 4:4:4 luma): its blocks still decode in parallel from phase A's
// cursors, a tile of 32 a warp, and the grid's slot stepping carries
// (s, j) across the row without a division.
//
// The direct instance (kDirect, entry point gj_huffdec_block_direct) is
// the JAX kernel's buffer mode (_block_kernel_body with with_cursor=False,
// which the JAX decoder's _decode_direct takes for non-interleaved scans
// of one block a restart segment): every segment row is one block's
// buffer, slot s decodes from bit 0 of row s up to nbits[s], the
// segment's byte-aligned bit count, and no bstart is read (phase A does
// not run).  That bound lets a corrupt block take up to 7 padding bits
// without an error, as in the JAX kernel.  DC is then absolute (the
// predictor resets at every restart marker).
//
// The stage template argument cuts the kernel for chip_smoke.py's probe
// (gj::Stage; gj_huffdec_block_probe); the codec's entry points,
// gj_huffdec_block and gj_huffdec_block_direct, run the full kernel.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "huffdec.cuh"
#include "tile.cuh"

namespace {

// warps a CTA of the instance with kSets table sets
template <int kSets>
constexpr int kWarps = kSets == 2 ? 8 : 4;
template <int kSets>
constexpr int kThreads = 32 * kWarps<kSets>;
constexpr int kTile = 32;             // blocks a warp tile (a block a lane)
constexpr int kLutBits = 9;           // huffdec_kernel.BLOCK_LUT_BITS
constexpr int kLutSize = 1 << kLutBits;

// block_entry layout (ops/huffdec_kernel.block_entry): advance, code
// length, run, AC end of block, value present, value
constexpr uint32_t kEob = 1u << 14, kFit = 1u << 15;

// block_entry of a token from the canonical decode (no value)
__device__ __forceinline__ uint32_t entry_of(int clen, int sym, bool is_dc) {
    const uint32_t eob = (!is_dc && sym == 0) ? kEob : 0u;
    return (uint32_t)(clen + (sym & 15)) | ((uint32_t)clen << 5)
           | ((uint32_t)(sym >> 4) << 10) | eob;
}

// the sign-extended value (T.81 F.2.2.1) of a token whose entry holds
// none: its value bits after the code at the top of the window (0 when it
// has none)
__device__ __forceinline__ int window_value(uint32_t e, uint64_t buf) {
    const int clen = (int)((e >> 5) & 31u);
    const int size = (int)(e & 31u) - clen;
    if (size == 0) return 0;
    const uint32_t vu = (uint32_t)((buf << clen) >> (64 - size));
    return vu < (1u << (size - 1)) ? (int)vu - (1 << size) + 1 : (int)vu;
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
    return v;
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, int v) {
    asm volatile("st.shared.u16 [%0], %1;"
                 :: "r"(addr), "h"((unsigned short)v) : "memory");
}

// x through an opaque move: a shared address computed once stays in a
// register (the compiler would otherwise recompute it in the walk)
__device__ __forceinline__ uint32_t pinned(uint32_t x) {
    uint32_t y;
    asm volatile("mov.u32 %0, %1;" : "=r"(y) : "r"(x));
    return y;
}

// the lookahead entry of the window's next kLutBits bits in the table at
// shared address t
__device__ __forceinline__ uint32_t lookup(uint32_t t, uint64_t buf) {
    return ld_shared_u32(t + ((uint32_t)(buf >> (64 - kLutBits)) << 2));
}

// One block from its window (at the block's first bit, `cursor`) up to
// bit `bend`: its nonzero coefficients into this lane's column of the
// warp's tile (shared address col_s, a row of kTile int16 a coefficient),
// with the DC and AC lookahead tables at shared addresses dlut_s, alut_s
// and the canonical tables dtab, atab; true when the block is bad.
__device__ __forceinline__ bool decode_block(gj::BitWindow& bw, int& jq,
                                             int cursor, int bend,
                                             uint32_t dlut_s,
                                             uint32_t alut_s,
                                             const int32_t* dtab,
                                             const int32_t* atab,
                                             uint32_t col_s) {
    // DC token
    uint32_t e = lookup(dlut_s, bw.buf);
    int v;
    if (!(e & kFit)) {
        if (e == 0) {
            int clen, sym;
            gj::decode_one(dtab, (int)(bw.buf >> 48), clen, sym);
            e = clen == 0 || sym > 15 ? 0u : entry_of(clen, sym, true);
        }
        v = window_value(e, bw.buf);
    } else {
        v = (int)e >> 16;
    }
    int adv = (int)(e & 31u);
    if (e == 0 || cursor + adv > bend) return true;
    if (v != 0) st_shared_u16(col_s, v);
    cursor += adv;
    if (cursor >= bend) return false;    // the block ends after its DC
    bw.buf <<= adv;
    bw.n -= adv;
    // AC tokens
    int pos = 1;
    while (true) {
        if (bw.n < 32) bw.refill(jq);
        e = lookup(alut_s, bw.buf);
        if (!(e & kFit)) {        // a long or invalid code, or a value past
            if (e == 0) {         // the table's bits
                int clen, sym;
                gj::decode_one(atab, (int)(bw.buf >> 48), clen, sym);
                if (clen == 0) return true;
                e = entry_of(clen, sym, false);
            }
            v = window_value(e, bw.buf);
        } else {
            v = (int)e >> 16;
        }
        adv = (int)(e & 31u);
        const int coef = pos + (int)((e >> 10) & 15u);
        if (cursor + adv > bend || coef > 63) return true;
        if (v != 0) st_shared_u16(col_s + coef * (2 * kTile), v);
        if ((e & kEob) || coef == 63) return false;
        cursor += adv;
        pos = coef + 1;
        bw.buf <<= adv;
        bw.n -= adv;
    }
}

// bounds: bstart (nseg, bps + 1), or with kDirect nbits (nseg,) and bps 1
template <int kStage, int kSets, bool kDirect>
__global__ void __launch_bounds__(kThreads<kSets>)
huffdec_block_kernel(const uint32_t* __restrict__ words, int W,
                     const int32_t* __restrict__ bounds, int bps, int L,
                     const int32_t* __restrict__ nblocks,
                     const int32_t* __restrict__ dc_sel,
                     const int32_t* __restrict__ ac_sel, int bpm,
                     uint32_t dc_pat, uint32_t ac_pat,
                     const int32_t* __restrict__ tables,
                     const uint32_t* __restrict__ lut_g, bool vec,
                     int16_t* __restrict__ coefs,
                     int32_t* __restrict__ err_out) {
    constexpr int kW = kWarps<kSets>, kT = kThreads<kSets>;
    __shared__ int32_t tab[gj::kTablesWords<kSets>];
    __shared__ __align__(16) uint32_t lut[2 * kSets * kLutSize];
    __shared__ __align__(16) int16_t tiles[kW][64 * kTile];
    for (int i = threadIdx.x; i < 2 * kSets * kLutSize / 4; i += kT)
        reinterpret_cast<uint4*>(lut)[i] =
            __ldg(reinterpret_cast<const uint4*>(lut_g) + i);
    for (int i = threadIdx.x; i < kW * 64 * kTile / 8; i += kT)
        reinterpret_cast<uint4*>(&tiles[0][0])[i] = make_uint4(0, 0, 0, 0);
    gj::load_tables<kSets>(tables, tab);     // ends in __syncthreads()

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int16_t* tile = tiles[warp];
    // shared-window addresses, computed once: the tables, and this lane's
    // column of its warp's tile
    const uint32_t lut_s = pinned((uint32_t)__cvta_generic_to_shared(lut));
    const uint32_t col_s = pinned(
        (uint32_t)__cvta_generic_to_shared(tile) + 2u * lane);
    const int ntiles = (L + kTile - 1) / kTile;
    // this lane's slot b = s * bps + j, stepped along the grid's stride
    // without a division
    const int stride = gridDim.x * kW;
    const int step = stride * kTile;
    const int step_s = step / bps, step_j = step - step_s * bps;
    int t = blockIdx.x * kW + warp;
    int b = t * kTile + lane;
    int s = b / bps, j = b - s * bps;
    for (; t < ntiles; t += stride) {
        const int b0 = t * kTile;
        bool bad = false;
        if (b < L) {
            // the slot's loads, issued together
            const int32_t* bs = kDirect ? bounds + s
                                        : bounds + (int64_t)s * (bps + 1) + j;
            const int cursor = kDirect ? 0 : __ldg(bs);
            const int bend = __ldg(bs + (kDirect ? 0 : 1));
            const int nb = __ldg(nblocks + s);
            const int dsel = __ldg(dc_sel + s), asel = __ldg(ac_sel + s);
            if (j < nb) {
                const int slot = bpm == 1 ? 0 : j % bpm;
                const int dcls = gj::set_of<kSets>(dsel, dc_pat, slot);
                const int acls = kSets + gj::set_of<kSets>(asel, ac_pat,
                                                           slot);
                gj::BitWindow bw;
                int jq;
                bw.start_at(words + (int64_t)s * W, W, cursor, jq);
                if (kStage == gj::kLoadStore)      // the loads alone
                    bad = bw.buf == 0x9E3779B97F4A7C15ull;
                else
                    bad = decode_block(
                        bw, jq, cursor, bend,
                        pinned(lut_s + dcls * (4 * kLutSize)),
                        pinned(lut_s + acls * (4 * kLutSize)),
                        tab + dcls * gj::kTableWords,
                        tab + acls * gj::kTableWords, col_s);
            }
        }
        b += step;
        s += step_s;
        j += step_j;
        if (j >= bps) {
            j -= bps;
            ++s;
        }
        __syncwarp();
        // the tile's 64 coefficient rows, each kTile columns from b0 on;
        // every tile entry is zeroed for the next tile
        const int nb = min(kTile, L - b0);
        if (vec) {
#pragma unroll
            for (int m = 0; m < 64 * kTile / 8 / 32; ++m) {
                const int i = lane + 32 * m;     // 16-byte chunk of the tile
                const int k = i / (kTile / 8), c = i % (kTile / 8);
                uint4* src = reinterpret_cast<uint4*>(tile) + i;
                if (kStage != gj::kNoStore && c * 8 < nb)
                    *reinterpret_cast<uint4*>(coefs + (int64_t)k * L + b0
                                              + c * 8) = *src;
                *src = make_uint4(0, 0, 0, 0);
            }
        } else {
            for (int k = 0; k < 64; ++k) {
                if (kStage != gj::kNoStore && lane < nb)
                    coefs[(int64_t)k * L + b0 + lane] =
                        tile[k * kTile + lane];
                tile[k * kTile + lane] = 0;
            }
        }
        if (b0 + lane < L) err_out[b0 + lane] = bad ? 1 : 0;
        __syncwarp();
    }
}

template <int kStage, int kSets, bool kDirect>
int run(const void* words, int64_t nseg, int W, const void* bounds, int bps,
        const void* nblocks, const void* dc_sel, const void* ac_sel,
        int bpm, int dc_pat, int ac_pat, const void* tables, const void* lut,
        void* coefs, void* err, void* stream) {
    constexpr int kW = kWarps<kSets>;
    const int64_t L = nseg * bps;
    auto* kernel = huffdec_block_kernel<kStage, kSets, kDirect>;
    const int fit = gj::resident_ctas(kernel, kThreads<kSets>, 0);
    if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
    const int64_t want = ((L + kTile - 1) / kTile + kW - 1) / kW;
    const int grid = want < fit ? (int)want : fit;
    const bool vec = L % 8 == 0 && ((uintptr_t)coefs & 15) == 0;
    kernel<<<grid, kThreads<kSets>, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)bounds, bps, (int)L,
        (const int32_t*)nblocks, (const int32_t*)dc_sel,
        (const int32_t*)ac_sel, bpm, (uint32_t)dc_pat, (uint32_t)ac_pat,
        (const int32_t*)tables, (const uint32_t*)lut, vec, (int16_t*)coefs,
        (int32_t*)err);
    return (int)cudaGetLastError();
}

// the instance of (stage, table sets), or nullptr; the direct instance
// has the full stage only
template <int kSets>
decltype(&run<gj::kFull, 2, false>) instance(int stage, bool direct) {
    if (direct)
        return stage == gj::kFull ? run<gj::kFull, kSets, true> : nullptr;
    return stage == gj::kFull ? run<gj::kFull, kSets, false>
        : stage == gj::kLoadStore ? run<gj::kLoadStore, kSets, false>
        : stage == gj::kNoStore ? run<gj::kNoStore, kSets, false> : nullptr;
}

int launch(int stage, bool direct, const void* words, int64_t nseg, int W,
           const void* bounds, int bps, const void* nblocks,
           const void* dc_sel, const void* ac_sel, int bpm, int dc_pat,
           int ac_pat, int nsets, const void* tables, const void* lut,
           void* coefs, void* err, void* stream) {
    // words: (nseg, W) host-order u32 rows, 4-byte aligned, 32 W < 2^31;
    // bounds: bstart (nseg, bps+1) i32 with entries in [0, 32 W], or when
    // direct nbits (nseg,) i32 in [0, 32 W] with bps 1; nblocks, dc_sel,
    // ac_sel: (nseg,) i32; bpm, dc_pat, ac_pat: the slot pattern, nsets:
    // 2 or 4 table sets (huffdec.cuh); tables: (2 nsets, 290) i32; lut:
    // (2 nsets, 512) i32 (ops/huffdec_kernel.block_lut), 16-byte aligned;
    // coefs: (64, nseg*bps) i16; err: (nseg*bps,) i32
    const int64_t L = nseg * bps;
    if (L > INT_MAX / 2 || ((uintptr_t)lut & 15)
        || (int64_t)W * 32 > INT_MAX || (direct && bps != 1))
        return (int)cudaErrorInvalidValue;
    if (L <= 0) return (int)cudaGetLastError();
    const auto fn = nsets == 2 ? instance<2>(stage, direct)
        : nsets == 4 ? instance<4>(stage, direct) : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(words, nseg, W, bounds, bps, nblocks, dc_sel, ac_sel, bpm,
              dc_pat, ac_pat, tables, lut, coefs, err, stream);
}

}  // namespace

extern "C" int gj_huffdec_block(const void* words, int64_t nseg, int W,
                                const void* bstart, int bps,
                                const void* nblocks, const void* dc_sel,
                                const void* ac_sel, int bpm, int dc_pat,
                                int ac_pat, int nsets, const void* tables,
                                const void* lut, void* coefs, void* err,
                                void* stream) {
    return launch(gj::kFull, false, words, nseg, W, bstart, bps, nblocks,
                  dc_sel, ac_sel, bpm, dc_pat, ac_pat, nsets, tables, lut,
                  coefs, err, stream);
}

// the direct instance: slot s of row s from bit 0 to nbits[s] (bps 1)
extern "C" int gj_huffdec_block_direct(const void* words, int64_t nseg,
                                       int W, const void* nbits,
                                       const void* nblocks,
                                       const void* dc_sel,
                                       const void* ac_sel, int bpm,
                                       int dc_pat, int ac_pat, int nsets,
                                       const void* tables, const void* lut,
                                       void* coefs, void* err,
                                       void* stream) {
    return launch(gj::kFull, true, words, nseg, W, nbits, 1, nblocks,
                  dc_sel, ac_sel, bpm, dc_pat, ac_pat, nsets, tables, lut,
                  coefs, err, stream);
}

// the probe's cut kernels (gj::Stage), same arguments after the stage:
// loads and stores only starts every block's window and stores its zero
// tile, decoding no token; no store decodes every block into the tile but
// writes no coefficient
extern "C" int gj_huffdec_block_probe(int stage, const void* words,
                                      int64_t nseg, int W,
                                      const void* bstart, int bps,
                                      const void* nblocks,
                                      const void* dc_sel,
                                      const void* ac_sel, int bpm,
                                      int dc_pat, int ac_pat, int nsets,
                                      const void* tables, const void* lut,
                                      void* coefs, void* err, void* stream) {
    return launch(stage, false, words, nseg, W, bstart, bps, nblocks,
                  dc_sel, ac_sel, bpm, dc_pat, ac_pat, nsets, tables, lut,
                  coefs, err, stream);
}
