// Huffman decode phase C for Hopper (sm_90a): the 64 zig-zag coefficients
// of every block, straight out of its segment's row.
//
// Replaces the JAX package's Pallas block decoder
// (gpujpeg_tpu/ops/huffdec_kernel.py: _block_kernel_body, launched by
// make_block_kernel) in both its modes, as two kernels that no longer
// share a body: the segment-row instance (with_cursor=True) and the
// direct instance (buffer mode, with_cursor=False).  On the TPU a block is
// a vector lane whose coefficients are OR-inserted into a VMEM tile
// through one-hot compares, and its segment row has to be expanded into
// every lane; here one thread decodes one block.  No per-block buffers
// (the JAX package's phase B) are made.
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
// one check covers both.  A block's table class comes from its segment's
// selectors and the slot pattern (huffdec.cuh), as the JAX kernel's
// per-block class rows, among two table sets or, in the second instance
// of each kernel, four (T.81's table ids 0-3; the JAX package decodes
// such streams on its legacy path).  The tables are any baseline DHT
// tables (the JAX kernel's "generic" mode).
//
// Both kernels keep coefficients in shared memory: each warp owns a tile
// of 32 blocks x 64 coefficients (4 KB, coefficient-major, so row k of
// the tile is contiguous in the (64, L) output), zero when the warp starts
// on it; a lane writes only its block's nonzero coefficients, then the
// warp stores the tile with 16-byte stores (64 contiguous bytes a
// coefficient row) and zeroes it on the way.  Both run a persistent grid
// (tile.cuh gj::resident_ctas) of CTAs of 8 warps, each warp walking
// tiles independently (a warp barrier a tile, no CTA barrier).
//
// The segment-row instance (gj_huffdec_block): slot j of segment s decodes
// its segment's row from bit bstart[s][j] (phase A's boundary) up to
// bstart[s][j+1]; DC is differential (the caller integrates it per
// component along the segment).  Bound: bytes.  At 8K Q75 (planar 4:4:4)
// it reads the 25.7 MB word matrix and 7.0 MB of bstart and writes 199.1
// MB of coefficients and 6.2 MB of error flags, about 0.07 ms at 3.35
// TB/s.  What it costs beyond that is the serial token walk of each block
// (about 10 tokens at 8K Q75), whose integer instructions a lane issues
// one after another while the lanes of a warp wait for the longest block.
// So:
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
//   - two table sets: the canonical tables (4.6 KB) and the lookahead
//     table (8 KB) in static shared memory, 45.6 KB a CTA with the tiles;
//     a 10-bit table (16 KB) would leave room for 4 warps only, which was
//     slower on three of the four 8K paths (PERF.md).  Four sets: twice
//     the lookahead table (16 KB) and the eight canonical tables packed
//     (their symbols as bytes, 3.1 KB instead of 9.3) in dynamic shared
//     memory, 52.3 KB a CTA, so that four CTAs of 8 warps fit an SM as in
//     the two-set instance (before, static shared memory held the tables
//     with CTAs of 4 warps only, 20 warps an SM).  A three-set stream
//     runs it too (its fourth set is a copy of its third).
//
// At restart interval 0 a segment is a whole scan (518,400 blocks of 8K
// 4:4:4 luma): its blocks still decode in parallel from phase A's
// cursors, a tile of 32 a warp, and the grid's slot stepping carries
// (s, j) across the row without a division.
//
// The direct instance (gj_huffdec_block_direct) is the JAX kernel's buffer
// mode, which the JAX decoder's _decode_direct takes for non-interleaved
// scans of one block a restart segment (the auto interval at Q >= 97):
// every segment row is one block's buffer, slot s decodes from bit 0 of
// row s up to nbits[s], the segment's byte-aligned bit count, and no
// bstart is read (phase A does not run).  That bound lets a corrupt block
// take up to 7 padding bits without an error, as in the JAX kernel.  DC is
// then absolute (the predictor resets at every restart marker).  Bound:
// bytes, 0.093 ms at 8K Q100 planar 4:4:4 (99.5 MB of words, 199.1 MB of
// coefficients).  A block there holds about 61 tokens of about 8 bits.
// The segment-row walk took it at 4.3x that bound: 90% of those AC tokens
// fit the 9-bit table with their value, but with 32 lanes a warp nearly
// every step had some lane on the window path, some refilling and some
// on the canonical decode, and the warp issued each path in turn.  And a
// walk of 61 dependent steps waits on itself: with half the CTAs the
// walk below takes 1.4x as long (PERF.md; chip_variants.py measures each
// step below taken out).  So the direct instance walks one path a token,
// on as many warps as fit:
//
//   - a two-level table (ops/huffdec_kernel.direct_lut, built on the host
//     and cached on the plan) of 16-bit entries: code length, advance,
//     run in the top bits, and two flags, DIRECT_SPECIAL (an end of block
//     or an invalid code) and DIRECT_SUB (a prefix holding a code longer
//     than its DIRECT_LUT_BITS = 11 bits, whose entry indexes a table of
//     the next 5 bits): every code of a 16-bit peek without the canonical
//     decode, 4-5 KB a table, in dynamic shared memory sized to the
//     launch's table sets;
//   - one path for a common token: one table load, the value from the
//     peek (shifts and a mask, no branch), a store at its coefficient
//     whatever its value (a ZRL's zero lands on a zero); everything else
//     (a second-level entry, an end of block, an error, coefficient 63)
//     goes to one branch that one or two tokens a block take.  With the
//     second load in the common path, where the compiler predicates it,
//     the walk took 1.2x as long;
//   - a warp's 32 rows staged in shared memory: 4-byte asynchronous
//     copies (cp.async), coalesced over the tile's contiguous words, into
//     rows of an odd word stride (no bank conflict between lanes at the
//     same word); double-buffered (tile t+1's rows arrive while tile t
//     decodes), or single-buffered where that lets more CTAs reside (8K
//     Q100 planar 4:4:4: 24 warps an SM instead of 16, double buffering
//     there 1.1x as long); rows too wide for shared memory read the
//     matrix from global memory (at 8K, 1.05-1.7x as long);
//   - a window of three words in registers (hi, lo, the next one), the
//     32-bit peek a funnel shift of hi:lo; crossing a word moves them
//     down with selects, byteswaps the next one and loads the one after
//     as stored with a predicated load, so no branch, load or byteswap
//     stands in the chain from one token to the next.
//
// The stage template argument cuts each kernel for chip_smoke.py's probe
// (gj::Stage; gj_huffdec_block_probe, gj_huffdec_block_direct_probe):
// loads and stores only (every block's loads and window, no token
// decoded, the zero tiles stored), and the decode without the
// coefficient store; the codec's entry points run the full kernels.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "huffdec.cuh"
#include "tile.cuh"

namespace {

constexpr int kWarps = 8;             // warps a CTA, both kernels
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;             // blocks a warp tile (a block a lane)
constexpr int kTileBytes = 64 * kTile * 2;
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

__device__ __forceinline__ uint32_t ld_shared_u16(uint32_t addr) {
    unsigned short v;
    asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
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

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// the lookahead entry of the window's next kLutBits bits in the table at
// shared address t
__device__ __forceinline__ uint32_t lookup(uint32_t t, uint64_t buf) {
    return ld_shared_u32(t + ((uint32_t)(buf >> (64 - kLutBits)) << 2));
}

// The canonical decode of a segment-row block's slow tokens: the tables
// as they come (int32[290] each, huffdec.cuh), or packed (gj::Packed)
struct Wide {
    const int32_t* t;
    __device__ __forceinline__ void decode(int p16, int& clen,
                                           int& sym) const {
        gj::decode_one(t, p16, clen, sym);
    }
};

// One block from its window (at the block's first bit, `cursor`) up to
// bit `bend`: its nonzero coefficients into this lane's column of the
// warp's tile (shared address col_s, a row of kTile int16 a coefficient),
// with the DC and AC lookahead tables at shared addresses dlut_s, alut_s
// and the canonical tables dtab, atab; true when the block is bad.
template <class Canon>
__device__ __forceinline__ bool decode_block(gj::BitWindow& bw, int& jq,
                                             int cursor, int bend,
                                             uint32_t dlut_s,
                                             uint32_t alut_s,
                                             const Canon& dtab,
                                             const Canon& atab,
                                             uint32_t col_s) {
    // DC token
    uint32_t e = lookup(dlut_s, bw.buf);
    int v;
    if (!(e & kFit)) {
        if (e == 0) {
            int clen, sym;
            dtab.decode((int)(bw.buf >> 48), clen, sym);
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
                atab.decode((int)(bw.buf >> 48), clen, sym);
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

// The warp's tile of 32 blocks from slot b0 on to the (64, L)
// coefficients (none under the probe's kNoStore), zeroing it, and each
// lane's error flag; vec: L % 8 == 0 and coefs 16-byte aligned
template <int kStage>
__device__ __forceinline__ void store_tile(int16_t* tile,
                                           int16_t* __restrict__ coefs,
                                           int32_t* __restrict__ err_out,
                                           int L, int b0, int lane, bool vec,
                                           bool bad) {
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
                coefs[(int64_t)k * L + b0 + lane] = tile[k * kTile + lane];
            tile[k * kTile + lane] = 0;
        }
    }
    if (b0 + lane < L) err_out[b0 + lane] = bad ? 1 : 0;
}

// -- the segment-row instance -----------------------------------------------

// dynamic shared memory of the four-set instance: the lookahead table,
// the warps' tiles, then the packed canonical tables
constexpr int kLut4Bytes = 2 * 4 * kLutSize * 4;
constexpr int kMv4Words = 2 * 4 * 34;
constexpr int kSeg4Smem = kLut4Bytes + kWarps * kTileBytes + kMv4Words * 4
                          + 2 * 4 * 256;

template <int kStage, int kSets>
__global__ void __launch_bounds__(kThreads)
huffdec_block_kernel(const uint32_t* __restrict__ words, int W,
                     const int32_t* __restrict__ bstart, int bps, int L,
                     const int32_t* __restrict__ nblocks,
                     const int32_t* __restrict__ dc_sel,
                     const int32_t* __restrict__ ac_sel, int bpm,
                     uint32_t dc_pat, uint32_t ac_pat,
                     const int32_t* __restrict__ tables,
                     const uint32_t* __restrict__ lut_g, bool vec,
                     int16_t* __restrict__ coefs,
                     int32_t* __restrict__ err_out) {
    constexpr int kW = kWarps, kT = kThreads;
    uint32_t* lut;
    int16_t* tiles;
    // the canonical tables: two sets as they come (int32[290] a table),
    // four packed (gj::Packed, 34 words and 256 bytes a table)
    int32_t* tab;
    uint8_t* hv = nullptr;
    if constexpr (kSets == 2) {
        __shared__ int32_t s_tab[gj::kTablesWords<2>];
        __shared__ __align__(16) uint32_t s_lut[2 * 2 * kLutSize];
        __shared__ __align__(16) int16_t s_tiles[kW * 64 * kTile];
        lut = s_lut;
        tiles = s_tiles;
        tab = s_tab;
    } else {
        extern __shared__ __align__(16) unsigned char dyn[];
        lut = reinterpret_cast<uint32_t*>(dyn);
        tiles = reinterpret_cast<int16_t*>(dyn + kLut4Bytes);
        tab = reinterpret_cast<int32_t*>(dyn + kLut4Bytes + kW * kTileBytes);
        hv = reinterpret_cast<uint8_t*>(tab + kMv4Words);
    }
    for (int i = threadIdx.x; i < 2 * kSets * kLutSize / 4; i += kT)
        reinterpret_cast<uint4*>(lut)[i] =
            __ldg(reinterpret_cast<const uint4*>(lut_g) + i);
    for (int i = threadIdx.x; i < kW * 64 * kTile / 8; i += kT)
        reinterpret_cast<uint4*>(tiles)[i] = make_uint4(0, 0, 0, 0);
    if constexpr (kSets == 2) {
        gj::load_tables<2>(tables, tab);       // ends in __syncthreads()
    } else {
        for (int i = threadIdx.x; i < 8 * gj::kTableWords; i += kT) {
            const int t = i / gj::kTableWords, w = i - t * gj::kTableWords;
            const int32_t x = __ldg(tables + i);
            if (w < 34)
                tab[t * 34 + w] = x;
            else
                hv[t * 256 + w - 34] = (uint8_t)x;
        }
        __syncthreads();
    }
    // the canonical decode of table i
    auto canon = [&](int i) {
        if constexpr (kSets == 2)
            return Wide{tab + i * gj::kTableWords};
        else
            return gj::Packed{tab + i * 34, hv + i * 256};
    };

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int16_t* tile = tiles + warp * 64 * kTile;
    // shared-window addresses, computed once: the tables, and this lane's
    // column of its warp's tile
    const uint32_t lut_s = pinned(shared_addr(lut));
    const uint32_t col_s = pinned(shared_addr(tile) + 2u * lane);
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
            const int32_t* bs = bstart + (int64_t)s * (bps + 1) + j;
            const int cursor = __ldg(bs);
            const int bend = __ldg(bs + 1);
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
                if (kStage == gj::kLoadStore) {    // the loads alone
                    bad = bw.buf == 0x9E3779B97F4A7C15ull;
                } else {
                    bad = decode_block(
                        bw, jq, cursor, bend,
                        pinned(lut_s + dcls * (4 * kLutSize)),
                        pinned(lut_s + acls * (4 * kLutSize)), canon(dcls),
                        canon(acls),
                        col_s);
                }
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
        store_tile<kStage>(tile, coefs, err_out, L, b0, lane, vec, bad);
        __syncwarp();
    }
}

template <int kStage, int kSets>
int run(const void* words, int64_t nseg, int W, const void* bstart, int bps,
        const void* nblocks, const void* dc_sel, const void* ac_sel,
        int bpm, int dc_pat, int ac_pat, const void* tables, const void* lut,
        void* coefs, void* err, void* stream) {
    const int64_t L = nseg * bps;
    auto* kernel = huffdec_block_kernel<kStage, kSets>;
    const int smem = kSets == 2 ? 0 : kSeg4Smem;
    const int fit = gj::resident_ctas(kernel, kThreads, smem);
    if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
    const int64_t want = ((L + kTile - 1) / kTile + kWarps - 1) / kWarps;
    const int grid = want < fit ? (int)want : fit;
    const bool vec = L % 8 == 0 && ((uintptr_t)coefs & 15) == 0;
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)bstart, bps, (int)L,
        (const int32_t*)nblocks, (const int32_t*)dc_sel,
        (const int32_t*)ac_sel, bpm, (uint32_t)dc_pat, (uint32_t)ac_pat,
        (const int32_t*)tables, (const uint32_t*)lut, vec, (int16_t*)coefs,
        (int32_t*)err);
    return (int)cudaGetLastError();
}

// the segment-row instance of (stage, table sets), or nullptr
template <int kSets>
decltype(&run<gj::kFull, 2>) instance(int stage) {
    return stage == gj::kFull ? run<gj::kFull, kSets>
        : stage == gj::kLoadStore ? run<gj::kLoadStore, kSets>
        : stage == gj::kNoStore ? run<gj::kNoStore, kSets> : nullptr;
}

int launch(int stage, const void* words, int64_t nseg, int W,
           const void* bstart, int bps, const void* nblocks,
           const void* dc_sel, const void* ac_sel, int bpm, int dc_pat,
           int ac_pat, int nsets, const void* tables, const void* lut,
           void* coefs, void* err, void* stream) {
    // words: (nseg, W) host-order u32 rows, 4-byte aligned, 32 W < 2^31;
    // bstart: (nseg, bps+1) i32 with entries in [0, 32 W]; nblocks,
    // dc_sel, ac_sel: (nseg,) i32; bpm, dc_pat, ac_pat: the slot pattern,
    // nsets: 2 or 4 table sets (huffdec.cuh); tables: (2 nsets, 290) i32;
    // lut: (2 nsets, 512) i32 (ops/huffdec_kernel.block_lut), 16-byte
    // aligned; coefs: (64, nseg*bps) i16; err: (nseg*bps,) i32
    const int64_t L = nseg * bps;
    if (L > INT_MAX / 2 || ((uintptr_t)lut & 15)
            || (int64_t)W * 32 > INT_MAX)
        return (int)cudaErrorInvalidValue;
    if (L <= 0) return (int)cudaGetLastError();
    const auto fn = nsets == 2 ? instance<2>(stage)
        : nsets == 4 ? instance<4>(stage) : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(words, nseg, W, bstart, bps, nblocks, dc_sel, ac_sel, bpm,
              dc_pat, ac_pat, tables, lut, coefs, err, stream);
}

// -- the direct instance ----------------------------------------------------

constexpr int kDirBits = 11;          // huffdec_kernel.DIRECT_LUT_BITS
constexpr int kSubBits = 16 - kDirBits;
// direct_entry layout (ops/huffdec_kernel.direct_entry): code length,
// advance, DIRECT_SPECIAL, DIRECT_SUB, run
constexpr uint32_t kDirSpecial = 1u << 10, kDirSub = 1u << 11;
constexpr uint32_t kDirRare = kDirSpecial | kDirSub;
// the widest rows staged in shared memory (wider ones read global memory)
constexpr int kMaxStagedW = 1024;

__device__ __forceinline__ uint32_t shr_clamped(uint32_t x, uint32_t n) {
    uint32_t y;                        // PTX clamps shifts past 32 to 32
    asm("shr.b32 %0, %1, %2;" : "=r"(y) : "r"(x), "r"(n));
    return y;
}

// the first-level entry of a 32-bit peek in the table at shared address t
__device__ __forceinline__ uint32_t direct_first(uint32_t t, uint32_t peek) {
    return ld_shared_u16(t + ((peek >> (32 - kDirBits)) << 1));
}

// the second-level entry of a peek whose first-level entry e has kDirSub
__device__ __forceinline__ uint32_t direct_second(uint32_t t, uint32_t e,
                                                  uint32_t peek) {
    const uint32_t i = (1u << kDirBits) + ((e & 511u) << kSubBits)
                       + ((peek >> 16) & ((1u << kSubBits) - 1));
    return ld_shared_u16(t + (i << 1));
}

// the sign-extended value (T.81 F.2.2.1) of the value bits after a
// clen-bit code at the top of a peek, the token advancing adv bits in all;
// 0 when it has no value bits
__device__ __forceinline__ int direct_value(uint32_t peek, int clen,
                                            int adv) {
    const uint32_t x = peek << clen;
    const uint32_t rsh = 32 + clen - adv;       // 32 - size
    const int vu = (int)shr_clamped(x, rsh);
    // a value whose top bit is 0 is negative: vu - (2^size - 1)
    return vu - (int)(shr_clamped(0xFFFFFFFFu, rsh) & ~((int32_t)x >> 31));
}

// a row staged in shared memory (byte address a of its word 0), or read
// from global memory (zeros past its W words): word i as stored; raw_if
// loads it into v only where p holds (a predicated load, no branch)
struct StagedRow {
    uint32_t a;
    __device__ __forceinline__ uint32_t raw(int i) const {
        return ld_shared_u32(a + 4u * i);
    }
    __device__ __forceinline__ void raw_if(bool p, int i,
                                           uint32_t& v) const {
        asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
                     "@p ld.shared.u32 %0, [%1];\n\t}"
                     : "+r"(v) : "r"(a + 4u * i), "r"((uint32_t)p));
    }
};

struct GlobalRow {
    const uint32_t* r;
    int W;
    __device__ __forceinline__ uint32_t raw(int i) const {
        return i < W ? __ldg(r + i) : 0u;
    }
    __device__ __forceinline__ void raw_if(bool p, int i,
                                           uint32_t& v) const {
        if (p) v = raw(i);
    }
};

__device__ __forceinline__ uint32_t swapped(uint32_t w) {
    return __byte_perm(w, 0, 0x0123);
}

// One block of a direct row from bit 0 up to bit bend, with the DC and AC
// tables at shared addresses tdc, tac: its nonzero coefficients into this
// lane's column of the warp's tile (col_s); true when the block is bad.
// A token's common case takes one table load and no branch but the
// loop's; its second-level load, an end of block, an error and
// coefficient 63 go to one branch that few tokens take.  Bits past bend
// never change a result (a token that reads them is bad whatever they
// hold), so the window reads any word a row is followed by.
template <int kStage, class Row>
__device__ __forceinline__ bool direct_block(const Row& row, int bend,
                                             uint32_t tdc, uint32_t tac,
                                             uint32_t col_s) {
    uint32_t hi = swapped(row.raw(0)), lo = swapped(row.raw(1));
    uint32_t nx = row.raw(2);              // swapped when it moves to lo
    if (kStage == gj::kLoadStore)          // the loads alone
        return (hi ^ lo ^ nx) == 0x9E3779B9u && bend == 7;
    // DC token (at most 31 bits: the window needs no move)
    uint32_t e = direct_first(tdc, hi);
    if (e & kDirSub) e = direct_second(tdc, e, hi);
    int clen = (int)(e & 31u), adv = (int)((e >> 5) & 31u);
    if ((e & kDirSpecial) || adv > bend) return true;
    int v = direct_value(hi, clen, adv);
    st_shared_u16(col_s, v);               // a zero lands on a zero
    if (adv == bend) return false;         // the block ends after its DC
    int rem = bend - adv, sh = adv, k = 1, next = 3;
    // AC tokens
    while (true) {
        const uint32_t peek = __funnelshift_l(lo, hi, sh);
        e = direct_first(tac, peek);
        int coef = k + (int)(e >> 12);
        clen = (int)(e & 31u);
        adv = (int)((e >> 5) & 31u);
        if ((e & kDirRare) || coef >= 63 || adv > rem) {
            if (e & kDirSub) {
                e = direct_second(tac, e, peek);
                coef = k + (int)(e >> 12);
                clen = (int)(e & 31u);
                adv = (int)((e >> 5) & 31u);
            }
            if (adv > rem || coef > 63 || ((e & kDirSpecial) && clen == 0))
                return true;               // overrun, run past 63, invalid
            if (e & kDirSpecial) return false;          // end of block
            if (coef == 63) {
                st_shared_u16(col_s + coef * (2 * kTile),
                              direct_value(peek, clen, adv));
                return false;
            }
        }
        // an EOB-free token: its value (0 for a ZRL, which lands on a
        // zero) at coefficient coef
        st_shared_u16(col_s + coef * (2 * kTile),
                      direct_value(peek, clen, adv));
        rem -= adv;
        k = coef + 1;
        // crossing a word: the window moves down a word, with selects and
        // a predicated load, no branch
        sh += adv;
        const bool cross = sh >= 32;
        sh -= cross ? 32 : 0;
        hi = cross ? lo : hi;
        lo = cross ? swapped(nx) : lo;
        row.raw_if(cross, next, nx);
        next += cross;
    }
}

// the bytes of one tile buffer of rows at word stride Wp (4 words of
// slack after the last row: a lane reads up to word W + 2 of its row)
__host__ __device__ constexpr int stage_bytes(int Wp) {
    return (4 * (32 * Wp + 4) + 15) / 16 * 16;
}

// dynamic shared memory of a direct launch: the table sets' tables, then
// each warp's tile and its kBufs buffers of rows (none: global memory)
__host__ __device__ constexpr int direct_smem(int lut_bytes, int Wp,
                                              int kBufs) {
    return lut_bytes + kWarps * (kTileBytes + kBufs * stage_bytes(Wp));
}

// lut: (2 kSets, stride) i16 (ops/huffdec_kernel.direct_lut), lut_bytes
// of it, a multiple of 16.  kBufs: 2, tile t + 1's rows staged while tile
// t decodes; 1, each tile's rows staged before it decodes, a third less
// shared memory a warp where that lets more warps reside; 0, rows too
// wide to stage, read from global memory.
template <int kStage, int kSets, int kBufs>
__global__ void __launch_bounds__(kThreads)
huffdec_direct_kernel(const uint32_t* __restrict__ words, int W, int Wp,
                      const int32_t* __restrict__ nbits, int L,
                      const int32_t* __restrict__ nblocks,
                      const int32_t* __restrict__ dc_sel,
                      const int32_t* __restrict__ ac_sel,
                      uint32_t dc_pat, uint32_t ac_pat,
                      const uint4* __restrict__ lut_g, int stride,
                      int lut_bytes, bool vec, int16_t* __restrict__ coefs,
                      int32_t* __restrict__ err_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    for (int i = threadIdx.x; i < lut_bytes / 16; i += kThreads)
        reinterpret_cast<uint4*>(smem)[i] = __ldg(lut_g + i);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int buf_bytes = kBufs ? stage_bytes(Wp) : 0;
    unsigned char* mine = smem + lut_bytes
                          + warp * (kTileBytes + kBufs * buf_bytes);
    int16_t* tile = reinterpret_cast<int16_t*>(mine);
    for (int i = lane; i < kTileBytes / 16; i += 32)
        reinterpret_cast<uint4*>(tile)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();

    const uint32_t lut_s = pinned(shared_addr(smem));
    const uint32_t col_s = pinned(shared_addr(tile) + 2u * lane);
    const uint32_t buf0 = shared_addr(mine + kTileBytes);
    const int ntiles = (L + kTile - 1) / kTile;
    const int stride_t = gridDim.x * kWarps;
    // staging: word lane + 32 m of a tile's contiguous rows is word c of
    // row r; (r, c) start at divmod(lane, W) and step by divmod(32, W)
    int r_l = 0, c_l = 0, q = 0, rem = 0;
    if (kBufs) {
        r_l = lane / W;
        c_l = lane - r_l * W;
        q = 32 / W;
        rem = 32 - q * W;
    }
    auto stage = [&](int tt, uint32_t buf) {
        const int64_t r0 = (int64_t)tt * kTile;
        const int nw = (L - r0 < kTile ? (int)(L - r0) : kTile) * W;
        const uint32_t* src = words + r0 * W;
        int r = r_l, c = c_l;
        for (int w = lane; w < nw; w += 32) {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                         :: "r"(buf + 4u * (r * Wp + c)), "l"(src + w)
                         : "memory");
            r += q;
            c += rem;
            if (c >= W) {
                c -= W;
                ++r;
            }
        }
    };
    int t = blockIdx.x * kWarps + warp;
    int cur = 0;
    if (kBufs == 2) {
        if (t < ntiles) stage(t, buf0);
        gj::cp_async_commit();
    }
    for (; t < ntiles; t += stride_t) {
        if (kBufs == 2) {       // tile t + stride_t's rows into the other
            const int tn = t + stride_t;          // buffer, then wait for
            if (tn < ntiles) stage(tn, buf0 + (cur ^ 1) * buf_bytes);
            gj::cp_async_commit();                // tile t's
            gj::cp_async_wait<1>();
            __syncwarp();
        } else if (kBufs == 1) {
            stage(t, buf0);
            gj::cp_async_commit();
            gj::cp_async_wait<0>();
            __syncwarp();
        }
        const int b = t * kTile + lane;
        bool bad = false;
        if (b < L) {
            const int bend = __ldg(nbits + b);
            const int nb = __ldg(nblocks + b);
            const int dsel = __ldg(dc_sel + b), asel = __ldg(ac_sel + b);
            if (nb > 0) {
                const int dcls = gj::set_of<kSets>(dsel, dc_pat, 0);
                const int acls = kSets + gj::set_of<kSets>(asel, ac_pat, 0);
                const uint32_t tdc = pinned(lut_s + dcls * (2 * stride));
                const uint32_t tac = pinned(lut_s + acls * (2 * stride));
                if constexpr (kBufs > 0)
                    bad = direct_block<kStage>(
                        StagedRow{buf0 + cur * buf_bytes + 4u * lane * Wp},
                        bend, tdc, tac, col_s);
                else
                    bad = direct_block<kStage>(
                        GlobalRow{words + (int64_t)b * W, W}, bend, tdc,
                        tac, col_s);
            }
        }
        __syncwarp();
        store_tile<kStage>(tile, coefs, err_out, L, t * kTile, lane, vec,
                           bad);
        __syncwarp();            // every lane is done with its buffer
        if (kBufs == 2) cur ^= 1;
    }
    if (kBufs) gj::cp_async_wait<0>();
}

// a direct launch with kBufs row buffers a warp; -1 when it does not fit
// shared memory
template <int kStage, int kSets, int kBufs>
int run_direct(const void* words, int64_t nseg, int W, const void* nbits,
               const void* nblocks, const void* dc_sel, const void* ac_sel,
               int dc_pat, int ac_pat, const void* lut, int stride,
               void* coefs, void* err, void* stream) {
    auto* kernel = huffdec_direct_kernel<kStage, kSets, kBufs>;
    const int Wp = W | 1;                  // an odd word stride
    const int lut_bytes = 2 * kSets * stride * 2;
    const int smem = direct_smem(lut_bytes, Wp, kBufs);
    const int fit = gj::resident_ctas(kernel, kThreads, smem);
    if (fit <= 0) return -1;
    const int64_t want = ((nseg + kTile - 1) / kTile + kWarps - 1) / kWarps;
    const int grid = want < fit ? (int)want : fit;
    const bool vec = nseg % 8 == 0 && ((uintptr_t)coefs & 15) == 0;
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, Wp, (const int32_t*)nbits, (int)nseg,
        (const int32_t*)nblocks, (const int32_t*)dc_sel,
        (const int32_t*)ac_sel, (uint32_t)dc_pat, (uint32_t)ac_pat,
        (const uint4*)lut, stride, lut_bytes, vec, (int16_t*)coefs,
        (int32_t*)err);
    return (int)cudaGetLastError();
}

// CTAs an SM of a direct launch with kBufs buffers (0 when it does not
// fit)
template <int kStage, int kSets, int kBufs>
int direct_ctas(int W, int stride) {
    return gj::resident_ctas(huffdec_direct_kernel<kStage, kSets, kBufs>,
                             kThreads,
                             direct_smem(2 * kSets * stride * 2, W | 1,
                                         kBufs));
}

// Double-buffered rows, or single-buffered where that lets more CTAs
// reside (rows of W <= kMaxStagedW; the probe stages take the same
// choice), or, for wider rows or where none fits, rows from global memory
// (the full stage only).
template <int kStage, int kSets>
int direct_stage(const void* words, int64_t nseg, int W, const void* nbits,
                 const void* nblocks, const void* dc_sel, const void* ac_sel,
                 int dc_pat, int ac_pat, const void* lut, int stride,
                 void* coefs, void* err, void* stream) {
    if (W <= kMaxStagedW) {
        const int two = direct_ctas<kStage, kSets, 2>(W, stride);
        const int one = direct_ctas<kStage, kSets, 1>(W, stride);
        const int rc = one > two
            ? run_direct<kStage, kSets, 1>(words, nseg, W, nbits, nblocks,
                                           dc_sel, ac_sel, dc_pat, ac_pat,
                                           lut, stride, coefs, err, stream)
            : run_direct<kStage, kSets, 2>(words, nseg, W, nbits, nblocks,
                                           dc_sel, ac_sel, dc_pat, ac_pat,
                                           lut, stride, coefs, err, stream);
        if (rc >= 0) return rc;
    }
    if (kStage != gj::kFull) return (int)cudaErrorInvalidValue;
    const int rc = run_direct<gj::kFull, kSets, 0>(
        words, nseg, W, nbits, nblocks, dc_sel, ac_sel, dc_pat, ac_pat, lut,
        stride, coefs, err, stream);
    return rc >= 0 ? rc : (int)cudaErrorInvalidConfiguration;
}

template <int kSets>
decltype(&direct_stage<gj::kFull, 2>) direct_instance(int stage) {
    return stage == gj::kFull ? direct_stage<gj::kFull, kSets>
        : stage == gj::kLoadStore ? direct_stage<gj::kLoadStore, kSets>
        : stage == gj::kNoStore ? direct_stage<gj::kNoStore, kSets>
        : nullptr;
}

int launch_direct(int stage, const void* words, int64_t nseg, int W,
                  const void* nbits, const void* nblocks, const void* dc_sel,
                  const void* ac_sel, int bpm, int dc_pat, int ac_pat,
                  int nsets, const void* lut, int stride, void* coefs,
                  void* err, void* stream) {
    // words: (nseg, W) host-order u32 rows, 4-byte aligned, 32 W < 2^31;
    // nbits: (nseg,) i32 in [0, 32 W]; nblocks, dc_sel, ac_sel: (nseg,)
    // i32; bpm, dc_pat, ac_pat: the slot pattern (slot 0 alone is read),
    // nsets: 2 or 4 table sets; lut: (2 nsets, stride) i16
    // (ops/huffdec_kernel.direct_lut), 16-byte aligned, stride a multiple
    // of 8; coefs: (64, nseg) i16; err: (nseg,) i32
    (void)bpm;
    if (nseg > INT_MAX / 2 || ((uintptr_t)lut & 15) || W < 1
            || (int64_t)W * 32 > INT_MAX || stride < (1 << kDirBits)
            || stride % 8 || stride > (1 << 15))
        return (int)cudaErrorInvalidValue;
    if (nseg <= 0) return (int)cudaGetLastError();
    const auto fn = nsets == 2 ? direct_instance<2>(stage)
        : nsets == 4 ? direct_instance<4>(stage) : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(words, nseg, W, nbits, nblocks, dc_sel, ac_sel, dc_pat,
              ac_pat, lut, stride, coefs, err, stream);
}

}  // namespace

extern "C" int gj_huffdec_block(const void* words, int64_t nseg, int W,
                                const void* bstart, int bps,
                                const void* nblocks, const void* dc_sel,
                                const void* ac_sel, int bpm, int dc_pat,
                                int ac_pat, int nsets, const void* tables,
                                const void* lut, void* coefs, void* err,
                                void* stream) {
    return launch(gj::kFull, words, nseg, W, bstart, bps, nblocks, dc_sel,
                  ac_sel, bpm, dc_pat, ac_pat, nsets, tables, lut, coefs,
                  err, stream);
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
    return launch(stage, words, nseg, W, bstart, bps, nblocks, dc_sel,
                  ac_sel, bpm, dc_pat, ac_pat, nsets, tables, lut, coefs,
                  err, stream);
}

// the direct instance: slot s of row s from bit 0 to nbits[s]
extern "C" int gj_huffdec_block_direct(const void* words, int64_t nseg,
                                       int W, const void* nbits,
                                       const void* nblocks,
                                       const void* dc_sel,
                                       const void* ac_sel, int bpm,
                                       int dc_pat, int ac_pat, int nsets,
                                       const void* lut, int stride,
                                       void* coefs, void* err,
                                       void* stream) {
    return launch_direct(gj::kFull, words, nseg, W, nbits, nblocks, dc_sel,
                         ac_sel, bpm, dc_pat, ac_pat, nsets, lut, stride,
                         coefs, err, stream);
}

// the direct instance's probe stages, as gj_huffdec_block_probe's (rows
// staged in shared memory; loads and stores only stages them and loads
// every block's first three words)
extern "C" int gj_huffdec_block_direct_probe(int stage, const void* words,
                                             int64_t nseg, int W,
                                             const void* nbits,
                                             const void* nblocks,
                                             const void* dc_sel,
                                             const void* ac_sel, int bpm,
                                             int dc_pat, int ac_pat,
                                             int nsets, const void* lut,
                                             int stride, void* coefs,
                                             void* err, void* stream) {
    return launch_direct(stage, words, nseg, W, nbits, nblocks, dc_sel,
                         ac_sel, bpm, dc_pat, ac_pat, nsets, lut, stride,
                         coefs, err, stream);
}
