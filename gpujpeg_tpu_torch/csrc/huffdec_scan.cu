// Huffman decode phase A for Hopper (sm_90a): the start bit of every block
// of every restart segment.
//
// Replaces the JAX package's Pallas boundary scan
// (gpujpeg_tpu/ops/huffdec_kernel.py: _scan_kernel_body, launched by
// make_scan_kernel).  On the TPU every segment is a vector lane that walks
// its tokens in lockstep with 1,023 others, refilling its window through
// a select chain over the row's words; here one thread walks one segment
// row, as the reference decoder does (gpujpeg_huffman_gpu_decoder.cu:
// 390-536).  A block's class comes from its segment's selectors and, in
// an interleaved scan, from the slot pattern of its MCU (huffdec.cuh),
// among two table sets or, in the kernel's second instance, four (T.81's
// table ids 0-3; the JAX package decodes such streams on its legacy
// path).  The tables are any baseline DHT tables: Annex K's, libjpeg's
// optimised ones, the tuned family (the JAX kernel's "generic" mode,
// _scan_kernel_body's generic branch).
//
// Semantics as _scan_kernel_body: bstart[s][0] = 0, bstart[s][b+1] is the
// bit cursor after block b, entries past the last decoded block hold
// nbits[s]; a token is bad when its code is invalid, its bits end past
// nbits[s], its coefficient index passes 63 or its new position passes
// 64, and err[s] is set on a bad token or when the segment ends short of
// nblocks[s] blocks.  The scan does not check a DC symbol above 15 (the
// block kernel does).  Every token advances the cursor, so the walk needs
// no step cap: the TPU loop's max_steps never binds.
//
// Bound: bytes.  At 8K Q75 the kernel reads the 25.7 MB word matrix and
// writes 7.0 MB of bstart, about 0.010 ms at 3.35 TB/s.  In practice it
// is bound by the serial walk: about 84 tokens a segment at 8K Q75, one
// after another, and the lanes of a warp diverge on their token counts.
// What the design cuts is what each step of the walk costs and how many
// steps there are:
//
//   - a lookahead table (ops/huffdec_kernel.scan_lut, built on the host)
//     indexed by class and the next SCAN_LUT_BITS = 11 bits: a DC entry is
//     one token, an AC entry the tokens that follow one another inside
//     the 11 bits, summed: the cursor's advance, the step of the block
//     position (a ZRL is a step of 16) and whether the last is an end of
//     block.  One 16-bit shared-memory load a step.  An
//     entry of 0 (a code longer than 11 bits, or an invalid one), or one
//     whose step would pass position 64, takes one token from the
//     canonical tables in shared memory instead (a binary search of the
//     code lengths).  A block never ends inside an entry but at its last
//     token, so position and index checks fold into one (a new position
//     past 64), and an overrun of nbits anywhere in an entry is the error
//     of its last token: no block boundary lies between.
//   - a register bit window (huffdec.cuh gj::BitWindow, shared with the
//     block kernel): 64 bits (MSB first) with at least 32 valid at each
//     step, refilled a 32-bit word at a time from a 16-byte quad held in
//     registers, the next quad loaded four words ahead.  Rows start at
//     any word (rows are W words apart); loads stay 16-byte aligned and
//     inside the aligned 16 bytes of a word the row owns, and words at
//     and past W read as 0, as the plain version's.
//   - bstart stored as the walk goes, a word at a time at a stride of bps
//     + 1 words between lanes: the L2 merges the lanes' stores; staging
//     a warp's rows in shared memory to store them coalesced was slower
//     on three of the four 8K paths (PERF.md, PR 8).  err is one byte a
//     lane, contiguous.
//   - the table sets an instance each, one walk (walk_row) over their
//     classes: the two-set instance keeps 4.6 KB of tables and 16 KB of
//     lookahead table in static shared memory, 6 CTAs of 8 warps an SM at
//     40 registers.  The four-set instances read dynamic shared memory
//     sized to the launch: the lookahead rows of the sets the stream uses
//     (24 KB for three sets, whose fourth is a copy of the third on the
//     decoder's plans and is never loaded; 32 KB for four) and the eight
//     canonical tables packed, their symbols as bytes (3.1 KB, huffdec.cuh
//     gj::Packed); a segment's selector is added to its slot pattern once
//     (add_fields), so the walk keeps the two-set instance's registers,
//     bounded to its 6 CTAs an SM.  Its prologue starts every copy at
//     once (the rows by cp.async, the tables by loads before their
//     stores), one round trip to L2 where a loop of loads and stores took
//     one a row and a word.  A three-set launch maps set 3 to a
//     zero row, so a block of set 3 (no plan makes one) still decodes,
//     each token through the canonical tables.  Before, one instance
//     held 9.3 KB of tables and 32 KB of lookahead table statically at 46
//     registers: 5 CTAs an SM, 6.5-11.4% slower than the two-set instance
//     on the same tokens (PERF.md).
//
// A thread walks a whole row, so a long row is a long serial walk: at
// restart interval 0 a scan is one segment (about 5 M tokens at 8K 4:4:4
// Q75) and 1 to 3 threads would walk whole scans.  Rows that long take
// the second instance below (gj_huffdec_scan_sync: a thread a
// subsequence of a row, joined where Huffman codes resynchronise), which
// ops/huffdec_kernel.scan_instance picks by the row's length; nothing in
// this walk assumes a short row, and a segment that ends short of bps
// blocks stores its tail of bstart in the loop after the walk.  Bit
// cursors are int32: the wrapper refuses rows of 2^26 words or more.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "huffdec.cuh"
#include "lookback.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLutBits = 11;          // huffdec_kernel.SCAN_LUT_BITS
constexpr int kLutSize = 1 << kLutBits;

// scan_entry layout (ops/huffdec_kernel.scan_entry): advance, step, EOB
constexpr uint32_t kStepShift = 5, kEob = 1u << 11;

__device__ __forceinline__ uint32_t entry_of(int clen, int sym, bool is_dc) {
    const uint32_t inc = is_dc ? 1u : (uint32_t)(sym >> 4) + 1u;
    const uint32_t eob = (!is_dc && sym == 0) ? kEob : 0u;
    return (uint32_t)(clen + (sym & 15)) | (inc << kStepShift) | eob;
}

__device__ __forceinline__ uint32_t ld_shared_u16(uint32_t addr) {
    unsigned short v;
    asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
    return v;
}

// The table classes of the two-set instance: a block's lookahead row is
// its canonical table's index (DC sets 0-1, AC 2-3); each segment flag
// folds into its mask once (gj::set_of)
struct TwoSets {
    const int32_t* tab;          // the 4 tables as they come
    uint32_t dm, am;
    __device__ __forceinline__ int dc(int slot) const {
        return gj::set_of<2>(1, dm, slot);
    }
    __device__ __forceinline__ int ac(int slot) const {
        return 2 + gj::set_of<2>(1, am, slot);
    }
    __device__ __forceinline__ void decode(int cls, bool, int, int p16,
                                           int& clen, int& sym) const {
        gj::decode_one(tab + cls * gj::kTableWords, p16, clen, sym);
    }
};

// (sel + field) & 3 in each 2-bit field of pat: a segment's four-set
// selector added to its slot pattern once (gj::set_of<4>)
__device__ __forceinline__ uint32_t add_fields(uint32_t pat, int sel) {
    constexpr uint32_t kLo = 0x55555555u;
    const uint32_t y = (uint32_t)(sel & 3) * kLo;
    return ((pat & kLo) + (y & kLo)) ^ (pat & ~kLo) ^ (y & ~kLo);
}

// The table classes of the four-set instance that loads the lookahead
// rows of sets 0 .. kLoad - 1 (DC rows 0 .. kLoad - 1, AC rows kLoad ..
// 2 kLoad - 1) and, when kLoad < 4, a zero row 2 kLoad for set 3, whose
// tokens then all take the canonical decode; the canonical tables of all
// eight, packed (gj::Packed)
template <int kLoad>
struct FourSets {
    const int32_t* mv;
    const uint8_t* hv;
    uint32_t dm, am;             // a slot's set (selector added), 2 bits
    __device__ __forceinline__ int dc(int slot) const {
        const int set = (int)((dm >> (2 * slot)) & 3u);
        return set < kLoad ? set : 2 * kLoad;
    }
    __device__ __forceinline__ int ac(int slot) const {
        const int set = (int)((am >> (2 * slot)) & 3u);
        return set < kLoad ? kLoad + set : 2 * kLoad;
    }
    __device__ __forceinline__ void decode(int, bool is_dc, int slot,
                                           int p16, int& clen,
                                           int& sym) const {
        const int t = is_dc ? (int)((dm >> (2 * slot)) & 3u)
                            : 4 + (int)((am >> (2 * slot)) & 3u);
        gj::Packed{mv + t * gj::kPackedWords, hv + t * 256}.decode(
            p16, clen, sym);
    }
};

// The walk of segment row s (a thread a row): its bstart (out, bps + 1
// entries) and err; the classes' lookahead rows at shared address lut_s
template <class Classes>
__device__ __forceinline__ void walk_row(const uint32_t* __restrict__ row,
                                         int W, int nbits, int nb, int bps,
                                         int bpm, const Classes& cls,
                                         uint32_t lut_s, int32_t* out,
                                         bool* err) {
    gj::BitWindow bw;
    int j;
    bw.init(row, W, j);
    out[0] = 0;
    int cursor = 0, blk = 0, pos = 0, slot = 0;   // slot = blk % bpm
    bool bad = false;
    int dcls = cls.dc(0), acls = cls.ac(0);
    while (blk < nb) {
        if (bw.n < 32) bw.refill(j);
        const bool is_dc = pos == 0;
        const int c = is_dc ? dcls : acls;
        uint32_t e = ld_shared_u16(
            lut_s + 2u * ((uint32_t)(c << kLutBits)
                          | (uint32_t)(bw.buf >> (64 - kLutBits))));
        int new_pos = pos + (int)((e >> kStepShift) & 63u);
        if (e == 0 || new_pos > 64) {
            int clen, sym;
            cls.decode(c, is_dc, slot, (int)(bw.buf >> 48), clen, sym);
            if (clen == 0) {
                bad = true;
                break;
            }
            e = entry_of(clen, sym, is_dc);
            new_pos = pos + (int)(e >> kStepShift & 63u);
        }
        const int adv = (int)(e & 31u);
        const int after = cursor + adv;
        if (after > nbits || new_pos > 64) {
            bad = true;
            break;
        }
        cursor = after;
        bw.buf <<= adv;
        bw.n -= adv;
        if ((e & kEob) || new_pos == 64) {
            ++blk;
            if (++slot == bpm) slot = 0;
            out[blk] = after;
            pos = 0;
            dcls = cls.dc(slot);
            acls = cls.ac(slot);
        } else {
            pos = new_pos;
        }
    }
    for (int b = blk + 1; b <= bps; ++b) out[b] = nbits;
    *err = bad || blk < nb;
}

// the two-set instance: 4.6 KB of tables and 16 KB of lookahead table in
// static shared memory
__global__ void __launch_bounds__(kThreads)
huffdec_scan_kernel(const uint32_t* __restrict__ words, int64_t nseg, int W,
                    const int32_t* __restrict__ nbits_a,
                    const int32_t* __restrict__ nblocks_a,
                    const int32_t* __restrict__ dc_sel,
                    const int32_t* __restrict__ ac_sel, int bpm,
                    uint32_t dc_pat, uint32_t ac_pat,
                    const int32_t* __restrict__ tables,
                    const uint16_t* __restrict__ lut_g, int bps,
                    int32_t* __restrict__ bstart, bool* __restrict__ err) {
    __shared__ int32_t tab[gj::kTablesWords<2>];
    __shared__ __align__(16) uint16_t lut[2 * 2 * kLutSize];
    for (int i = threadIdx.x; i < 2 * 2 * kLutSize / 8; i += blockDim.x)
        reinterpret_cast<uint4*>(lut)[i] =
            __ldg(reinterpret_cast<const uint4*>(lut_g) + i);
    gj::load_tables<2>(tables, tab);         // ends in __syncthreads()
    // the table's shared-window address, computed once
    const uint32_t lut_s = (uint32_t)__cvta_generic_to_shared(lut);

    const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (s < nseg)
        walk_row(words + s * (int64_t)W, W, nbits_a[s], nblocks_a[s], bps,
                 bpm, TwoSets{tab, dc_sel[s] ? dc_pat : 0u,
                              ac_sel[s] ? ac_pat : 0u},
                 lut_s, bstart + s * (int64_t)(bps + 1), err + s);
}

// The four-set instance, kLoad sets' lookahead rows (FourSets): from
// dynamic shared memory sized to the launch, the rows first (4 KB each),
// then the packed canonical tables; 6 CTAs of 8 warps an SM, as the
// two-set instance (kSetsCtas bounds its registers to 40)
constexpr int kSetsCtas = 6;
constexpr int kTableBatch = 4;   // table words a thread loads together
constexpr int kRowBytes = kLutSize * 2;
constexpr int kPackedBytes = 8 * (34 * 4 + 256);   // 8 gj::Packed tables
static_assert(kPackedBytes == 8 * (gj::kPackedWords * 4 + 256),
              "mono | valoff as int32 and 256 symbol bytes a table");

__host__ __device__ constexpr int sets_rows(int load) {
    return 2 * load + (load < 4 ? 1 : 0);
}
__host__ __device__ constexpr int sets_smem(int load) {
    return sets_rows(load) * kRowBytes + kPackedBytes;
}

// the 8 tables of src (int32[kTableWords] each) packed into mv (8 *
// kPackedWords int32) and hv (8 * 256 bytes), each thread issuing
// kTableBatch loads before their stores (a round trip to L2 a batch, not
// a word); ends in __syncthreads()
__device__ __forceinline__ void load_packed(const int32_t* __restrict__ src,
                                            int32_t* mv, uint8_t* hv) {
    constexpr int kWords = 8 * gj::kTableWords;
    for (int i0 = threadIdx.x; i0 < kWords; i0 += kTableBatch * kThreads) {
        int32_t x[kTableBatch];
#pragma unroll
        for (int b = 0; b < kTableBatch; ++b) {
            const int i = i0 + b * kThreads;
            x[b] = i < kWords ? __ldg(src + i) : 0;
        }
#pragma unroll
        for (int b = 0; b < kTableBatch; ++b) {
            const int i = i0 + b * kThreads;
            const int t = i / gj::kTableWords, w = i - t * gj::kTableWords;
            if (i >= kWords) break;
            if (w < gj::kPackedWords)
                mv[t * gj::kPackedWords + w] = x[b];
            else
                hv[t * 256 + w - gj::kPackedWords] = (uint8_t)x[b];
        }
    }
    __syncthreads();
}

template <int kLoad>
__global__ void __launch_bounds__(kThreads, kSetsCtas)
huffdec_scan_sets_kernel(const uint32_t* __restrict__ words, int64_t nseg,
                         int W, const int32_t* __restrict__ nbits_a,
                         const int32_t* __restrict__ nblocks_a,
                         const int32_t* __restrict__ dc_sel,
                         const int32_t* __restrict__ ac_sel, int bpm,
                         uint32_t dc_pat, uint32_t ac_pat,
                         const int32_t* __restrict__ tables,
                         const uint16_t* __restrict__ lut_g, int bps,
                         int32_t* __restrict__ bstart,
                         bool* __restrict__ err) {
    extern __shared__ __align__(16) unsigned char dyn[];
    constexpr int kVecs = kRowBytes / 16;      // 16-byte copies a row
    static_assert(kVecs == kThreads, "a copy a thread a row");
    uint4* rows = reinterpret_cast<uint4*>(dyn);
    const uint4* src = reinterpret_cast<const uint4*>(lut_g);
    // the rows by asynchronous copies, all in flight together: shared DC
    // row r < kLoad is set r's, AC row kLoad + r set r's
#pragma unroll
    for (int r = 0; r < 2 * kLoad; ++r) {
        const int g = r < kLoad ? r : 4 + r - kLoad;
        gj::cp_async<16>(rows + r * kVecs + threadIdx.x,
                         src + g * kVecs + threadIdx.x, true);
    }
    gj::cp_async_commit();
    if (kLoad < 4)
        rows[2 * kLoad * kVecs + threadIdx.x] = make_uint4(0, 0, 0, 0);
    int32_t* mv = reinterpret_cast<int32_t*>(dyn + sets_rows(kLoad)
                                             * kRowBytes);
    uint8_t* hv = reinterpret_cast<uint8_t*>(mv + 8 * gj::kPackedWords);
    gj::cp_async_wait<0>();
    load_packed(tables, mv, hv);             // ends in __syncthreads()
    const uint32_t lut_s = (uint32_t)__cvta_generic_to_shared(dyn);

    const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (s < nseg)
        walk_row(words + s * (int64_t)W, W, nbits_a[s], nblocks_a[s], bps,
                 bpm, FourSets<kLoad>{mv, hv, add_fields(dc_pat, dc_sel[s]),
                                      add_fields(ac_pat, ac_sel[s])},
                 lut_s, bstart + s * (int64_t)(bps + 1), err + s);
}

// ---- the sync instance: long segments, a thread a subsequence ---------
//
// The walk of a segment is cut into subsequences of sub_bits bits, one a
// thread.  A walk's state at a token boundary is (bit cursor, block
// position, slot in the MCU), or dead after a bad token; the walk of a
// subsequence from an entry state decodes up to the first token boundary
// at or past the subsequence's end and gives that exit state and the
// blocks that ended on the way.  Within its last bits a walk takes one
// token a step (an entry whose advance passes the end is decoded alone),
// so the exit is a function of the entry alone, and a walk from the true
// entry gives the true exit.
//
// A CTA takes kSyncThreads subsequences: its first kWarm threads replay
// the previous chunk's last kWarm subsequences, the rest are its own
// (kOwn).  Every thread first walks from a guess: position 0, slot 0, at
// lead bits before its subsequence (0 at the row's start).  Huffman codes
// resynchronise, so a walk begun at a wrong state soon falls onto the
// true token boundaries, positions and slots: within a few hundred bits
// in a scan of one component, a few thousand in an interleaved one (the
// slot), so the wrapper gives the latter a longer lead and longer
// subsequences (ops/huffdec_kernel.sync_schedule).  A guessed walk that
// meets a bad token starts again at the next bit; one past the segment's
// bits is dead.  Then, in rounds until no exit changes
// (__syncthreads_or), each thread whose predecessor's exit differs from
// its entry walks again from that exit; where its own exit changes and
// the next thread does not walk in the round, it walks the next
// subsequence too, and so on until an exit stands, so a change crosses
// many subsequences in one round.  The CTA's guess of its first own
// entry is then the warm threads' last exit, and its exit and block
// count hold if that guess does.
//
// Across CTAs a decoupled look-back in ticket order (an atomic counter,
// so that a CTA waits only on CTAs already running) resolves the chain: a
// CTA publishes (guess, exit, blocks) as an aggregate, then reads the
// records of up to 32 predecessors with one warp, composes the aggregates
// from the nearest inclusive record forward while each guess equals the
// exit before it, and so gets its true entry and the blocks before it.  A
// guess that differs is resolved by its own CTA, which walks from its
// true entry as a round does before it publishes; a stream that never
// resynchronises makes the chain serial, never wrong.  Last, each own
// thread walks once more from its entry and stores bstart at the index a
// prefix of the counts gives; the row's last CTA sets err (the true walk
// ended short of nblocks) and fills the entries after the last decoded
// block, and every CTA of the row a share of those past nblocks.
//
// Bound: bytes, as the serial instance's.  A token is walked about three
// times (a guessed walk with its lead, a round, the writing walk), by
// threads whose walks are serial chains of table loads; a row shorter
// than a few CTAs' subsequences leaves most of its threads idle, so
// scan_instance keeps the serial instance for rows under SYNC_MIN_WORDS.

constexpr int kSyncThreads = 256;     // subsequences a CTA, a thread each
constexpr int kWarm = 8;              // threads replaying the last chunk
constexpr int kOwn = kSyncThreads - kWarm;
constexpr int kRecWords = 16;         // a look-back record, int32 words
constexpr int kScratchHead = 16;      // the ticket, then the records
constexpr unsigned kLanes = 0xFFFFFFFFu;

// a walk's state: cursor, and meta = position | slot << 8, or dead; a
// guessed entry carries kGuessMeta, which no exit does
constexpr uint32_t kDeadMeta = 1u << 16;
constexpr uint32_t kGuessMeta = 1u << 17;

struct WalkState {
    int cur;
    uint32_t meta;
};

__device__ __forceinline__ bool same(WalkState a, WalkState b) {
    return a.cur == b.cur && a.meta == b.meta;
}

// a segment's constants in a walk
struct SegConsts {
    const uint32_t* row;
    int W, nbits, bpm;
    uint32_t dm, am;
    int dsel, asel;
};

// The walk of one subsequence: from st (an entry) up to the first token
// boundary at or past `end`; st becomes the exit.  Returns the blocks
// that end in the walk; with kWrite, block base + k (k-th of the walk)
// stores its end bit at out[base + k + 1] while base + k < nb.
template <int kSets, bool kWrite>
__device__ __forceinline__ int walk(WalkState& st, int end,
                                    const SegConsts& c, const int32_t* tab,
                                    uint32_t lut_s, int32_t* out, int base,
                                    int nb) {
    const bool guess = st.meta & kGuessMeta;
    if (guess && st.cur >= c.nbits) {             // a guess past the bits
        st = WalkState{0, kDeadMeta};
        return 0;
    }
    st.meta &= ~kGuessMeta;
    if ((st.meta & kDeadMeta) || st.cur >= end) return 0;
    int cursor = st.cur;
    int pos = (int)(st.meta & 127u), slot = (int)((st.meta >> 8) & 255u);
    gj::BitWindow bw;
    int j;
    bw.start_at(c.row, c.W, cursor, j);
    int dcls = gj::set_of<kSets>(c.dsel, c.dm, slot);
    int acls = kSets + gj::set_of<kSets>(c.asel, c.am, slot);
    int count = 0;
    bool bad = false;
    while (cursor < end) {
        if (bw.n < 32) bw.refill(j);
        const bool is_dc = pos == 0;
        const int cls = is_dc ? dcls : acls;
        uint32_t e = ld_shared_u16(
            lut_s + 2u * ((uint32_t)(cls << kLutBits)
                          | (uint32_t)(bw.buf >> (64 - kLutBits))));
        int new_pos = pos + (int)((e >> kStepShift) & 63u);
        bool invalid = false;
        if (e == 0 || new_pos > 64 || cursor + (int)(e & 31u) > end) {
            int clen, sym;
            gj::decode_one(tab + cls * gj::kTableWords,
                           (int)(bw.buf >> 48), clen, sym);
            invalid = clen == 0;
            e = entry_of(clen, sym, is_dc);
            new_pos = pos + (int)(e >> kStepShift & 63u);
        }
        const int adv = (int)(e & 31u);
        const int after = cursor + adv;
        if (!invalid && after > c.nbits) {
            bad = true;
            break;
        }
        if (invalid || new_pos > 64) {
            if (!guess) {
                bad = true;
                break;
            }
            // a guessed walk: on from the next bit at position 0, slot 0
            ++cursor;
            pos = slot = 0;
            dcls = gj::set_of<kSets>(c.dsel, c.dm, 0);
            acls = kSets + gj::set_of<kSets>(c.asel, c.am, 0);
            bw.start_at(c.row, c.W, cursor, j);
            continue;
        }
        cursor = after;
        bw.buf <<= adv;
        bw.n -= adv;
        if ((e & kEob) || new_pos == 64) {
            if (kWrite && base + count < nb) out[base + count + 1] = after;
            ++count;
            if (++slot == c.bpm) slot = 0;
            pos = 0;
            dcls = gj::set_of<kSets>(c.dsel, c.dm, slot);
            acls = kSets + gj::set_of<kSets>(c.asel, c.am, slot);
        } else {
            pos = new_pos;
        }
    }
    st = bad ? WalkState{0, kDeadMeta}
             : WalkState{cursor, (uint32_t)pos | ((uint32_t)slot << 8)};
    return count;
}

// exclusive scan of v over the CTA; *total gets the sum
__device__ __forceinline__ int cta_scan(int v, int* total, int* s_warp) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kLanes, incl, d);
        if (lane >= d) incl += up;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = lane < kSyncThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(kLanes, w, d);
            if (lane >= d) w += up;
        }
        if (lane < kSyncThreads / 32) s_warp[lane] = w;
    }
    __syncthreads();
    const int before = warp ? s_warp[warp - 1] : 0;
    *total = s_warp[kSyncThreads / 32 - 1];
    __syncthreads();
    return before + incl - v;
}

// record words: flag (0 none, 1 aggregate, 2 inclusive), then the
// aggregate's guess (cursor, meta), exit (cursor, meta) and blocks, then
// the inclusive exit (cursor, meta) and blocks before the next chunk
__device__ __forceinline__ void publish(int* rec, int flag, WalkState g,
                                        WalkState x, int blocks) {
    if (flag == 1) {
        __stcg(rec + 1, g.cur);
        __stcg(rec + 2, (int)g.meta);
        __stcg(rec + 3, x.cur);
        __stcg(rec + 4, (int)x.meta);
        __stcg(rec + 5, blocks);
    } else {
        __stcg(rec + 6, x.cur);
        __stcg(rec + 7, (int)x.meta);
        __stcg(rec + 8, blocks);
    }
    __threadfence();
    atomicExch(rec, flag);
}

// warp 0 of chunk k > 0: the true exit of chunk k - 1 and the blocks of
// the chunks before k, from the records of the row's chunks (recs)
__device__ __forceinline__ void look_back(const int* recs, int k,
                                          WalkState& E, int& B) {
    const int lane = threadIdx.x & 31;
    unsigned long long t_wait = 0;
    for (;;) {
        const int jr = k - 1 - lane;
        const int* r = recs + (int64_t)max(jr, 0) * kRecWords;
        const int f = jr >= 0 ? *(const volatile int*)r : 0;
        const unsigned incl = __ballot_sync(kLanes, jr >= 0 && f == 2);
        const unsigned none = __ballot_sync(kLanes, jr >= 0 && f == 0);
        if (incl) {
            const int i = __ffs(incl) - 1;
            if ((none & ((1u << i) - 1u)) == 0) {
                __threadfence();
                WalkState g{0, 0}, x{0, 0};
                int c = 0;
                if (lane < i) {
                    g = WalkState{__ldcg(r + 1), (uint32_t)__ldcg(r + 2)};
                    x = WalkState{__ldcg(r + 3), (uint32_t)__ldcg(r + 4)};
                    c = __ldcg(r + 5);
                } else if (lane == i) {
                    x = WalkState{__ldcg(r + 6), (uint32_t)__ldcg(r + 7)};
                    c = __ldcg(r + 8);
                }
                E.cur = __shfl_sync(kLanes, x.cur, i);
                E.meta = __shfl_sync(kLanes, x.meta, i);
                B = __shfl_sync(kLanes, c, i);
                bool ok = true;
                for (int m = i - 1; m >= 0; --m) {
                    const WalkState gm{__shfl_sync(kLanes, g.cur, m),
                                       __shfl_sync(kLanes, g.meta, m)};
                    const WalkState xm{__shfl_sync(kLanes, x.cur, m),
                                       __shfl_sync(kLanes, x.meta, m)};
                    const int cm = __shfl_sync(kLanes, c, m);
                    if (!same(E, gm)) {
                        ok = false;
                        break;
                    }
                    E = xm;
                    B += cm;
                }
                if (ok) return;
            }
        }
        __nanosleep(100);
        gj::stall_guard(t_wait);
    }
}

// a CTA's subsequences: each thread's entry, exit and blocks, and which
// threads walk in the current round
struct SyncCta {
    int en_cur[kSyncThreads], ex_cur[kSyncThreads], cnt[kSyncThreads];
    uint32_t en_meta[kSyncThreads], ex_meta[kSyncThreads];
    uint8_t walking[kSyncThreads];
};

template <int kSets>
__global__ void __launch_bounds__(kSyncThreads)
huffdec_scan_sync_kernel(const uint32_t* __restrict__ words, int W,
                         int nchunk, int sub_bits, int lead,
                         const int32_t* __restrict__ nbits_a,
                         const int32_t* __restrict__ nblocks_a,
                         const int32_t* __restrict__ dc_sel,
                         const int32_t* __restrict__ ac_sel, int bpm,
                         uint32_t dc_pat, uint32_t ac_pat,
                         const int32_t* __restrict__ tables,
                         const uint16_t* __restrict__ lut_g, int bps,
                         int32_t* __restrict__ bstart,
                         bool* __restrict__ err, int* __restrict__ scratch) {
    __shared__ int32_t tab[gj::kTablesWords<kSets>];
    __shared__ __align__(16) uint16_t lut[2 * kSets * kLutSize];
    __shared__ SyncCta q;
    __shared__ int s_warp[kSyncThreads / 32];
    __shared__ int s_ticket, s_base, s_redo;
    __shared__ WalkState s_entry;
    const int tid = threadIdx.x;
    if (tid == 0) s_ticket = atomicAdd(scratch, 1);
    for (int i = tid; i < 2 * kSets * kLutSize / 8; i += blockDim.x)
        reinterpret_cast<uint4*>(lut)[i] =
            __ldg(reinterpret_cast<const uint4*>(lut_g) + i);
    gj::load_tables<kSets>(tables, tab);     // ends in __syncthreads()
    const uint32_t lut_s = (uint32_t)__cvta_generic_to_shared(lut);
    const unsigned long long t_start = gj::global_ns();

    const int ticket = s_ticket;
    const int64_t s = ticket / nchunk;
    const int chunk = ticket % nchunk;
    int* const recs = scratch + kScratchHead + s * nchunk * kRecWords;
    int32_t* const out = bstart + s * (int64_t)(bps + 1);
    const int nb = nblocks_a[s];
    SegConsts c;
    c.row = words + s * (int64_t)W;
    c.W = W;
    c.nbits = nbits_a[s];
    c.bpm = bpm;
    const int sdc = dc_sel[s], sac = ac_sel[s];
    c.dm = kSets == 2 ? (sdc ? dc_pat : 0u) : dc_pat;
    c.am = kSets == 2 ? (sac ? ac_pat : 0u) : ac_pat;
    c.dsel = kSets == 2 ? 1 : sdc;
    c.asel = kSets == 2 ? 1 : sac;

    // entries past nblocks hold nbits: a share a chunk
    for (int64_t b = nb + 1 + (int64_t)chunk * kSyncThreads + tid; b <= bps;
         b += (int64_t)nchunk * kSyncThreads)
        out[b] = c.nbits;
    if (chunk == 0 && tid == 0) out[0] = 0;

    // thread k's subsequence ends at end_of(k); chunk 0 has no warm
    // threads, its first own thread starts at bit 0 in the true state
    const int64_t bits = (int64_t)W * 32;
    const int64_t sub0 = (int64_t)chunk * kOwn - kWarm;
    const auto end_of = [&](int k) {
        const int64_t hi = (sub0 + k + 1) * sub_bits;
        return (int)(hi < bits ? hi : bits);
    };
    const int first = chunk == 0 ? kWarm : 0;
    {
        const int64_t sub = sub0 + tid;
        const int64_t lo = sub < 0 ? 0 : sub * sub_bits;
        const int start = (int)(lo < bits ? lo : bits);
        const bool exact = chunk == 0 && tid == first;
        WalkState e = exact ? WalkState{0, 0u}
            : WalkState{start > lead ? start - lead : 0, kGuessMeta};
        q.en_cur[tid] = start;
        q.en_meta[tid] = exact ? 0u : kGuessMeta;
        int n = 0;
        if (tid >= first)
            n = walk<kSets, false>(e, end_of(tid), c, tab, lut_s, out, 0, 0);
        q.cnt[tid] = n;
        q.ex_cur[tid] = e.cur;
        q.ex_meta[tid] = e.meta;
    }
    __syncthreads();
    // a walking thread's walk from e, then the next subsequences' while
    // an exit changes and the next thread does not walk in the round
    const auto relax = [&](int k, WalkState e) {
        bool changed = false;
        for (int ahead = 0;; ++ahead) {
            if (ahead) atomicAdd(scratch + 3, 1);
            q.en_cur[k] = e.cur;
            q.en_meta[k] = e.meta;
            WalkState x = e;
            q.cnt[k] = walk<kSets, false>(x, end_of(k), c, tab, lut_s, out,
                                          0, 0);
            if (same(x, WalkState{q.ex_cur[k], q.ex_meta[k]})) break;
            q.ex_cur[k] = x.cur;
            q.ex_meta[k] = x.meta;
            changed = true;
            if (k + 1 >= kSyncThreads || q.walking[k + 1]) break;
            ++k;
            e = x;
        }
        return changed;
    };
    // rounds: each thread after `from` whose predecessor's exit differs
    // from its entry walks again
    const auto rounds = [&](int from) {
        for (int r = 1;; ++r) {
            const WalkState ne = tid > from
                ? WalkState{q.ex_cur[tid - 1], q.ex_meta[tid - 1]}
                : WalkState{q.en_cur[tid], q.en_meta[tid]};
            const bool w = tid > from
                && !same(ne, WalkState{q.en_cur[tid], q.en_meta[tid]});
            q.walking[tid] = w;
            __syncthreads();
            const bool changed = w && relax(tid, ne);
            if (!__syncthreads_or(changed)) {
                if (tid == 0) atomicAdd(scratch + 1, r);
                break;
            }
        }
    };
    rounds(first);
    const unsigned long long t_local = gj::global_ns();
    if (tid == 0) atomicMax(scratch + 4, (int)((t_local - t_start) / 1000));
    const bool own = tid >= kWarm;
    int blocks;
    int before = cta_scan(own ? q.cnt[tid] : 0, &blocks, s_warp);
    const WalkState guess{q.ex_cur[kWarm - 1], q.ex_meta[kWarm - 1]};
    const WalkState last{q.ex_cur[kSyncThreads - 1],
                         q.ex_meta[kSyncThreads - 1]};
    int* const rec = recs + (int64_t)chunk * kRecWords;
    if (chunk == 0) {
        if (tid == 0) {
            s_base = 0;
            publish(rec, 2, guess, last, blocks);
        }
    } else {
        if (tid == 0) publish(rec, 1, guess, last, blocks);
        if (tid < 32) {
            WalkState E;
            int B;
            look_back(recs, chunk, E, B);
            if (tid == 0) {
                s_entry = E;
                s_base = B;
                s_redo = !same(E, guess);
            }
        }
        q.walking[tid] = 0;
        __syncthreads();
        if (s_redo) {
            // the guess was wrong: walk from the true entry, then rounds
            if (tid == 0) atomicAdd(scratch + 2, 1);
            if (tid == kWarm) relax(kWarm, s_entry);
            __syncthreads();
            rounds(kWarm);
            before = cta_scan(own ? q.cnt[tid] : 0, &blocks, s_warp);
        }
        if (tid == 0)
            publish(rec, 2, guess, WalkState{q.ex_cur[kSyncThreads - 1],
                                              q.ex_meta[kSyncThreads - 1]},
                    s_base + blocks);
    }
    __syncthreads();
    const unsigned long long t_chain = gj::global_ns();
    if (tid == 0) atomicMax(scratch + 5, (int)((t_chain - t_local) / 1000));
    const int base = s_base + before;
    if (own && base < nb) {
        WalkState x{q.en_cur[tid], q.en_meta[tid]};
        walk<kSets, true>(x, end_of(tid), c, tab, lut_s, out, base, nb);
    }
    __syncthreads();
    if (tid == 0)
        atomicMax(scratch + 6, (int)((gj::global_ns() - t_chain) / 1000));
    if (chunk == nchunk - 1) {
        // the row's last chunk: err, and the entries the walk left
        const int total = s_base + blocks;
        if (tid == 0) err[s] = total < nb;
        for (int b = total + 1 + tid; b <= nb; b += kSyncThreads)
            out[b] = c.nbits;
    }
}

template <int kSets>
void run_sync(const void* words, int64_t nseg, int W, int nchunk,
              int sub_bits, int lead, const void* nbits,
              const void* nblocks, const void* dc_sel, const void* ac_sel,
              int bpm, int dc_pat, int ac_pat, const void* tables,
              const void* lut, int bps, void* bstart, void* err,
              void* scratch, void* stream) {
    huffdec_scan_sync_kernel<kSets><<<(unsigned)(nseg * nchunk),
                                      kSyncThreads, 0,
                                      (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, nchunk, sub_bits, lead,
        (const int32_t*)nbits, (const int32_t*)nblocks,
        (const int32_t*)dc_sel, (const int32_t*)ac_sel, bpm,
        (uint32_t)dc_pat, (uint32_t)ac_pat, (const int32_t*)tables,
        (const uint16_t*)lut, bps, (int32_t*)bstart, (bool*)err,
        (int*)scratch);
}

// the serial instance of `sets` table sets (2, or 3 and 4 of eight
// tables: FourSets<sets>) and its dynamic shared memory
using ScanKernel = void (*)(const uint32_t*, int64_t, int, const int32_t*,
                            const int32_t*, const int32_t*, const int32_t*,
                            int, uint32_t, uint32_t, const int32_t*,
                            const uint16_t*, int, int32_t*, bool*);

ScanKernel serial_instance(int sets, int& smem) {
    smem = 0;
    if (sets == 2) return huffdec_scan_kernel;
    if (sets != 3 && sets != 4) return nullptr;
    smem = sets_smem(sets);
    return sets == 3 ? huffdec_scan_sets_kernel<3>
                     : huffdec_scan_sets_kernel<4>;
}

}  // namespace

extern "C" int gj_huffdec_scan(const void* words, int64_t nseg, int W,
                               const void* nbits, const void* nblocks,
                               const void* dc_sel, const void* ac_sel,
                               int bpm, int dc_pat, int ac_pat, int nsets,
                               const void* tables, const void* lut, int bps,
                               void* bstart, void* err, void* stream) {
    // words: (nseg, W) host-order u32 rows, 4-byte aligned, 32 W < 2^31;
    // nbits, nblocks, dc_sel, ac_sel: (nseg,) i32 with nblocks <= bps;
    // bpm, dc_pat, ac_pat: the slot pattern (huffdec.cuh); nsets: 2 (4
    // tables), or 3 or 4 (8 tables: the sets whose lookahead rows the
    // launch loads, FourSets); tables: (4 or 8, 290) i32; lut: (4 or 8,
    // 2048) u16 (ops/huffdec_kernel.scan_lut), 16-byte aligned; bstart:
    // (nseg, bps+1) i32; err: (nseg,) bool
    int smem;
    const ScanKernel kernel = serial_instance(nsets, smem);
    if (kernel == nullptr || (int64_t)W * 32 > INT_MAX)
        return (int)cudaErrorInvalidValue;
    if (nseg > 0) {
        const int64_t grid = (nseg + kThreads - 1) / kThreads;
        kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
            (const uint32_t*)words, nseg, W, (const int32_t*)nbits,
            (const int32_t*)nblocks, (const int32_t*)dc_sel,
            (const int32_t*)ac_sel, bpm, (uint32_t)dc_pat,
            (uint32_t)ac_pat, (const int32_t*)tables, (const uint16_t*)lut,
            bps, (int32_t*)bstart, (bool*)err);
    }
    return (int)cudaGetLastError();
}

// The serial instance of nsets (gj_huffdec_scan's) as built: out[0]
// registers a thread, out[1] static shared bytes, out[2] local (spill)
// bytes a thread, out[3] the dynamic shared bytes of its launch, out[4]
// its CTAs an SM (the occupancy calculator); chip_smoke.py's record
extern "C" int gj_huffdec_scan_resources(int nsets, int* out) {
    int smem;
    const ScanKernel kernel = serial_instance(nsets, smem);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes fa;
    int ctas = 0;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                          kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    out[0] = fa.numRegs;
    out[1] = (int)fa.sharedSizeBytes;
    out[2] = (int)fa.localSizeBytes;
    out[3] = smem;
    out[4] = ctas;
    return 0;
}

extern "C" int gj_huffdec_scan_sync(const void* words, int64_t nseg, int W,
                                    const void* nbits, const void* nblocks,
                                    const void* dc_sel, const void* ac_sel,
                                    int bpm, int dc_pat, int ac_pat,
                                    int nsets, const void* tables,
                                    const void* lut, int bps, void* bstart,
                                    void* err, int sub_bits, int lead,
                                    void* scratch, void* stream) {
    // the arguments of gj_huffdec_scan, W >= 1; sub_bits (>= 32) and lead
    // (>= 0) the bits of a subsequence and of a guessed walk's lead
    // (ops/huffdec_kernel.sync_schedule); scratch: int32 [kScratchHead +
    // nseg * nchunk * kRecWords], nchunk the chunks of a row
    // (ops/huffdec_kernel.sync_chunks), zeroed here; after the launch its
    // words 1-3 hold the rounds of all CTAs, the CTAs that walked again
    // from a true entry their guess missed, and the subsequences walked by
    // running ahead; words 4-6 the longest CTA's local walks, look-back and
    // writing walk in microseconds
    if ((nsets != 2 && nsets != 4) || W < 1 || (int64_t)W * 32 > INT_MAX
            || sub_bits < 32 || lead < 0)
        return (int)cudaErrorInvalidValue;
    const int64_t nsub = ((int64_t)W * 32 + sub_bits - 1) / sub_bits;
    const int64_t nchunk = (nsub + kOwn - 1) / kOwn;
    if (nseg <= 0) return (int)cudaGetLastError();
    if (nseg * nchunk > INT_MAX) return (int)cudaErrorInvalidValue;
    const cudaError_t z = cudaMemsetAsync(
        scratch, 0, (size_t)(kScratchHead + nseg * nchunk * kRecWords) * 4,
        (cudaStream_t)stream);
    if (z != cudaSuccess) return (int)z;
    if (nsets == 2)
        run_sync<2>(words, nseg, W, (int)nchunk, sub_bits, lead, nbits,
                    nblocks, dc_sel, ac_sel, bpm, dc_pat, ac_pat, tables,
                    lut, bps, bstart, err, scratch, stream);
    else
        run_sync<4>(words, nseg, W, (int)nchunk, sub_bits, lead, nbits,
                    nblocks, dc_sel, ac_sel, bpm, dc_pat, ac_pat, tables,
                    lut, bps, bstart, err, scratch, stream);
    return (int)cudaGetLastError();
}
