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
//   - the table sets a template argument: the two-set instance keeps
//     4.6 KB of tables and 16 KB of lookahead table in shared memory; the
//     four-set one 9.3 KB and 32 KB (41.3 KB static).
//
// At restart interval 0 a scan is one segment, so 1 to 3 threads walk
// whole scans (about 5 M tokens each at 8K 4:4:4 Q75), one token after
// another as the reference's CPU decoder does; nothing in the walk
// assumes a short row, and a segment that ends short of bps blocks
// stores its tail of bstart in the loop after the walk.  Bit cursors are
// int32: the wrapper refuses rows of 2^26 words or more.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "huffdec.cuh"

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

template <int kSets>
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
    __shared__ int32_t tab[gj::kTablesWords<kSets>];
    __shared__ __align__(16) uint16_t lut[2 * kSets * kLutSize];
    for (int i = threadIdx.x; i < 2 * kSets * kLutSize / 8; i += blockDim.x)
        reinterpret_cast<uint4*>(lut)[i] =
            __ldg(reinterpret_cast<const uint4*>(lut_g) + i);
    gj::load_tables<kSets>(tables, tab);     // ends in __syncthreads()
    // the table's shared-window address, computed once
    const uint32_t lut_s = (uint32_t)__cvta_generic_to_shared(lut);

    const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (s < nseg) {
        int32_t* out = bstart + s * (int64_t)(bps + 1);
        const int nbits = nbits_a[s];
        const int nb = nblocks_a[s];
        const int sdc = dc_sel[s], sac = ac_sel[s];
        gj::BitWindow bw;
        int j;
        bw.init(words + s * (int64_t)W, W, j);
        out[0] = 0;
        int cursor = 0, blk = 0, pos = 0, slot = 0;   // slot = blk % bpm
        bool bad = false;
        // a slot's tables (gj::set_of): with two sets each segment flag
        // folds into its mask once
        const uint32_t dm = kSets == 2 ? (sdc ? dc_pat : 0u) : dc_pat;
        const uint32_t am = kSets == 2 ? (sac ? ac_pat : 0u) : ac_pat;
        const int dsel = kSets == 2 ? 1 : sdc, asel = kSets == 2 ? 1 : sac;
        int dcls = gj::set_of<kSets>(dsel, dm, 0);
        int acls = kSets + gj::set_of<kSets>(asel, am, 0);
        while (blk < nb) {
            if (bw.n < 32) bw.refill(j);
            const bool is_dc = pos == 0;
            const int cls = is_dc ? dcls : acls;
            uint32_t e = ld_shared_u16(
                lut_s + 2u * ((uint32_t)(cls << kLutBits)
                              | (uint32_t)(bw.buf >> (64 - kLutBits))));
            int new_pos = pos + (int)((e >> kStepShift) & 63u);
            if (e == 0 || new_pos > 64) {
                int clen, sym;
                gj::decode_one(tab + cls * gj::kTableWords,
                           (int)(bw.buf >> 48), clen, sym);
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
                dcls = gj::set_of<kSets>(dsel, dm, slot);
                acls = kSets + gj::set_of<kSets>(asel, am, slot);
            } else {
                pos = new_pos;
            }
        }
        for (int b = blk + 1; b <= bps; ++b) out[b] = nbits;
        err[s] = bad || blk < nb;
    }
}

template <int kSets>
void run(const void* words, int64_t nseg, int W, const void* nbits,
         const void* nblocks, const void* dc_sel, const void* ac_sel,
         int bpm, int dc_pat, int ac_pat, const void* tables,
         const void* lut, int bps, void* bstart, void* err, void* stream) {
    const int64_t grid = (nseg + kThreads - 1) / kThreads;
    huffdec_scan_kernel<kSets><<<(unsigned)grid, kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const uint32_t*)words, nseg, W, (const int32_t*)nbits,
        (const int32_t*)nblocks, (const int32_t*)dc_sel,
        (const int32_t*)ac_sel, bpm, (uint32_t)dc_pat, (uint32_t)ac_pat,
        (const int32_t*)tables, (const uint16_t*)lut, bps, (int32_t*)bstart,
        (bool*)err);
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
    // bpm, dc_pat, ac_pat: the slot pattern, nsets: 2 or 4 table sets
    // (huffdec.cuh); tables: (2 nsets, 290) i32; lut: (2 nsets, 2048) u16
    // (ops/huffdec_kernel.scan_lut), 16-byte aligned; bstart: (nseg,
    // bps+1) i32; err: (nseg,) bool
    if ((nsets != 2 && nsets != 4) || (int64_t)W * 32 > INT_MAX)
        return (int)cudaErrorInvalidValue;
    if (nseg > 0 && nsets == 2)
        run<2>(words, nseg, W, nbits, nblocks, dc_sel, ac_sel, bpm, dc_pat,
               ac_pat, tables, lut, bps, bstart, err, stream);
    else if (nseg > 0)
        run<4>(words, nseg, W, nbits, nblocks, dc_sel, ac_sel, bpm, dc_pat,
               ac_pat, tables, lut, bps, bstart, err, stream);
    return (int)cudaGetLastError();
}
