// Token-row packer for Hopper (sm_90a): rows of Huffman tokens (right-
// aligned bits + bit lengths, one restart segment per row) -> stuffed byte
// rows.
//
// Replaces the JAX package's Pallas deep-stuff kernel
// (gpujpeg_tpu/ops/fusedpack.py: _deep_stuff_kernel_body, launched by
// make_deep_stuff_kernel through pack_stuff_fused / pack_stuff_fused_pre),
// the back end of its non-megakernel encode (interleaved subsampled scans,
// Annex-K tables).  On the TPU the tokens of a row were merged pairwise up
// a tree of in-place span doublings over sublanes, then padded, stuffed by
// a roll/select chain and given their marker, all under sticky capacities
// (l0, z_cap, w_out) that grew and recompiled on overflow.  Rows have a
// worst-case stride here (ops/fusedpack.pack_stride: the longest coding of
// each block slot's class, doubled for stuffing, plus the marker), so no
// row can overflow and the capacity protocol is gone.
//
// Input: bits and lens (R, T) int32, T % 4 == 0, lens[r][t] == 0 meaning no
// token, at most 27 bits a token, bits above a token's length ignored;
// markers (R,) int32, the second byte of the RST marker after row r (0 =
// none).  Output: rows (R, stride) u8 (bytes past a row's length
// unspecified), row_bytes (R,) i32, and needs[0] / needs[1] raised to the
// largest stuffed-zero count / row length (atomicMax; the caller zeroes
// needs).
//
// Bound: bytes.  At 8K 4:2:0 Q75 the kernel reads every length (199 MB:
// 129,600 rows of 384 int32 slots, about 60 of them tokens), the bits of
// only those 4-slot quads that hold a token, and writes the realised
// stream (about 7 MB).  The loads set its time: the scattered 16-byte
// bits reads cost DRAM traffic beyond their bytes (PERF.md, Findings).
//
// Design: the back end of huffman_segments.cu without its tokenizer, as
// in the reference GPUJPEG's warp-per-segment serialisation.  A persistent
// grid of 8-warp CTAs walks the rows, a row a warp; the warp codes its row
// in rounds of 32 quads (128 slots):
//   - loads: lane l takes quad l of the round, its 4 lengths in one
//     16-byte load, so a warp load reads 512 contiguous bytes; it loads the
//     quad's bits only when a length is not 0.  The lengths of the round
//     two ahead and the bits of the next round are in flight, in
//     registers, while a round is coded (across rows too), and a row's
//     marker with its first round (deeper cp.async rings in shared memory
//     were slower);
//   - placing: a lane masks its up to 4 tokens and sums their lengths; a
//     warp exclusive scan places each lane's tokens in the row, and each
//     is ORed MSB first into the warp's bit buffer in shared memory
//     (put_bits, bitbuf.cuh);
//   - stuffing: when the buffer holds more than kFlushWords whole words,
//     they go out through the warp-parallel stuffing of flush_bytes
//     (bitbuf.cuh, shared with huffman_segments.cu) and the partial last
//     word stays; at the row's end the 1-bit pad (F.1.2.3), the last
//     bytes, the unstuffed marker, then row_bytes.
// The stage template argument cuts the kernel for the decomposition probe
// (gj::Stage; gj_pack_stuff_rows_probe: kLoadStore is the loads alone,
// lengths and the bits of the quads that hold tokens, with nothing coded;
// kNoStore codes and stuffs but writes no byte); the codec's entry point,
// gj_pack_stuff_rows, always launches the full kernel.
//
// A warp walks a row, so one long row is a long serial walk: a scan coded
// as one segment (restart interval 0) takes the scan instance below
// (gj_pack_stuff_scan, chunks of the row a CTA), which
// ops/fusedpack.scan_rows launches.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bitbuf.cuh"
#include "lookback.cuh"
#include "tile.cuh"

namespace {

using gj::kAll;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQ = 1;                     // quads a lane a round
constexpr int kRoundQuads = 32 * kQ;
// a round adds at most 32 kQ quads x 4 tokens x 27 bits (108 kQ words)
constexpr int kRoundWords = 108 * kQ;
constexpr int kBufWords = 256;            // a warp's bit buffer
// the buffer is emptied when it holds more than this many whole words, so
// a round ends below word kFlushWords + 1 + kRoundWords and the pad at a
// row's end (after a round that left at most kFlushWords) stays inside
constexpr int kFlushWords = kBufWords - kRoundWords - 4;

// a round of a warp: row s, round c (quads c * kRoundQuads ..)
struct Round {
    int64_t s;
    int c;
};

template <int kStage>
__global__ void __launch_bounds__(kThreads)
pack_stuff_rows_kernel(const int32_t* __restrict__ bits,
                       const int32_t* __restrict__ lens, int64_t R, int T,
                       const int32_t* __restrict__ markers, int stride,
                       uint8_t* __restrict__ rows,
                       int32_t* __restrict__ row_bytes,
                       int32_t* __restrict__ needs) {
    __shared__ uint32_t bufs[kWarps][kBufWords];
    __shared__ int cta_needs[2];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t* const buf = bufs[warp];
    for (int i = lane; i < kBufWords; i += 32) buf[i] = 0;
    if (threadIdx.x < 2) cta_needs[threadIdx.x] = 0;
    __syncthreads();
    const int nq = T >> 2;                        // quads a row
    const int nc = nq ? (nq + kRoundQuads - 1) / kRoundQuads : 1;
    const int64_t rstep = (int64_t)gridDim.x * kWarps;
    const int4* const l4 = reinterpret_cast<const int4*>(lens);
    const int4* const b4 = reinterpret_cast<const int4*>(bits);
    const auto after = [&](Round u) {
        if (++u.c == nc) {
            u.c = 0;
            u.s += rstep;
        }
        return u;
    };
    // lane l's quads of round u: c * kRoundQuads + kQ * l + j
    const auto load_lens = [&](Round u, int4 (&lv)[kQ]) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
            const int q = u.c * kRoundQuads + kQ * lane + j;
            lv[j] = u.s < R && q < nq ? __ldg(l4 + u.s * nq + q)
                                      : make_int4(0, 0, 0, 0);
        }
    };
    const auto load_bits = [&](Round u, const int4 (&lv)[kQ],
                               int4 (&bv)[kQ]) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
            const int q = u.c * kRoundQuads + kQ * lane + j;
            bv[j] = (lv[j].x | lv[j].y | lv[j].z | lv[j].w)
                ? __ldg(b4 + u.s * nq + q) : make_int4(0, 0, 0, 0);
        }
    };
    const auto load_marker = [&](Round u) {
        return u.c == 0 && u.s < R ? __ldg(markers + u.s) : 0;
    };
    // the warp's largest stuffed-zero count and row length: needs gets
    // one atomicMax a CTA
    int max_nff = 0, max_len = 0;
    int pos = 0;                                  // bits in the buffer
    int outpos = 0, nff = 0;                      // row bytes, stuffed zeros
    uint32_t sink = 0;                            // the probe's loads
    Round cur{(int64_t)blockIdx.x * kWarps + warp, 0};
    Round nxt = after(cur);
    int4 l_cur[kQ], b_cur[kQ], l_nxt[kQ];
    load_lens(cur, l_cur);
    load_lens(nxt, l_nxt);
    int m_cur = load_marker(cur), m_nxt = load_marker(nxt);
    load_bits(cur, l_cur, b_cur);
    while (cur.s < R) {
        // the lengths two rounds ahead and the next round's bits fly while
        // this round is coded
        const Round nn = after(nxt);
        int4 l_nn[kQ], b_nxt[kQ];
        load_lens(nn, l_nn);
        const int m_nn = load_marker(nn);
        load_bits(nxt, l_nxt, b_nxt);
        if (kStage == gj::kLoadStore) {
#pragma unroll
            for (int j = 0; j < kQ; ++j)
                sink ^= (uint32_t)(l_cur[j].x + l_cur[j].y + l_cur[j].z
                                   + l_cur[j].w) + (uint32_t)(b_cur[j].x
                    ^ b_cur[j].y ^ b_cur[j].z ^ b_cur[j].w);
        } else {
            // lane l's tokens, masked, and their bits in all
            int n[4 * kQ];
            uint32_t v[4 * kQ];
            int mine = 0;
#pragma unroll
            for (int j = 0; j < kQ; ++j) {
                const int ls[4] = {l_cur[j].x, l_cur[j].y, l_cur[j].z,
                                   l_cur[j].w};
                const int bs[4] = {b_cur[j].x, b_cur[j].y, b_cur[j].z,
                                   b_cur[j].w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    n[4 * j + e] = ls[e];
                    v[4 * j + e] = (uint32_t)bs[e] & ((1u << ls[e]) - 1u);
                    mine += ls[e];
                }
            }
            int incl = mine;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int up = __shfl_up_sync(kAll, incl, d);
                if (lane >= d) incl += up;
            }
            int at = pos + incl - mine;
#pragma unroll
            for (int t = 0; t < 4 * kQ; ++t) {
                if (n[t]) {
                    gj::put_bits(buf, at, v[t], n[t]);
                    at += n[t];
                }
            }
            pos += __shfl_sync(kAll, incl, 31);
            __syncwarp();
            if ((pos >> 5) > kFlushWords) {       // whole words out
                uint8_t* const out = rows + cur.s * (int64_t)stride;
                const int nw = pos >> 5;
                gj::flush_bytes<kStage == gj::kFull>(buf, 4 * nw, out,
                                                     outpos, nff, lane);
                const uint32_t part = buf[nw];
                __syncwarp();
                for (int i = lane; i <= nw; i += 32) buf[i] = 0;
                __syncwarp();
                if (lane == 0) buf[0] = part;
                pos &= 31;
                __syncwarp();
            }
        }
        if (cur.c == nc - 1) {                    // the row's end
            uint8_t* const out = rows + cur.s * (int64_t)stride;
            if (pos & 7) {                        // F.1.2.3: 1-bits
                const int pl = 8 - (pos & 7);
                if (lane == 0) gj::put_bits(buf, pos, (1u << pl) - 1u, pl);
                pos += pl;
            }
            __syncwarp();
            const int nbytes = pos >> 3;
            gj::flush_bytes<kStage == gj::kFull>(buf, nbytes, out, outpos,
                                                 nff, lane);
            __syncwarp();
            for (int i = lane; i < (nbytes + 3) >> 2; i += 32) buf[i] = 0;
            if (m_cur) {                          // not stuffed; 0 = none
                if (lane == 0 && kStage == gj::kFull) {
                    out[outpos] = 0xFF;
                    out[outpos + 1] = (uint8_t)m_cur;
                }
                outpos += 2;
            }
            if (lane == 0) row_bytes[cur.s] = outpos;
            if (kStage == gj::kLoadStore && sink == 0x9E3779B9u)
                row_bytes[cur.s] = -1;            // keeps the loads
            max_nff = nff > max_nff ? nff : max_nff;
            max_len = outpos > max_len ? outpos : max_len;
            pos = outpos = nff = 0;
            __syncwarp();
        }
        if (nxt.c == 0) m_cur = m_nxt;            // a new row's marker
        m_nxt = m_nn;
        cur = nxt;
        nxt = nn;
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
            l_cur[j] = l_nxt[j];
            l_nxt[j] = l_nn[j];
            b_cur[j] = b_nxt[j];
        }
    }
    if (lane == 0) {
        atomicMax(&cta_needs[0], max_nff);
        atomicMax(&cta_needs[1], max_len);
    }
    __syncthreads();
    if (threadIdx.x < 2)
        atomicMax(&needs[threadIdx.x], cta_needs[threadIdx.x]);
}

// ---- the scan instance: one long row of dense tokens, many CTAs ------
//
// A scan coded as one segment (restart interval 0) is one row of millions
// of tokens (fusedpack.scan_rows).  The instance cuts it into chunks of
// kChunkTok tokens, a CTA each, kScanTok a thread, in ticket order (an
// atomic counter, so that a CTA waits only on CTAs already running):
//   1. a CTA scan of its tokens' bit counts, and a decoupled look-back
//      over the chunks' sums gives the chunk's first bit off (64-bit);
//   2. the chunk packs MSB first into a shared bit buffer that starts at
//      word off / 32: the bits of that word before off are the previous
//      chunk's last tokens, read again here (warp 0, 32 tokens a step
//      back), so no word is shared between CTAs and nothing is zeroed in
//      device memory; a thread ORs only its first and last words, and
//      stores the words between; the last chunk adds the 1-bit pad;
//   3. the chunk owns the whole words of its buffer (the last chunk, every
//      byte): a CTA scan of each thread's bytes plus its 0xFF count places
//      every byte, with a 0x00 after each 0xFF, in a shared staging row,
//      and a second look-back over the chunks' 0xFF counts gives the
//      staging row's place in the output, 4 (off / 32) + the 0xFF bytes
//      before; a 0xFF made across two chunks' tokens is whole in one
//      owned word;
//   4. the last chunk writes the unstuffed marker, row_bytes and needs.
// Records: int64 [bits flag, bits aggregate, bits inclusive, 0xFF flag,
// 0xFF aggregate, 0xFF inclusive, -, -] a chunk (flag 1 aggregate, 2
// inclusive), read back 32 chunks a step by warp 0.
//
// Bound: bytes.  The tokens' lengths and bits are read once (8 bytes a
// token; the previous chunk's last tokens again, up to 31 bits of them)
// and the stream written once.

constexpr int kScanThreads = 256;
constexpr int kScanTok = 16;                         // tokens a thread
constexpr int kChunkTok = kScanThreads * kScanTok;   // tokens a CTA
// the buffer: up to 31 bits of the previous chunk, 27 bits a token, the
// pad, a word of slack
constexpr int kChunkWords = (31 + kChunkTok * 27 + 7 + 31) / 32 + 1;
constexpr int kStageBytes = 8 * kChunkWords;         // every byte 0xFF
constexpr int kScanRec = 8;                          // int64 a record
constexpr int kScanHead = 8;                         // the ticket

// warp 0: the sum of the aggregates of the chunks before c from field
// fld (0: bits, 3: 0xFF bytes) of the records
__device__ __forceinline__ long long scan_look_back(const long long* recs,
                                                    int64_t c, int fld) {
    const int lane = threadIdx.x & 31;
    long long acc = 0;
    int64_t j = c - 1;
    unsigned long long t_wait = 0;
    for (;;) {
        const int64_t jr = j - lane;
        const long long* r = recs + (jr < 0 ? 0 : jr) * kScanRec + fld;
        const long long f = jr >= 0 ? *(const volatile long long*)r : 2;
        const unsigned incl = __ballot_sync(kAll, f == 2);
        const unsigned none = __ballot_sync(kAll, f == 0);
        const int i = incl ? __ffs(incl) - 1 : 32;
        const unsigned below = i == 32 ? kAll : (1u << i) - 1u;
        if ((none & below) == 0) {
            __threadfence();
            long long v = 0;
            if (lane < i)
                v = jr >= 0 ? __ldcg(r + 1) : 0;
            else if (lane == i)
                v = jr >= 0 ? __ldcg(r + 2) : 0;
#pragma unroll
            for (int d = 16; d >= 1; d >>= 1)
                v += __shfl_xor_sync(kAll, v, d);
            acc += v;
            if (i < 32) return acc;
            j -= 32;                              // 32 aggregates: on
        } else {
            __nanosleep(64);
            gj::stall_guard(t_wait);
        }
    }
}

__device__ __forceinline__ void scan_publish(long long* rec, int fld,
                                             long long flag, long long v) {
    __stcg(rec + fld + flag, v);
    __threadfence();
    atomicExch(reinterpret_cast<unsigned long long*>(rec + fld),
               (unsigned long long)flag);
}

// exclusive CTA scan of v; *total gets the sum
__device__ __forceinline__ int scan_cta(int v, int* total, int* s_warp) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kAll, incl, d);
        if (lane >= d) incl += up;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = lane < kScanThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(kAll, w, d);
            if (lane >= d) w += up;
        }
        if (lane < kScanThreads / 32) s_warp[lane] = w;
    }
    __syncthreads();
    const int before = warp ? s_warp[warp - 1] : 0;
    *total = s_warp[kScanThreads / 32 - 1];
    __syncthreads();
    return before + incl - v;
}

__global__ void __launch_bounds__(kScanThreads)
pack_stuff_scan_kernel(const int32_t* __restrict__ bits,
                       const int32_t* __restrict__ lens, int64_t n,
                       int64_t nchunk, int marker, uint8_t* __restrict__ out,
                       int32_t* __restrict__ row_bytes,
                       int32_t* __restrict__ needs,
                       long long* __restrict__ scratch) {
    __shared__ uint32_t buf[kChunkWords];
    __shared__ uint8_t stage[kStageBytes];
    __shared__ int s_warp[kScanThreads / 32];
    __shared__ long long s_off, s_ff;
    __shared__ int64_t s_chunk;
    const int tid = threadIdx.x, lane = tid & 31;
    if (tid == 0)
        s_chunk = (int64_t)atomicAdd(
            reinterpret_cast<unsigned long long*>(scratch), 1ull);
    for (int i = tid; i < kChunkWords; i += kScanThreads) buf[i] = 0;
    __syncthreads();
    const int64_t c = s_chunk;
    const bool last = c == nchunk - 1;
    long long* const recs = scratch + kScanHead;

    // 1. this thread's tokens, masked, and the chunk's first bit
    const int64_t t0 = c * kChunkTok + (int64_t)tid * kScanTok;
    int ln[kScanTok];
    uint32_t v[kScanTok];
    if (t0 + kScanTok <= n && ((uintptr_t)(lens + t0) & 15) == 0
            && ((uintptr_t)(bits + t0) & 15) == 0) {
#pragma unroll
        for (int q = 0; q < kScanTok / 4; ++q) {
            const int4 l4 = __ldg(reinterpret_cast<const int4*>(lens + t0)
                                  + q);
            const int4 b4 = __ldg(reinterpret_cast<const int4*>(bits + t0)
                                  + q);
            ln[4 * q] = l4.x;
            ln[4 * q + 1] = l4.y;
            ln[4 * q + 2] = l4.z;
            ln[4 * q + 3] = l4.w;
            v[4 * q] = (uint32_t)b4.x;
            v[4 * q + 1] = (uint32_t)b4.y;
            v[4 * q + 2] = (uint32_t)b4.z;
            v[4 * q + 3] = (uint32_t)b4.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < kScanTok; ++k) {
            const bool in = t0 + k < n;
            ln[k] = in ? __ldg(lens + t0 + k) : 0;
            v[k] = in ? (uint32_t)__ldg(bits + t0 + k) : 0u;
        }
    }
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kScanTok; ++k) {
        v[k] &= (1u << ln[k]) - 1u;
        mine += ln[k];
    }
    int cta_bits;
    const int excl = scan_cta(mine, &cta_bits, s_warp);
    long long* const rec = recs + c * kScanRec;
    if (c == 0) {
        if (tid == 0) {
            s_off = 0;
            scan_publish(rec, 0, 2, cta_bits);
        }
    } else {
        if (tid == 0) scan_publish(rec, 0, 1, cta_bits);
        if (tid < 32) {
            const long long off = scan_look_back(recs, c, 0);
            if (tid == 0) {
                s_off = off;
                scan_publish(rec, 0, 2, off + cta_bits);
            }
        }
    }
    __syncthreads();
    const long long off = s_off;
    const int hb = (int)(off & 31);

    // 2. the previous chunk's bits in word off / 32, then this chunk's
    if (c > 0 && hb > 0 && tid < 32) {
        int after = 0;                  // bits between a token and off
        for (int64_t g = c * kChunkTok - 1; g >= 0 && after < hb; g -= 32) {
            const int64_t ti = g - lane;
            const int l = ti >= 0 ? __ldg(lens + ti) : 0;
            const uint32_t bv = ti >= 0
                ? (uint32_t)__ldg(bits + ti) & ((1u << l) - 1u) : 0u;
            int incl = l;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int up = __shfl_up_sync(kAll, incl, d);
                if (lane >= d) incl += up;
            }
            const int hi = hb - (after + incl - l);   // the token's end
            if (l > 0 && hi > 0) {
                const int lo = hi - l > 0 ? hi - l : 0;
                const int nb = hi - lo;                // its bits in the word
                gj::put_bits(buf, lo, bv & ((1u << nb) - 1u), nb);
            }
            after += __shfl_sync(kAll, incl, 31);
        }
    }
    {
        int w = (hb + excl) >> 5, na = (hb + excl) & 31;
        uint64_t acc = 0;
        bool first = true;
#pragma unroll
        for (int k = 0; k < kScanTok; ++k) {
            if (ln[k] == 0) continue;
            acc |= (uint64_t)v[k] << (64 - na - ln[k]);
            na += ln[k];
            if (na >= 32) {
                const uint32_t word = (uint32_t)(acc >> 32);
                if (first) atomicOr(buf + w, word);
                else buf[w] = word;               // wholly this thread's
                first = false;
                ++w;
                acc <<= 32;
                na -= 32;
            }
        }
        if (na > 0) atomicOr(buf + w, (uint32_t)(acc >> 32));
    }
    __syncthreads();
    int end = hb + cta_bits;                      // the buffer's bits
    if (last && (end & 7)) {                      // F.1.2.3: 1-bits
        const int pl = 8 - (end & 7);
        if (tid == 0) gj::put_bits(buf, end, (1u << pl) - 1u, pl);
        end += pl;
        __syncthreads();
    }

    // 3. the owned bytes, stuffed, into the staging row
    const int owned = last ? end >> 3 : 4 * (end >> 5);
    const int nw = (owned + 3) >> 2;
    const int per = (nw + kScanThreads - 1) / kScanThreads;
    const int w_lo = min(tid * per, nw), w_hi = min(w_lo + per, nw);
    int nbytes = 0, nff = 0;
    for (int w = w_lo; w < w_hi; ++w) {
        const int nb = min(4, owned - 4 * w);
        const uint32_t inb = ~0u << (32 - 8 * nb);
        nff += __popc(__vcmpeq4(buf[w], ~0u) & inb) >> 3;
        nbytes += nb;
    }
    int cta_out;
    int o = scan_cta(nbytes + nff, &cta_out, s_warp);
    for (int w = w_lo; w < w_hi; ++w) {
        const int nb = min(4, owned - 4 * w);
        const uint32_t word = buf[w];
        for (int q = 0; q < nb; ++q) {
            const uint8_t b = (uint8_t)(word >> (24 - 8 * q));
            stage[o++] = b;
            if (b == 0xFF) stage[o++] = 0;
        }
    }
    const int cta_ff = cta_out - owned;
    if (c == 0) {
        if (tid == 0) {
            s_ff = 0;
            scan_publish(rec, 3, 2, cta_ff);
        }
    } else {
        if (tid == 0) scan_publish(rec, 3, 1, cta_ff);
        if (tid < 32) {
            const long long ff = scan_look_back(recs, c, 3);
            if (tid == 0) {
                s_ff = ff;
                scan_publish(rec, 3, 2, ff + cta_ff);
            }
        }
    }
    __syncthreads();
    const long long at = 4 * (off >> 5) + s_ff;   // the staging row's place
    for (int i = tid; i < cta_out; i += kScanThreads) out[at + i] = stage[i];

    // 4. the marker, the row's length and needs
    if (last && tid == 0) {
        long long total = at + cta_out;
        if (marker) {                             // not stuffed; 0 = none
            out[total] = 0xFF;
            out[total + 1] = (uint8_t)marker;
            total += 2;
        }
        row_bytes[0] = (int32_t)total;
        atomicMax(needs, (int32_t)(s_ff + cta_ff));
        atomicMax(needs + 1, (int32_t)total);
    }
}

template <int kStage>
int run(const void* bits, const void* lens, int64_t R, int T,
        const void* markers, int stride, void* rows, void* row_bytes,
        void* needs, void* stream) {
    auto* kernel = pack_stuff_rows_kernel<kStage>;
    const int fit = gj::resident_ctas(kernel, kThreads, 0);
    if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
    const int64_t want = (R + kWarps - 1) / kWarps;
    const int grid = want < fit ? (int)want : fit;
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)bits, (const int32_t*)lens, R, T,
        (const int32_t*)markers, stride, (uint8_t*)rows,
        (int32_t*)row_bytes, (int32_t*)needs);
    return (int)cudaGetLastError();
}

int launch(int stage, const void* bits, const void* lens, int64_t R, int T,
           const void* markers, int stride, void* rows, void* row_bytes,
           void* needs, void* stream) {
    // bits, lens: (R, T) i32, 16-byte aligned, T % 4 == 0, lens in [0,
    // 27]; markers: (R,) i32; rows: (R, stride) u8 with stride % 4 == 0;
    // row_bytes: (R,) i32; needs: (2,) i32
    if (T < 0 || T % 4 || stride % 4 || (uintptr_t)bits % 16
            || (uintptr_t)lens % 16)
        return (int)cudaErrorInvalidValue;
    if (R <= 0) return (int)cudaGetLastError();
    const auto fn = stage == gj::kFull ? run<gj::kFull>
        : stage == gj::kLoadStore ? run<gj::kLoadStore>
        : stage == gj::kNoStore ? run<gj::kNoStore> : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(bits, lens, R, T, markers, stride, rows, row_bytes, needs,
              stream);
}

}  // namespace

extern "C" int gj_pack_stuff_rows(const void* bits, const void* lens,
                                  int64_t R, int T, const void* markers,
                                  int stride, void* rows, void* row_bytes,
                                  void* needs, void* stream) {
    return launch(gj::kFull, bits, lens, R, T, markers, stride, rows,
                  row_bytes, needs, stream);
}

// the probe's cut kernels (gj::Stage), same arguments after the stage
extern "C" int gj_pack_stuff_rows_probe(int stage, const void* bits,
                                        const void* lens, int64_t R, int T,
                                        const void* markers, int stride,
                                        void* rows, void* row_bytes,
                                        void* needs, void* stream) {
    return launch(stage, bits, lens, R, T, markers, stride, rows, row_bytes,
                  needs, stream);
}

// One row of n dense tokens (the scan of one segment): bits, lens (n,)
// i32, lens in [0, 27]; marker the RST marker's second byte after the row
// (0 = none); out: at least the row's worst case (fusedpack.scan_rows'
// stride); row_bytes (1,) i32; needs (2,) i32, zeroed by the caller;
// scratch: int64 [kScanHead + kScanRec * nchunk], nchunk the chunks
// (fusedpack.scan_chunks), zeroed here.
extern "C" int gj_pack_stuff_scan(const void* bits, const void* lens,
                                  int64_t n, int marker, void* out,
                                  void* row_bytes, void* needs,
                                  void* scratch, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    const int64_t nchunk = n ? (n + kChunkTok - 1) / kChunkTok : 1;
    if (nchunk > INT_MAX) return (int)cudaErrorInvalidValue;
    const cudaError_t z = cudaMemsetAsync(
        scratch, 0, (size_t)(kScanHead + kScanRec * nchunk) * 8,
        (cudaStream_t)stream);
    if (z != cudaSuccess) return (int)z;
    pack_stuff_scan_kernel<<<(unsigned)nchunk, kScanThreads, 0,
                             (cudaStream_t)stream>>>(
        (const int32_t*)bits, (const int32_t*)lens, n, nchunk, marker,
        (uint8_t*)out, (int32_t*)row_bytes, (int32_t*)needs,
        (long long*)scratch);
    return (int)cudaGetLastError();
}
