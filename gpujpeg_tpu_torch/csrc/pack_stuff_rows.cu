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
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "bitbuf.cuh"
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
