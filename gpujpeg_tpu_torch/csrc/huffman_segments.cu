// Huffman coder for Hopper (sm_90a): int16 zig-zag coefficients, one
// restart segment per row -> stuffed byte rows.
//
// Replaces the entropy half of the JAX package's entropy megakernel
// (gpujpeg_tpu/ops/fusedpack.py: _entropy_kernel_body, launched by
// make_entropy_kernel) in all three of its modes: the DCT-fused mode of a
// non-interleaved scan (entropy_fused_u8, after csrc/fdct_quant.cu), the
// interleaved mode (entropy_fused_u8_il, MCU-ordered rows of a whole scan)
// and the coefficient-input mode (entropy_fused).  Per row: DC difference
// per component, run/size tokens with ZRL and EOB, bit packing, F.1.2.3
// 1-bit padding, 0xFF -> 0xFF00 stuffing and the caller's RST marker.  On
// the TPU this was a data-parallel token map plus a merge tree of shifts
// and rolls, with static per-sublane class masks for the interleaved mode.
//
// The contract, per block b of row s, slot j = b % bpm of its MCU:
//   class:     luts0 iff bit j of luma_pat is set and (row_luma is null or
//              row_luma[s] != 0); else luts1
//   component: bits 2j..2j+1 of comp_pat; the DC predictor is the last
//              block of the same component in the row, 0 at the row start
//              (T.81 F.1.1.5.1; at 4:2:0 the four Y slots of an MCU
//              predict from one another)
//   valid:     valid[s * B + b] != 0, or, when valid is null, s * B + b <
//              nblocks; a block that is not valid emits no token, but its
//              DC still feeds the next difference of its component (the
//              megakernel forms the difference before it masks); blocks
//              past the last valid one of a prefix feed nothing
//   marker:    after the padded row, 0xFF markers[s] unless markers[s] is 0
// A non-interleaved scan is the one-slot special case (bpm 1, one class,
// prefix validity, markers 0xD0 + s % 8 but none after the last row).
//
// Rows have a worst-case stride (each slot's class's longest coding,
// doubled for stuffing, plus 2 for the marker; ops/fusedpack.py computes
// it), so no row can overflow and no capacity protocol is needed.  The
// kernel writes row_bytes[s] and raises needs[0] / needs[1] to the largest
// stuffed-zero count / row length (atomicMax; the caller zeroes needs).
// Bytes past a row's length are unspecified.
//
// Bound: bytes.  At 8K Q75 the kernel reads 66.4 MB of coefficients a
// plane (199 MB for an interleaved 4:4:4 scan) and writes the realised
// stream (a few MB).  In practice the warp's instructions for each row,
// block and token set the time, not the bytes: chip_smoke.py's probe
// (the loads alone against the full kernel) puts the loads at about a
// third of a launch (PERF.md, Findings).
//
// Design: a warp a segment row, as in the reference GPUJPEG's encode kernel
// (gpujpeg_huffman_gpu_encoder.cu: ballot masks, __popc compaction of the
// nonzero coefficients, a warp's tokens placed by their bit counts).  A
// persistent grid of 8-warp CTAs walks the rows, a row a warp; the warp
// codes its row in batches of 8 blocks:
//   - load: a batch's 1 KB of coefficients comes into shared memory by
//     cp.async, 32 contiguous bytes a lane, while the batch before it is
//     coded (across rows too); lane l then takes coefficients l and l + 32
//     of each block;
//   - compaction: two ballots give a block's nonzero AC mask; each
//     nonzero lane writes (k, value) to the block's list at its rank (the
//     __popc of the mask below it);
//   - blocks: lane b takes block b of the batch: its slot's class and
//     component (uniform over a row's MCUs, so the modes add no
//     divergence), its DC predictor (the block dprev[slot] back, by a
//     shuffle, or carried from the batch before), its token count (DC, AC
//     nonzeros, EOB when coefficient 63 is 0) and, by a warp scan, its
//     first token;
//   - tokens: lane l codes token t0 + l of the batch, 32 at a time: its
//     block by the tokens' offsets, its run from its list neighbour, its
//     symbol ((run % 16) << 4 | size) from the class's LUT in shared
//     memory.  So the work goes with the tokens (about 10 a block at Q75),
//     not with the 64 coefficients;
//   - bit offsets: a warp exclusive scan of the tokens' bit counts places
//     each in the row; each is ORed MSB first into the warp's bit buffer in
//     shared memory (512 bytes a warp; put_bits, bitbuf.cuh);
//   - stuffing: when the buffer holds more than kFlushWords whole words,
//     and at the row's end after the 1-bit pad, its whole bytes go out:
//     each lane takes a word, counts its 0xFF bytes, a warp scan of the
//     output bytes gives each byte its place, and a 0x00 follows each
//     0xFF (flush_bytes, bitbuf.cuh, shared with pack_stuff_rows.cu).
//     Then the unstuffed marker.  So the buffer needs no room for a
//     whole row, and a row of any length (restart interval 0) codes the
//     same way.
// The stage template argument cuts the kernel for the decomposition probe
// (gj::Stage; gj_huffman_segments_probe); the codec's entry point,
// gj_huffman_segments, always launches the full kernel.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "bitbuf.cuh"
#include "tile.cuh"

namespace {

constexpr int kLutWords = 272;   // DC entries at [0, 16), AC at [16, 272)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// blocks a warp loads at once: a one-slot row of 8 blocks is one batch
constexpr int kBatch = 8;
constexpr int kBufWords = 128;   // a warp's bit buffer
// a round of 32 tokens adds at most 32 * (3 * 16 + 26) bits (74 words):
// the buffer is emptied when it holds more than this many whole words
constexpr int kFlushWords = kBufWords - 80;
using gj::flush_bytes;
using gj::kAll;
using gj::put_bits;

// a warp's shared memory
struct WarpSmem {
    uint4 stage[2][kBatch * 8];  // coefficients of two batches (cp.async)
    uint32_t buf[kBufWords];     // bits, MSB first
    // each block's nonzero AC coefficients in zig-zag order: k << 16 |
    // (value & 0xFFFF)
    uint32_t list[kBatch][64];
    // each block's first token | AC count << 12 | luts0 << 20, and its DC
    // difference
    int info[kBatch][2];
};

// JPEG size category of v and its value bits (F.1.2.1)
__device__ __forceinline__ void size_and_bits(int v, int& size,
                                              uint32_t& vb) {
    const int a = v < 0 ? -v : v;
    size = 32 - __clz(a);
    vb = (uint32_t)(v < 0 ? v - 1 : v) & ((1u << size) - 1u);
}

// Codes the tokens t0 .. t0 + 31 of a batch (lane l: token t0 + l, T in
// all) into the bit buffer at bit pos; returns the bits added.  The tokens
// of block i are st[i] (its DC difference), then its AC nonzeros in
// order, each after its ZRLs, then EOB when its coefficient 63 is 0.
__device__ __forceinline__ int code_round(const WarpSmem& ws, uint32_t* buf,
                                          const uint32_t* lut,
                                          const int (&st)[kBatch], int t0,
                                          int T, int pos, int lane) {
    const int t = t0 + lane;
    int nz = 0, lz = 0, tlen = 0;
    uint32_t zcode = 0, tok = 0;
    if (t < T) {
        int beta = 0;
#pragma unroll
        for (int i = 1; i < kBatch; ++i) beta += t >= st[i];
        const int i0 = ws.info[beta][0];
        const int r = t - (i0 & 0xFFF), nac = (i0 >> 12) & 63;
        const uint32_t* const tab = lut + ((i0 >> 20) & 1 ? 0 : kLutWords);
        // the DC difference (r = 0), an AC nonzero (r <= nac) or EOB, with
        // no branch: every lane reads all three places
        const bool isac = r > 0 && r <= nac;
        const uint32_t le = ws.list[beta][isac ? r - 1 : 0];
        const uint32_t lp = ws.list[beta][isac && r >= 2 ? r - 2 : 0];
        const int dcd = ws.info[beta][1];
        const int run = isac
            ? (int)(le >> 16) - 1 - (r >= 2 ? (int)(lp >> 16) : 0) : 0;
        int size;
        uint32_t vb;
        size_and_bits(r == 0 ? dcd : isac ? (int)(int16_t)(le & 0xFFFFu) : 0,
                      size, vb);
        // DC entries at [0, 16), AC at 16 + (run << 4 | size), EOB at 16
        const uint32_t e = tab[r == 0 ? (size < 11 ? size : 11)
                               : 16 + (isac ? (run & 15) << 4
                                        | (size < 15 ? size : 15) : 0)];
        tok = ((e & 0xFFFFu) << size) | vb;
        tlen = (int)(e >> 16) + size;
        nz = run >> 4;                           // ZRLs: only before a nonzero
        if (nz) {
            const uint32_t z = tab[16 + 0xF0];
            zcode = z & 0xFFFFu;
            lz = (int)(z >> 16);
        }
    }
    const int mine = nz * lz + tlen;
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kAll, incl, d);
        if (lane >= d) incl += up;
    }
    int at = pos + incl - mine;
    for (int q = 0; q < nz; ++q, at += lz) put_bits(buf, at, zcode, lz);
    if (tlen) put_bits(buf, at, tok, tlen);
    return __shfl_sync(kAll, incl, 31);
}

template <int kStage>
__global__ void __launch_bounds__(kThreads)
huffman_segments_kernel(const int16_t* __restrict__ coefs, int64_t nrows,
                        int B, int64_t nblocks,
                        const uint8_t* __restrict__ valid,
                        const uint32_t* __restrict__ luts0,
                        const uint32_t* __restrict__ luts1,
                        const int32_t* __restrict__ row_luma, int bpm,
                        uint32_t luma_pat, uint32_t comp_pat,
                        const int32_t* __restrict__ markers, int stride,
                        uint8_t* __restrict__ rows,
                        int32_t* __restrict__ row_bytes,
                        int32_t* __restrict__ needs) {
    __shared__ uint32_t lut[2 * kLutWords];
    __shared__ WarpSmem wsm[kWarps];
    __shared__ int dprev[16];   // slot j: distance to its DC predictor
    __shared__ uint8_t slot_of[48];             // x % bpm
    __shared__ int cta_needs[2];
    for (int i = threadIdx.x; i < kLutWords; i += kThreads) {
        lut[i] = luts0[i];
        lut[kLutWords + i] = luts1[i];
    }
    if (threadIdx.x < bpm) {
        // the previous block of the same component is d slots back
        const int j = threadIdx.x;
        const uint32_t c = (comp_pat >> (2 * j)) & 3u;
        int d = 1;
        while (d < bpm && ((comp_pat >> (2 * ((j - d + bpm) % bpm))) & 3u)
                              != c)
            ++d;
        dprev[j] = d;
    }
    if (threadIdx.x < 48)
        slot_of[threadIdx.x] = (uint8_t)(threadIdx.x % bpm);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    WarpSmem& ws = wsm[warp];
    uint32_t* const buf = ws.buf;
    for (int i = lane; i < kBufWords; i += 32) buf[i] = 0;
    if (threadIdx.x < 2) cta_needs[threadIdx.x] = 0;
    __syncthreads();
    const uint32_t below = (1u << lane) - 1u;    // lanes under this one
    const int64_t rstep = (int64_t)gridDim.x * kWarps;
    // blocks row s walks: all B, or a prefix of the first nblocks
    const auto row_blocks = [&](int64_t s) -> int {
        if (valid != nullptr) return B;
        const int64_t left = nblocks - s * B;
        return left < B ? (left > 0 ? (int)left : 0) : B;
    };
    // the next batch's coefficients into stage[sb] (one commit group; an
    // empty one when there is none): lane l copies bytes 32 l .. 32 l + 31
    const auto issue = [&](int64_t s, int b0, int nb, int sb) {
        if (s < nrows && b0 < nb) {
            const uint4* const src =
                reinterpret_cast<const uint4*>(coefs + (s * B + b0) * 64);
#pragma unroll
            for (int u = 0; u < kBatch / 4; ++u) {
                const int e = kBatch / 4 * lane + u;
                const bool ok = (e >> 3) < nb - b0;
                gj::cp_async<16>(&ws.stage[sb][e], ok ? src + e : src, ok);
            }
        }
        gj::cp_async_commit();
    };
    // the warp's largest stuffed-zero count and row length: needs gets
    // one atomicMax a CTA
    int max_nff = 0, max_len = 0;
    int64_t s = (int64_t)blockIdx.x * kWarps + warp;
    int sb = 0;                                  // stage of this batch
    issue(s, 0, s < nrows ? row_blocks(s) : 0, 0);
    for (; s < nrows; s += rstep) {
        uint8_t* const out = rows + s * (int64_t)stride;
        const uint32_t row_pat =
            (row_luma == nullptr || row_luma[s]) ? luma_pat : 0u;
        const int nb = row_blocks(s);
        const int m = markers[s];                 // not stuffed; 0 = none
        int pos = 0;                             // bits in the buffer
        int outpos = 0, nff = 0;                 // row bytes, stuffed zeros
        // DC of the last block of each component in earlier batches
        int carry0 = 0, carry1 = 0, carry2 = 0, carry3 = 0;
        uint32_t sink = 0;                       // the probe's loads
        int jb = 0;                              // slot of block b0
        for (int b0 = 0; b0 < nb; b0 += kBatch, jb = slot_of[jb + kBatch]) {
            const int nbat = nb - b0 < kBatch ? nb - b0 : kBatch;
            // lane b: block b0 + b is in the batch and valid
            const bool inb = lane < nbat;
            const bool ok = inb && (valid == nullptr
                                    || valid[s * B + b0 + lane] != 0);
            // the next batch flies while this one is coded
            __syncwarp();
            if (b0 + kBatch < nb)
                issue(s, b0 + kBatch, nb, sb ^ 1);
            else
                issue(s + rstep, 0, s + rstep < nrows
                      ? row_blocks(s + rstep) : 0, sb ^ 1);
            gj::cp_async_wait<1>();
            __syncwarp();
            // lane l: coefficients l and l + 32 of each block
            const int16_t* const c16 =
                reinterpret_cast<const int16_t*>(ws.stage[sb]);
            int lo[kBatch], hi[kBatch];
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
                lo[i] = c16[i * 64 + lane];
                hi[i] = c16[i * 64 + 32 + lane];
            }
            sb ^= 1;
            if (kStage == gj::kLoadStore) {
#pragma unroll
                for (int i = 0; i < kBatch; ++i) sink ^= lo[i] + hi[i];
                continue;
            }
            // nonzero AC coefficients, compacted in order (ballot + popc):
            // lane l's rank among them is the count below it
            uint32_t mylo = 0, myhi = 0;         // lane i: block i's masks
            int mydc = 0;
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
                if (i >= nbat) break;
                const uint32_t mlo = __ballot_sync(kAll, lo[i] != 0) & ~1u;
                const uint32_t mhi = __ballot_sync(kAll, hi[i] != 0);
                const int dc = __shfl_sync(kAll, lo[i], 0);
                if (lane == i) {
                    mylo = mlo;
                    myhi = mhi;
                    mydc = dc;
                }
                if ((mlo >> lane) & 1u)
                    ws.list[i][__popc(mlo & below)] =
                        (uint32_t)lane << 16 | (lo[i] & 0xFFFF);
                if ((mhi >> lane) & 1u)
                    ws.list[i][__popc(mlo) + __popc(mhi & below)] =
                        (uint32_t)(lane + 32) << 16 | (hi[i] & 0xFFFF);
            }
            // lane b: block b0 + b's slot, component, class, DC difference
            // and tokens (its DC, AC nonzeros, EOB when coefficient 63 is
            // 0), all blocks of the batch at once
            const int j = slot_of[jb + lane];
            const int comp = (int)((comp_pat >> (2 * j)) & 3u);
            const int pb = lane - dprev[j];
            const int pv = __shfl_sync(kAll, mydc, pb >= 0 ? pb : lane);
            const int pred = pb >= 0 ? pv : comp == 0 ? carry0
                : comp == 1 ? carry1 : comp == 2 ? carry2 : carry3;
            const int nac = __popc(mylo) + __popc(myhi);
            const int ntok = ok ? 1 + nac + (int)((myhi >> 31) == 0) : 0;
            int incl = ntok;                     // lanes past 7 hold 0
#pragma unroll
            for (int d = 1; d < kBatch; d <<= 1) {
                const int up = __shfl_up_sync(kAll, incl, d);
                if (lane >= d) incl += up;
            }
            const int T = __shfl_sync(kAll, incl, kBatch - 1);
            if (ok) {
                ws.info[lane][0] = (incl - ntok) | nac << 12
                    | (int)((row_pat >> j) & 1u) << 20;
                ws.info[lane][1] = mydc - pred;
            }
            int st[kBatch];                      // first token of a block
#pragma unroll
            for (int i = 0; i < kBatch; ++i)
                st[i] = i < nbat ? __shfl_sync(kAll, incl - ntok, i) : T;
            if (b0 + kBatch < nb) {              // carry the predictors
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const uint32_t mc = __ballot_sync(kAll, inb && comp == c);
                    const int last = 31 - __clz(mc);
                    const int v = __shfl_sync(kAll, mydc, mc ? last : 0);
                    if (mc) {
                        carry0 = c == 0 ? v : carry0;
                        carry1 = c == 1 ? v : carry1;
                        carry2 = c == 2 ? v : carry2;
                        carry3 = c == 3 ? v : carry3;
                    }
                }
            }
            __syncwarp();
            for (int t0 = 0; t0 < T; t0 += 32) {
                pos += code_round(ws, buf, lut, st, t0, T, pos, lane);
                __syncwarp();
                if ((pos >> 5) > kFlushWords) {   // whole words out
                    const int nw = pos >> 5;
                    flush_bytes<kStage == gj::kFull>(buf, 4 * nw, out,
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
        }
        if (pos & 7) {                            // F.1.2.3: 1-bits
            const int pl = 8 - (pos & 7);
            if (lane == 0) put_bits(buf, pos, (1u << pl) - 1u, pl);
            pos += pl;
        }
        __syncwarp();
        const int nbytes = pos >> 3;
        flush_bytes<kStage == gj::kFull>(buf, nbytes, out, outpos, nff,
                                         lane);
        __syncwarp();
        for (int i = lane; i < (nbytes + 3) >> 2; i += 32) buf[i] = 0;
        if (m) {
            if (lane == 0 && kStage == gj::kFull) {
                out[outpos] = 0xFF;
                out[outpos + 1] = (uint8_t)m;
            }
            outpos += 2;
        }
        if (lane == 0) row_bytes[s] = outpos;
        if (kStage == gj::kLoadStore && sink == 0x9E3779B9u)
            row_bytes[s] = -1;                   // keeps the loads
        max_nff = nff > max_nff ? nff : max_nff;
        max_len = outpos > max_len ? outpos : max_len;
    }
    gj::cp_async_wait<0>();
    if (lane == 0) {
        atomicMax(&cta_needs[0], max_nff);
        atomicMax(&cta_needs[1], max_len);
    }
    __syncthreads();
    if (threadIdx.x < 2)
        atomicMax(&needs[threadIdx.x], cta_needs[threadIdx.x]);
}

template <int kStage>
int run(const void* coefs, int64_t nrows, int B, int64_t nblocks,
        const void* valid, const void* luts0, const void* luts1,
        const void* row_luma, int bpm, int64_t luma_pat, int64_t comp_pat,
        const void* markers, int stride, void* rows, void* row_bytes,
        void* needs, void* stream) {
    auto* kernel = huffman_segments_kernel<kStage>;
    const int fit = gj::resident_ctas(kernel, kThreads, 0);
    if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
    const int64_t want = (nrows + kWarps - 1) / kWarps;
    const int grid = want < fit ? (int)want : fit;
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int16_t*)coefs, nrows, B, nblocks, (const uint8_t*)valid,
        (const uint32_t*)luts0, (const uint32_t*)luts1,
        (const int32_t*)row_luma, bpm, (uint32_t)luma_pat,
        (uint32_t)comp_pat, (const int32_t*)markers, stride,
        (uint8_t*)rows, (int32_t*)row_bytes, (int32_t*)needs);
    return (int)cudaGetLastError();
}

int launch(int stage, const void* coefs, int64_t nrows, int B,
           int64_t nblocks, const void* valid, const void* luts0,
           const void* luts1, const void* row_luma, int bpm,
           int64_t luma_pat, int64_t comp_pat, const void* markers,
           int stride, void* rows, void* row_bytes, void* needs,
           void* stream) {
    // coefs: (nrows, B*64) int16, 16-byte aligned; valid: (nrows, B) u8
    // or null (then the first nblocks blocks are valid); luts0/1:
    // int32[272] each; row_luma: (nrows,) i32 or null; 1 <= bpm <= 16,
    // B % bpm == 0; luma_pat: bit j = slot j may take luts0; comp_pat: 2
    // bits a slot; markers: (nrows,) i32; rows: (nrows, stride) u8;
    // row_bytes: (nrows,) i32; needs: (2,) i32
    if (bpm < 1 || bpm > 16 || B < 1 || B % bpm || (uintptr_t)coefs % 16)
        return (int)cudaErrorInvalidValue;
    if (nrows <= 0) return (int)cudaGetLastError();
    const auto fn = stage == gj::kFull ? run<gj::kFull>
        : stage == gj::kLoadStore ? run<gj::kLoadStore>
        : stage == gj::kNoStore ? run<gj::kNoStore> : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(coefs, nrows, B, nblocks, valid, luts0, luts1, row_luma, bpm,
              luma_pat, comp_pat, markers, stride, rows, row_bytes, needs,
              stream);
}

}  // namespace

extern "C" int gj_huffman_segments(const void* coefs, int64_t nrows, int B,
                                   int64_t nblocks, const void* valid,
                                   const void* luts0, const void* luts1,
                                   const void* row_luma, int bpm,
                                   int64_t luma_pat, int64_t comp_pat,
                                   const void* markers, int stride,
                                   void* rows, void* row_bytes, void* needs,
                                   void* stream) {
    return launch(gj::kFull, coefs, nrows, B, nblocks, valid, luts0, luts1,
                  row_luma, bpm, luma_pat, comp_pat, markers, stride, rows,
                  row_bytes, needs, stream);
}

// the probe's cut kernels (gj::Stage), same arguments after the stage:
// loads and stores only walks the blocks' loads and DC predictors and
// codes nothing; no store codes and stuffs but writes no byte
extern "C" int gj_huffman_segments_probe(
        int stage, const void* coefs, int64_t nrows, int B, int64_t nblocks,
        const void* valid, const void* luts0, const void* luts1,
        const void* row_luma, int bpm, int64_t luma_pat, int64_t comp_pat,
        const void* markers, int stride, void* rows, void* row_bytes,
        void* needs, void* stream) {
    return launch(stage, coefs, nrows, B, nblocks, valid, luts0, luts1,
                  row_luma, bpm, luma_pat, comp_pat, markers, stride, rows,
                  row_bytes, needs, stream);
}
