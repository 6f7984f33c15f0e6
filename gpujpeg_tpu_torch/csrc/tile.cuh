// The tile machinery of the port's tiled DCT kernels (fdct_quant.cu,
// dpost_rgb.cu, idct_planes.cu): asynchronous copies into shared memory, the FMA chains of
// 8 blocks x 8 outputs a thread over a transposed tile, the probe's stages
// and the persistent grid's size.
//
// A tile's samples or dequantized coefficients sit in shared memory as
// x[k][block], k = 0..63 the chain's term, and the matrix (the DCT's Mq or
// the IDCT's N) as m[k][output].  Every chain keeps the order of
// ops/dct.py:
//     acc = 0;  for k = 0..63: acc = fmaf(x[k], m[k][z], acc)
// so the result is bit-equal to the plain versions.  Never build this
// with --use_fast_math, and never replace a chain by a tensor-core or TF32
// product, or by split sums.

#pragma once

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace gj {

// cp.async of N bytes (4, 8 or 16; both addresses N-aligned) from global
// to shared memory; when !valid nothing is read and the N bytes are
// zero-filled
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool valid) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(gmem), "n"(N), "r"(valid ? N : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The 8 x 8 register tile of one thread: acc[i][j] = the chain of block i
// (the floats x[k * XStride + i], i < 8) with column zj of m, a (64, 64)
// float matrix in shared memory, zj = z0 + j for j < 4 and 32 + z0 + j - 4
// for j >= 4 (z0 a multiple of 4, at most 28).  Each k takes two float4
// reads of x and two of m for 64 FMAs.  A thread that kept one column of m
// in registers and read x alone would need 16 reads for those 64 FMAs, and
// the shared-memory pipe, not the FMA pipe, would set its pace; a tile of
// 8 x 4 (three reads for 32 FMAs) ran slower in both kernels (PERF.md,
// Findings).  The threads of a warp that share blocks read the
// same x (a broadcast); the 8 z0 of a warp read 128 contiguous bytes of a
// row of m.  Term k + 1's operands are read while term k's FMAs issue.
template <int XStride>
struct TileOperands {
    float4 x0, x1, m0, m1;

    __device__ __forceinline__ void load(const float* __restrict__ x,
                                         const float* __restrict__ m,
                                         int z0, int k) {
        x0 = *reinterpret_cast<const float4*>(x + k * XStride);
        x1 = *reinterpret_cast<const float4*>(x + k * XStride + 4);
        m0 = *reinterpret_cast<const float4*>(m + k * 64 + z0);
        m1 = *reinterpret_cast<const float4*>(m + k * 64 + 32 + z0);
    }

    __device__ __forceinline__ void fma(float (&acc)[8][8]) const {
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(xv[i], mv[j], acc[i][j]);
    }
};

template <int XStride>
__device__ __forceinline__ void fma_tile8x8(const float* __restrict__ x,
                                            const float* __restrict__ m,
                                            int z0, float (&acc)[8][8]) {
    static_assert(XStride % 4 == 0, "float4 rows");
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    TileOperands<XStride> cur;
    cur.load(x, m, z0, 0);
#pragma unroll 8
    for (int k = 0; k < 63; ++k) {
        TileOperands<XStride> nxt;
        nxt.load(x, m, z0, k + 1);
        cur.fma(acc);
        cur = nxt;
    }
    cur.fma(acc);
}

// The sample of an IDCT chain (ops/dct.dequantize_idct): the separate add
// of the 128 level shift, then one conversion that rounds half to even and
// saturates to [0, 255]
__device__ __forceinline__ uint32_t sample_u8(float acc) {
    unsigned short v;
    asm("cvt.rni.sat.u8.f32 %0, %1;" : "=h"(v) : "f"(__fadd_rn(acc, 128.f)));
    return v;
}

// the probe's stages of a kernel (chip_smoke.py; never a codec path); the
// Huffman coder (huffman_segments.cu) reads kLoadStore as its loads alone
enum Stage : int {
    kFull = 0,       // the kernel
    kLoadStore = 1,  // loads and stores only, no arithmetic
    kNoStore = 2,    // the kernel without its output store
};

// CTAs of `kernel` that fit on the card at once (the persistent grid),
// with `smem` bytes of dynamic shared memory a CTA; worked out once per
// kernel, device and size, so that a launch costs the host no more than
// the launch itself.  A kernel given dynamic shared memory is allowed all
// the card offers a CTA, so that a launch of any size that fits stays
// valid whatever size was asked before (the direct instance of
// huffdec_block.cu sizes its rows to each launch).  0 when smem does not
// fit, and after a CUDA error.
template <typename K>
inline int resident_ctas(K kernel, int threads, int smem) {
    struct Known {
        const void* fn;
        int dev, smem, ctas;
    };
    constexpr int kKnown = 256;
    static Known known[kKnown];
    static int n = 0;
    static std::mutex mu;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    const void* const fn = reinterpret_cast<const void*>(kernel);
    const std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n && i < kKnown; ++i)
        if (known[i].fn == fn && known[i].dev == dev
                && known[i].smem == smem)
            return known[i].ctas;
    int allow = 0;
    if (smem > 0) {
        cudaFuncAttributes fa;
        int optin = 0;
        if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess
                || cudaDeviceGetAttribute(
                       &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                       dev) != cudaSuccess)
            return 0;
        allow = optin - (int)fa.sharedSizeBytes;
        if (smem > allow) return 0;
    }
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             allow) != cudaSuccess
            || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev) != cudaSuccess
            || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, kernel, threads, smem) != cudaSuccess)
        return 0;
    known[n++ % kKnown] = Known{fn, dev, smem, sms * per_sm};
    return sms * per_sm;
}

}  // namespace gj
