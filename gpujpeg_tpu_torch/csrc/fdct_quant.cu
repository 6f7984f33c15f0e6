// Forward DCT + quantization for Hopper (sm_90a): one uint8 component plane
// -> int16 zig-zag coefficients in restart-segment order.
//
// Replaces the DCT half of the JAX package's DCT-fused entropy megakernel
// (gpujpeg_tpu/ops/fusedpack.py: _entropy_kernel_body with dct_nmat > 0,
// launched by make_entropy_kernel through entropy_fused_u8).  On the TPU
// the DCT was a block-diagonal MXU matmul on packed sample patches; here
// it is one thread per output coefficient.
//
// The result must equal the JAX package bit for bit, so the arithmetic
// order is fixed (see ops/dct.py): for coefficient z of a block,
//     acc = 0;  for k = 0..63: acc = fmaf(x[k], Mq[k][z], acc)
//     coef = rintf(__fadd_rn(acc, bias[z]))
// Never build this with --use_fast_math, and never replace the chain by a
// tensor-core or TF32 product: each changes about 2 in 10,000 coefficients.
//
// Design: a CTA of 256 threads works on 4 JPEG blocks at a time and walks
// the plane's blocks in a grid-stride loop.  Thread t always computes
// zig-zag slot z = t % 64, so it keeps column z of Mq in 64 registers for
// the whole launch; the 4 blocks' samples sit in shared memory and every
// read of x[k] is a broadcast within the warp.  Blocks in raster order ARE
// restart-segment order for a non-interleaved scan (segment s = blocks
// [s*rst, (s+1)*rst)), so coefficient (block b, slot z) is stored at
// b*64 + z; pad blocks past the plane's last block are written as 0.
//
// Bound: operations.  An 8K plane has 33.2 M coefficients of 64 FMA each;
// 3 planes are 12.7 GFLOP, about 0.19 ms at 67 TFLOP/s of non-tensor f32.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerIter = 4;
constexpr int kThreads = 64 * kBlocksPerIter;

__global__ void __launch_bounds__(kThreads)
fdct_quant_kernel(const uint8_t* __restrict__ plane, int data_w, int bpr,
                  int64_t nblocks, int64_t nblocks_out,
                  const float* __restrict__ mq,
                  const float* __restrict__ bias,
                  int16_t* __restrict__ out) {
    __shared__ __align__(16) float xs[kBlocksPerIter][64];
    const int z = threadIdx.x & 63;
    const int j = threadIdx.x >> 6;
    float m[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) m[k] = mq[k * 64 + z];
    const float bz = bias[z];
    const int64_t ngroups = (nblocks_out + kBlocksPerIter - 1) / kBlocksPerIter;
    for (int64_t g = blockIdx.x; g < ngroups; g += gridDim.x) {
        const int64_t b = g * kBlocksPerIter + j;
        // thread (j, z) loads sample z (row z/8, column z%8) of block j
        float s = 0.0f;
        if (b < nblocks) {
            const int64_t by = b / bpr, bx = b % bpr;
            s = (float)plane[(by * 8 + (z >> 3)) * (int64_t)data_w
                             + bx * 8 + (z & 7)];
        }
        xs[j][z] = s;
        __syncthreads();
        if (b < nblocks_out) {
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < 64; ++k) acc = fmaf(xs[j][k], m[k], acc);
            const float y = __fadd_rn(acc, bz);
            out[b * 64 + z] = b < nblocks ? (int16_t)rintf(y) : (int16_t)0;
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int gj_fdct_quant(const void* plane, int data_h, int data_w,
                             int64_t nblocks_out, const void* mq,
                             const void* bias, void* out, void* stream) {
    // plane: (data_h, data_w) u8, both multiples of 8; mq: (64, 64) f32
    // row-major (sample k, zig-zag z); bias: (64,) f32; out: (nblocks_out,
    // 64) int16 with nblocks_out >= (data_h/8) * (data_w/8)
    const int bpr = data_w / 8;
    const int64_t nblocks = (int64_t)(data_h / 8) * bpr;
    const int64_t ngroups = (nblocks_out + kBlocksPerIter - 1) / kBlocksPerIter;
    if (ngroups > 0) {
        const int64_t grid = ngroups < 4096 ? ngroups : 4096;
        fdct_quant_kernel<<<(unsigned)grid, kThreads, 0,
                            (cudaStream_t)stream>>>(
            (const uint8_t*)plane, data_w, bpr, nblocks, nblocks_out,
            (const float*)mq, (const float*)bias, (int16_t*)out);
    }
    return (int)cudaGetLastError();
}
