// Dequantization + inverse DCT for Hopper (sm_90a): the quantized zig-zag
// coefficients of one component, read out of phase C's (64, L) layout ->
// its (data_h, data_w) uint8 sample plane.
//
// The JAX package computes this step of its interleaved decode tail in
// XLA (gpujpeg_tpu/models/decoder.py: _make_idct_post_fn_t_il, a float32
// jnp.dot at HIGHEST precision, then a byte pack and a block -> plane
// relayout on major dims), not in Pallas.  A library product
// (torch.matmul) sums in another order and changes about 2 samples in
// 10,000, so the port computes it here with the FMA chain of idct.cuh
// (shared with dpost_rgb.cu), which equals the plain version
// (ops/dct.dequantize_idct) and the JAX package bit for bit.
//
// Layout: raster block (by, bx) of the component lies in MCU (by / sv, bx /
// sh) of an MCU row of mcux MCUs and is block (by % sv, bx % sh) of the
// component's sv x sh blocks in that MCU, so its column of the (64, L)
// layout is  m * bpm + off + (by % sv) * sh + bx % sh,  m = (by / sv) * mcux
// + bx / sh (ops/prepost_kernel.block_columns).  An interleaved scan gives
// (bpm, off, sh, sv) its MCU's blocks a scan, the component's first slot
// and its sampling factors; a non-interleaved one bpm = sh = sv = 1, off =
// the component's first column and mcux = its blocks a row.
//
// Design, after dpost_rgb.cu: a CTA of 256 threads takes 32 blocks at a
// time (grid-stride), gathers and dequantizes their coefficients into
// shared memory, and thread (j, s) computes sample s of blocks j, j+4, ...,
// with column s of the IDCT matrix in registers, and stores its byte at
// (by * 8 + s / 8, bx * 8 + s % 8).
//
// Bound: operations.  At 8K 4:2:0 the three launches of a frame do 64 FMA
// for each of 49.8 M samples: 6.4 GFLOP, about 0.095 ms at 67 TFLOP/s of
// non-tensor f32; their 99.5 MB of coefficients in and 49.8 MB of samples
// out take about 0.045 ms at 3.35 TB/s.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "idct.cuh"

namespace {

constexpr int kGroup = 32;        // blocks per iteration
constexpr int kThreads = 256;
constexpr int kRow = 68;          // floats per dequantized row (16B-aligned)

struct Layout {
    int64_t L;        // columns of the coefficient layout
    int64_t off;      // column of the component's first block slot
    int bpm, sh, sv, mcux;
    int bcx;          // blocks a row of the plane (data_w / 8)
    int64_t nblk;     // blocks of the plane
    int data_w;
};

__device__ __forceinline__ int64_t column(const Layout& g, int64_t i) {
    const int64_t by = i / g.bcx, bx = i - by * g.bcx;
    const int64_t m = (by / g.sv) * g.mcux + bx / g.sh;
    return m * g.bpm + g.off + (by % g.sv) * g.sh + bx % g.sh;
}

__global__ void __launch_bounds__(kThreads)
idct_planes_kernel(const int16_t* __restrict__ coefs, Layout g,
                   const float* __restrict__ qtab,
                   const float* __restrict__ nmat,
                   uint8_t* __restrict__ out) {
    __shared__ __align__(16) float ys[kGroup][kRow];
    __shared__ float qs[64];
    __shared__ int64_t cols[kGroup];
    const int tid = threadIdx.x;
    const int s = tid & 63;          // sample: row s >> 3, column s & 7
    const int jj = tid >> 6;
    if (tid < 64) qs[tid] = qtab[tid];
    float n[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) n[k] = nmat[k * 64 + s];
    const int64_t ngroups = (g.nblk + kGroup - 1) / kGroup;
    for (int64_t grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
        const int64_t i0 = grp * kGroup;
        if (tid < kGroup)
            cols[tid] = i0 + tid < g.nblk ? column(g, i0 + tid) : -1;
        __syncthreads();
        for (int e = tid; e < 64 * kGroup; e += kThreads) {
            const int k = e / kGroup;
            const int gi = e % kGroup;
            const int64_t c = cols[gi];
            const int v = c >= 0 ? coefs[k * g.L + c] : 0;
            ys[gi][k] = (float)v * qs[k];
        }
        __syncthreads();
        for (int gi = jj; gi < kGroup; gi += kThreads / 64) {
            const int64_t i = i0 + gi;
            if (i >= g.nblk) break;
            const float* const yr[1] = {ys[gi]};
            float a[1];
            gj::idct_chains<1>(yr, n, a);
            const int64_t by = i / g.bcx, bx = i - by * g.bcx;
            out[(by * 8 + (s >> 3)) * g.data_w + bx * 8 + (s & 7)] =
                (uint8_t)gj::idct_to_sample(a[0]);
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int gj_idct_planes(const void* coefs, int64_t L, int bpm,
                              int64_t off, int sh, int sv, int mcux,
                              int data_h, int data_w, const void* qtab,
                              const void* nmat, void* out, void* stream) {
    // coefs: (64, L) i16 with DC integrated; qtab: (64,) f32 zig-zag;
    // nmat: (64, 64) f32, N[k][s]; out: (data_h, data_w) u8, both
    // multiples of 8; the layout as above
    Layout g{L, off, bpm, sh, sv, mcux, data_w / 8,
             (int64_t)(data_h / 8) * (data_w / 8), data_w};
    const int64_t ngroups = (g.nblk + kGroup - 1) / kGroup;
    if (ngroups > 0) {
        const int64_t grid = ngroups < 4096 ? ngroups : 4096;
        idct_planes_kernel<<<(unsigned)grid, kThreads, 0,
                             (cudaStream_t)stream>>>(
            (const int16_t*)coefs, g, (const float*)qtab,
            (const float*)nmat, (uint8_t*)out);
    }
    return (int)cudaGetLastError();
}
