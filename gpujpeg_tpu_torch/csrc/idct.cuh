// The inverse DCT of the port's decode kernels (dpost_rgb.cu,
// idct_planes.cu): dequantized zig-zag coefficients -> one 8-bit sample.
//
// The result must equal the plain version (ops/dct.dequantize_idct) bit for
// bit, so the arithmetic order is fixed:
//     y[k] = coef[k] * q[k]                      (float32, exact)
//     acc = 0;  for k = 0..63: acc = fmaf(y[k], N[k][s], acc)
//     v = clamp(rintf(__fadd_rn(acc, 128.f)), 0, 255)
// Never build this with --use_fast_math, and never replace the chain by a
// tensor-core or TF32 product.
//
// A thread keeps column s of N (its sample) in 64 registers and reads the
// dequantized rows of NC blocks from shared memory as float4 broadcasts;
// the NC chains run side by side, each in the order above.

#pragma once

namespace gj {

__device__ __forceinline__ int idct_to_sample(float acc) {
    return (int)fminf(fmaxf(rintf(__fadd_rn(acc, 128.f)), 0.f), 255.f);
}

// acc[c] = the chain over the 64 floats at y[c] (16-byte aligned)
template <int NC>
__device__ __forceinline__ void idct_chains(const float* const (&y)[NC],
                                            const float (&n)[64],
                                            float (&acc)[NC]) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 64; k += 4) {
        float4 v[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
            v[c] = *reinterpret_cast<const float4*>(y[c] + k);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = fmaf(v[c].x, n[k], acc[c]);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = fmaf(v[c].y, n[k + 1], acc[c]);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = fmaf(v[c].z, n[k + 2], acc[c]);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = fmaf(v[c].w, n[k + 3], acc[c]);
    }
}

}  // namespace gj
