// The reference's 8-bit fixed-point colour transform
// (gpujpeg_colorspace.h:64-101) for the port's CUDA kernels, with the
// integer matrices of ops/color.py.  A transform is at most one "from"
// step (a YCbCr-like space -> RGB) and one "to" step (RGB -> a YCbCr-like
// space); ops/color.kernel_params builds the parameters, and a step is
// skipped when its flag is 0.

#pragma once

namespace gj {

struct ColorParams {
    int from_m[9];
    int from_b[3];
    int to_m[9];
    int to_b[3];
    int use_from;
    int use_to;
};

__device__ __forceinline__ int scale_255_to_256(int c) {
    // c * 256 / 255 with C truncation for c in (-255, 256)
    return c + (c >= 255 ? 1 : 0);
}

__device__ __forceinline__ int clamp255(int v) {
    return min(max(v, 0), 255);
}

__device__ __forceinline__ void convert(const ColorParams& p, int& c0,
                                        int& c1, int& c2) {
    if (p.use_from) {
        const int r0 = scale_255_to_256(c0 - p.from_b[0]);
        const int r1 = scale_255_to_256(c1 - p.from_b[1]);
        const int r2 = scale_255_to_256(c2 - p.from_b[2]);
        int o[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            // >> on a negative int is an arithmetic shift, as in the
            // reference and in ops/color.py
            o[i] = clamp255((r0 * p.from_m[3 * i] + r1 * p.from_m[3 * i + 1]
                             + r2 * p.from_m[3 * i + 2] + 128) >> 8);
        }
        c0 = o[0];
        c1 = o[1];
        c2 = o[2];
    }
    if (p.use_to) {
        const int r0 = scale_255_to_256(c0);
        const int r1 = scale_255_to_256(c1);
        const int r2 = scale_255_to_256(c2);
        int o[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            o[i] = clamp255(((r0 * p.to_m[3 * i] + r1 * p.to_m[3 * i + 1]
                              + r2 * p.to_m[3 * i + 2] + 128) >> 8)
                            + p.to_b[i]);
        }
        c0 = o[0];
        c1 = o[1];
        c2 = o[2];
    }
}

}  // namespace gj
