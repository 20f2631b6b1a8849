// Shared helpers of the hand-written kernels. Each .cu file is built on
// its own into a shared library with a plain C interface (see
// nn/kernels/_build.py); every entry returns cudaGetLastError() of its
// launch so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BDBNN_EXPORT extern "C" __attribute__((visibility("default")))

BDBNN_EXPORT const char* bdbnn_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Position of output row m (= ((n * Ho) + ho) * Wo + wo of an NHWC
// output) in the zero-padded input: image n and the input coordinates
// of its (0, 0) tap.
struct OutRow {
    long long base;  // n * H * W * C, or -1 for a row past the end
    int h0;          // ho * stride - pad
    int w0;          // wo * stride - pad
};

__device__ __forceinline__ OutRow decode_row(long long m, long long M, int H, int W,
                                             int C, int Ho, int Wo, int stride,
                                             int pad) {
    OutRow r;
    if (m >= M) {
        r.base = -1;
        r.h0 = 0;
        r.w0 = 0;
        return r;
    }
    const long long hw = (long long)Ho * Wo;
    const long long n = m / hw;
    const int rem = (int)(m - n * hw);
    const int ho = rem / Wo;
    const int wo = rem - ho * Wo;
    r.base = n * H * W * C;
    r.h0 = ho * stride - pad;
    r.w0 = wo * stride - pad;
    return r;
}

// Tap (i, j, c) of reduction index k in HWIO flatten order
// k = (i * kw + j) * C + c — the order of the weight sign rows.
struct Tap {
    int i, j, c;
};

__device__ __forceinline__ Tap decode_tap(int k, int kw, int C) {
    Tap t;
    t.c = k % C;
    const int ij = k / C;
    t.j = ij % kw;
    t.i = ij / kw;
    return t;
}

// The activation's ±1 sign at reduction index k of output row r, with
// the reference's convention sign(0) := +1 applied to (x - shift), and
// 0 for a tap that falls in the zero padding: the reference pads the
// already-binarized input, so a padding tap contributes 0, never
// sign(0 - shift). Returns 0 (padding or k >= K), +1 or -1.
__device__ __forceinline__ int act_sign(const float* __restrict__ x, const OutRow& r,
                                        const Tap& t, bool kvalid, float s, int H,
                                        int W, int C) {
    if (!kvalid || r.base < 0) return 0;
    const int hi = r.h0 + t.i;
    const int wi = r.w0 + t.j;
    if (hi < 0 || hi >= H || wi < 0 || wi >= W) return 0;
    const float v = x[r.base + ((long long)hi * W + wi) * C + t.c] - s;
    return v >= 0.f ? 1 : -1;
}
