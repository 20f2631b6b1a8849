// Shared helpers of the hand-written kernels. Each .cu file is built on
// its own into a shared library with a plain C interface (see
// nn/kernels/_build.py); every entry returns cudaGetLastError() of its
// launch so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BDBNN_EXPORT extern "C" __attribute__((visibility("default")))

// The sign estimators whose backward K5 fuses, by the codes of
// nn/kernels/binary_conv.py ESTIMATORS
enum { EST_NONE = -1, EST_APPROX = 0, EST_STE = 1, EST_EDE = 2, EST_PROX = 3 };

BDBNN_EXPORT const char* bdbnn_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The stochastic binarizer's sampled sign (bdbnn_tpu/nn/binarize.py
// stoch_sign): +1 iff u < clip((x + 1) * 0.5, 0, 1), in the reference's
// f32 order (the add rounds, then an exact halving; no contraction).
__device__ __forceinline__ bool stoch_sign_plus(float x, float u) {
    const float p = fminf(fmaxf(__fmul_rn(__fadd_rn(x, 1.f), 0.5f), 0.f), 1.f);
    return u < p;
}

__device__ __forceinline__ float round_to_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// The same in the bf16 mode: x and u are bf16 values, and the reference's
// bf16 add rounds x + 1 to bf16 before the (exact) halving.
__device__ __forceinline__ bool stoch_sign_plus_bf16(float x, float u) {
    const float p = fminf(fmaxf(__fmul_rn(round_to_bf16(__fadd_rn(x, 1.f)), 0.5f), 0.f), 1.f);
    return u < p;
}

// Element loads of f32 activations: one value; and 4 consecutive values
// from a 16-byte aligned address.
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void load4_f(const float* p, float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
}

// The weight sign padded to CP channels a tap (zero beyond C): byte i of
// wpad (rows, CP) from wsign (rows, C)
__device__ __forceinline__ int8_t padded_weight_sign(const int8_t* __restrict__ wsign,
                                                     long long i, int C, int CP) {
    const long long row = i / CP;
    const int c = (int)(i - row * CP);
    return c < C ? wsign[row * C + c] : (int8_t)0;
}
