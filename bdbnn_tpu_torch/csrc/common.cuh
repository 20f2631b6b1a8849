// Shared helpers of the hand-written kernels. Each .cu file is built on
// its own into a shared library with a plain C interface (see
// nn/kernels/_build.py); every entry returns cudaGetLastError() of its
// launch so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BDBNN_EXPORT extern "C" __attribute__((visibility("default")))

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

// Element loads of the kernels that take f32 or bf16 activations: one
// value as f32, and 4 consecutive values from an aligned address (16
// bytes of f32, 8 of bf16).
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void load4_f(const float* p, float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
}
__device__ __forceinline__ void load4_f(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
}

// The activation sign of the stochastic family: bf16 operands take the
// reference's bf16 ops
template <typename T>
__device__ __forceinline__ bool stoch_plus(float x, float u) {
    if constexpr (sizeof(T) == 2)
        return stoch_sign_plus_bf16(x, u);
    else
        return stoch_sign_plus(x, u);
}
