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

// The stochastic binarizer's sampled sign (bdbnn_tpu/nn/binarize.py
// stoch_sign): +1 iff u < clip((x + 1) * 0.5, 0, 1), in the reference's
// f32 order (the add rounds, then an exact halving; no contraction).
__device__ __forceinline__ bool stoch_sign_plus(float x, float u) {
    const float p = fminf(fmaxf(__fmul_rn(__fadd_rn(x, 1.f), 0.5f), 0.f), 1.f);
    return u < p;
}
