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
