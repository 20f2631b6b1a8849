// Shared pieces of the binary conv backward kernels on the bf16 tensor
// cores (K5 binary_conv_dgrad.cu, K6 binary_conv_wgrad.cu):
//
// - the exact three-piece bf16 split of f32 g * alpha: hi = bf16(ga),
//   mid = bf16(ga - hi), lo = ga - hi - mid, each subtraction exact in
//   f32, so hi + mid + lo == ga and each piece times ±1 (or 0) is an
//   exact bf16 product (nn/kernels/binary_conv.py:split_bf16x3 is its
//   plain version);
// - in the bf16 mode (a bf16 model), the one piece ga = bf16(g * alpha)
//   of bf16 g and alpha: the reference's bf16 multiply;
// - mma.sync m16n8k16 bf16 with f32 accumulators (the cp.async and
//   ldmatrix helpers it is fed by are in async_copy.cuh);
// - the compensated (Kahan) add of a k step's sum into an f32 total, with
//   _rn intrinsics so nvcc cannot contract or reorder it.
#pragma once

#include "async_copy.cuh"

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) {
    return (uint32_t)__bfloat16_as_ushort(v);
}

// ga split into three bf16 pieces with hi + mid + lo == ga exactly
__device__ __forceinline__ void split3(float ga, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
    const __nv_bfloat16 h = __float2bfloat16_rn(ga);
    const float r = __fsub_rn(ga, __bfloat162float(h));
    const __nv_bfloat16 m = __float2bfloat16_rn(r);
    hi = bf16_bits(h);
    mid = bf16_bits(m);
    lo = bf16_bits(__float2bfloat16_rn(__fsub_rn(r, __bfloat162float(m))));
}

// One work item of the split pass: ga = g * alpha (the reference's f32
// multiply) for o0 .. o0 + 7 of g row `row`, written to gs (rows, 3, OP)
// as three whole 16-byte rows of hi, mid, lo; zero beyond O.
__device__ __forceinline__ void split_ga8(const float* __restrict__ g,
                                          const float* __restrict__ alpha,
                                          __nv_bfloat16* __restrict__ gs, long long row, int o0,
                                          int O, int OP) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const int o = o0 + e;
        v[e] = o < O ? __fmul_rn(g[row * O + o], alpha[o]) : 0.f;
    }
    uint32_t p[3][4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
        uint32_t h0, m0, l0, h1, m1, l1;
        split3(v[e], h0, m0, l0);
        split3(v[e + 1], h1, m1, l1);
        p[0][e / 2] = h0 | (h1 << 16);
        p[1][e / 2] = m0 | (m1 << 16);
        p[2][e / 2] = l0 | (l1 << 16);
    }
    __nv_bfloat16* dst = gs + row * 3 * OP + o0;
#pragma unroll
    for (int q = 0; q < 3; ++q)
        *reinterpret_cast<uint4*>(dst + q * OP) = make_uint4(p[q][0], p[q][1], p[q][2], p[q][3]);
}

// The bf16 mode's split pass item: ga = bf16(g * alpha) (the product of
// two bf16 values is exact in f32, then rounded once, as the reference's
// bf16 multiply) for o0 .. o0 + 7 of g row `row`, written to gs (rows,
// 1, OP) as one 16-byte row; zero beyond O.
__device__ __forceinline__ void split_ga8(const __nv_bfloat16* __restrict__ g,
                                          const __nv_bfloat16* __restrict__ alpha,
                                          __nv_bfloat16* __restrict__ gs, long long row, int o0,
                                          int O, int OP) {
    uint32_t p[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
        uint32_t b[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int o = o0 + e + q;
            b[q] = o < O ? bf16_bits(__float2bfloat16_rn(__fmul_rn(
                               __bfloat162float(g[row * O + o]), __bfloat162float(alpha[o]))))
                         : 0u;
        }
        p[e / 2] = b[0] | (b[1] << 16);
    }
    *reinterpret_cast<uint4*>(gs + row * OP + o0) = make_uint4(p[0], p[1], p[2], p[3]);
}

// d += a · b on the tensor cores: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc + comp holds a compensated total (acc - comp is its value); add d
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float d) {
    const float y = __fsub_rn(d, comp);
    const float t = __fadd_rn(acc, y);
    comp = __fsub_rn(__fsub_rn(t, acc), y);
    acc = t;
}

}  // namespace
