// Hopper (sm_90a) building blocks of the bf16-mode kernels (K1 bf16,
// binary_conv_fwd_bf16.cu; K5 bf16, binary_conv_dgrad_bf16.cu; K6 bf16,
// binary_conv_wgrad_bf16.cu):
//
// - wgmma shared-memory matrix descriptors. In the no-swizzle
//   ("interleave") canonical layout the operand is cut into core
//   matrices of 8 rows x 16 bytes, each stored as 128 contiguous bytes;
//   LBO is the byte stride between core matrices adjacent along K, SBO
//   between core matrices adjacent along M/N. For a K-major operand a
//   16-byte row holds 16 bytes of K of one M/N index; for an MN-major one
//   (transpose bit set, bf16 only) it holds 8 M/N values of one K index.
//   The 64-byte swizzle takes a K-major operand as TMA lands it;
// - wgmma.mma_async with A from registers (the mma.sync A fragment of
//   each warp's 16 rows) and B from shared memory: m64n64k16 and m64n32k16
//   bf16 with f32 accumulators, m64n64k32 s8 with s32 accumulators; fence, commit,
//   wait, and the operand fences that keep nvcc from touching the
//   registers of a product in flight; setmaxnreg between warpgroups;
// - mbarriers (a producer/consumer ring, TMA completion) and 2D TMA
//   loads (cp.async.bulk.tensor) completing on them;
// - chunks of 8 bf16 values in a uint4: its words, the two values of a
//   word as f32, a load of up to 8 values (zero beyond);
// - what the two backward kernels share: their operand bf16(g * alpha),
//   and the fold of a wgmma chain's f32 sums into f64 totals.
#pragma once

#include "async_copy.cuh"

#include <cuda.h>

namespace {

// layout: 0 no swizzle, 2 the 64-byte swizzle (TMA's SWIZZLE_64B: 8 rows
// of 64 bytes an atom, the atom 512-byte aligned; LBO unused, SBO the
// stride between atoms; a k step inside the row advances the start
// address)
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout = 0) {
    // start address >> 4 (14 bits), LBO >> 4 at bit 16, SBO >> 4 at bit
    // 32, base offset 0, layout type at bits 62-63
    return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers of a wgmma: after a wait, the accumulators are "written"
// here, so no read of them moves above it; the A fragment is "read"
// here, so its registers stay untouched until the product has read them
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(const uint32_t (&a)[4]) {
    asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

#define BDBNN_D32(T)                                                                        \
    T(d[0]), T(d[1]), T(d[2]), T(d[3]), T(d[4]), T(d[5]), T(d[6]), T(d[7]), T(d[8]), T(d[9]), \
        T(d[10]), T(d[11]), T(d[12]), T(d[13]), T(d[14]), T(d[15]), T(d[16]), T(d[17]),       \
        T(d[18]), T(d[19]), T(d[20]), T(d[21]), T(d[22]), T(d[23]), T(d[24]), T(d[25]),       \
        T(d[26]), T(d[27]), T(d[28]), T(d[29]), T(d[30]), T(d[31])
#define BDBNN_PLUS_F(x) "+f"(x)
#define BDBNN_PLUS_R(x) "+r"(x)
#define BDBNN_REGS32                                                                       \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32, this thread's 32) = a (64 x 16 bf16, registers) ·
// b (16 x 64 bf16, MN-major in shared memory) + (scale_d ? d : 0).
// Thread (warp w of the warpgroup, lane) holds d[4j + e] at row 16w +
// lane/4 + 8(e >> 1), column 8j + 2(lane % 4) + (e & 1).
__device__ __forceinline__ void wgmma_bf16_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BDBNN_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : BDBNN_D32(BDBNN_PLUS_F)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#define BDBNN_D16(T)                                                                        \
    T(d[0]), T(d[1]), T(d[2]), T(d[3]), T(d[4]), T(d[5]), T(d[6]), T(d[7]), T(d[8]), T(d[9]), \
        T(d[10]), T(d[11]), T(d[12]), T(d[13]), T(d[14]), T(d[15])
#define BDBNN_REGS16 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32 f32, this thread's 16) = a (64 x 16 bf16, registers) ·
// b (16 x 32 bf16, MN-major in shared memory) + (scale_d ? d : 0); the
// accumulator layout as above, j < 4
__device__ __forceinline__ void wgmma_bf16_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " BDBNN_REGS16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : BDBNN_D16(BDBNN_PLUS_F)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64 s32) = a (64 x 32 s8, registers) · b (32 x 64 s8, K-major in
// shared memory) + (scale_d ? d : 0); the accumulator layout as above
__device__ __forceinline__ void wgmma_s8_m64n64k32(int (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " BDBNN_REGS32
        ", {%32, %33, %34, %35}, %36, p;\n}\n"
        : BDBNN_D32(BDBNN_PLUS_R)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Hand registers between the warpgroups of a warp-specialized kernel
// (every warp of the warpgroup runs it; the count is a multiple of 8)
template <int N>
__device__ __forceinline__ void regs_release() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_claim() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Make this thread's generic-proxy writes to shared memory visible to
// the async proxy (wgmma's reads of a B tile stored by st.shared)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}
// Wait for the phase of parity `parity` to complete; a warp that has to
// wait sleeps between polls, leaving its issue slots to the warps at work
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    while (!mbar_try_wait(bar, parity)) __nanosleep(32);
}

// One 2D TMA box from the tensor map (in kernel parameter space) to
// shared memory at coordinates (c0 innermost, c1), completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// A word of a chunk of 8 bf16 values, and its two values as f32
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set_word(uint4& v, int i, uint32_t p) {
    if (i == 0) v.x = p;
    else if (i == 1) v.y = p;
    else if (i == 2) v.z = p;
    else v.w = p;
}
__device__ __forceinline__ float lo_f(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

// bf16(g * alpha) of the two bf16 values of a word each: the product of
// two bf16 values is exact in f32, then rounded once, as the reference's
// bf16 multiply
__device__ __forceinline__ uint32_t ga_bf16x2(uint32_t gp, uint32_t ap) {
    const __nv_bfloat162 pr = __floats2bfloat162_rn(__fmul_rn(lo_f(gp), lo_f(ap)),
                                                    __fmul_rn(hi_f(gp), hi_f(ap)));
    return *reinterpret_cast<const uint32_t*>(&pr);
}

// A wgmma chain's f32 sums added into f64 totals (the conversion is exact,
// the add on the f64 pipe)
template <int N>
__device__ __forceinline__ void fold_f64(double (&tot)[N], const float (&acc)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) tot[i] = __dadd_rn(tot[i], (double)acc[i]);
}

// 8 bf16 values from p (up to n of them; zero beyond) into one uint4: one
// 16-byte load where vec (p 16-byte aligned) and n >= 8
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int n, bool vec) {
    if (vec && n >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 8; ++e)
        if (e < n) w[e >> 1] |= (uint32_t)__bfloat16_as_ushort(p[e]) << (16 * (e & 1));
    return make_uint4(w[0], w[1], w[2], w[3]);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
