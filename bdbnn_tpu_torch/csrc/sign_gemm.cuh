// The forward binary conv as an implicit GEMM on the integer tensor
// cores, shared by K1 (binary_conv.cu: int8 ±1, mma.sync m16n8k32 s8)
// and K4 (packed.cu: 1-bit words, mma.sync m16n8k256 b1 AND-popc).
//
// Rows are output positions m = (n * Ho + ho) * Wo + wo, columns output
// channels o, and the reduction runs over the bytes kb = tap * CPB + cb
// of the two operands:
// - sx holds CPB bytes for every input pixel (NHWC, the channels padded
//   with zeros), written by the caller's prep pass. The im2col row of m
//   at tap (i, j) is the pixel (ho * s - p + i, wo * s - p + j); a tap in
//   the zero padding is zero-filled in shared memory, never loaded.
// - wk is (O, KK * CPB) bytes, k-contiguous for each o: the .col B
//   operand as it comes.
// CPB is a multiple of the copy size, so every copy lies in one tap.
//
// A block owns BM = 128 positions x BN = 64 channels, 4 warps of 64 x 32.
// The reduction is staged through a 4-stage ring of cp.async copies
// (sg::Stage: K1 takes 64 bytes a stage in 16-byte copies; K4, whose
// rows are 8 times shorter, 32 bytes in 8-byte copies), and both
// operands reach the MMA by ldmatrix: the int8 (k = 32) and the b1
// (k = 256) fragments share one byte layout, a thread holding 4 bytes of
// a row in each register. The
// int32 accumulators are exact (|dot| <= K), and each caller writes its
// own epilogue from them (sign_gemm_for_each).
#pragma once

#include "async_copy.cuh"

namespace {
namespace sg {

constexpr int BM = 128;       // positions a block
constexpr int BN = 64;        // output channels a block
constexpr int NSTAGE = 4;     // cp.async ring depth
constexpr int THREADS = 128;  // 4 warps: 2 (positions) x 2 (channels)

// A stage of BKB reduction bytes, copied CH bytes at a time
template <int BKB_, int CH_>
struct Stage {
    static constexpr int BKB = BKB_;
    static constexpr int CH = CH_;
    static constexpr int PITCH = BKB + 16;  // bytes a shared row: the 8 rows an
                                            // ldmatrix reads fall on distinct banks
    static constexpr int A_STAGE = BM * PITCH;
    static constexpr int B_STAGE = BN * PITCH;
    static constexpr int SMEM_BYTES = NSTAGE * (A_STAGE + B_STAGE);
    static constexpr int ROWS_PASS = THREADS / (BKB / CH);  // rows a copy pass
    static_assert(BKB % 32 == 0 && BM % ROWS_PASS == 0 && BN % ROWS_PASS == 0, "loaders");
};

}  // namespace sg

struct ConvGeom {
    long long M;  // N * Ho * Wo
    int H, W, O, kw, KK, stride, pad, Ho, Wo, CPB;
};

template <bool BITS>
__device__ __forceinline__ void mma_int(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
    if constexpr (BITS) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
}

// The block's (blockIdx.x: positions, blockIdx.y: channels) integer dots
// into acc[mi][nj][e] (see sign_gemm_for_each for the element of each).
template <bool BITS, class S>
__device__ __forceinline__ void sign_gemm_mainloop(const uint8_t* __restrict__ sx,
                                                   const uint8_t* __restrict__ wk,
                                                   const ConvGeom& g, unsigned char* smem,
                                                   int (&acc)[4][4][4]) {
    using namespace sg;
    constexpr int BKB = S::BKB, CH = S::CH, PITCH = S::PITCH, ROWS_PASS = S::ROWS_PASS;
    constexpr int A_STAGE = S::A_STAGE, B_STAGE = S::B_STAGE;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp >> 1;
    const int wn = warp & 1;
    const long long m0 = (long long)blockIdx.x * BM;
    const int o0 = blockIdx.y * BN;
    const long long KB = (long long)g.KK * g.CPB;

    // loader: a thread copies column qc (CH bytes) of rows qr + u *
    // ROWS_PASS of both operands; its positions are decoded once
    const int qc = tid % (BKB / CH);
    const int qr = tid / (BKB / CH);
    auto copy = [](uint32_t dst, const void* src, bool ok) {
        if constexpr (CH == 16)
            cp_async16(dst, src, ok);
        else
            cp_async8(dst, src, ok);
    };
    long long apix[BM / ROWS_PASS];  // pixel index of image n's (0, 0)
    int ah0[BM / ROWS_PASS], aw0[BM / ROWS_PASS];
#pragma unroll
    for (int u = 0; u < BM / ROWS_PASS; ++u) {
        const long long m = m0 + qr + u * ROWS_PASS;
        apix[u] = 0;
        ah0[u] = -(1 << 24);  // a row past the end: every tap is outside
        aw0[u] = 0;
        if (m < g.M) {
            const long long hw = (long long)g.Ho * g.Wo;
            const long long n = m / hw;
            const int rem = (int)(m - n * hw);
            const int ho = rem / g.Wo;
            apix[u] = n * g.H * g.W;
            ah0[u] = ho * g.stride - g.pad;
            aw0[u] = (rem - ho * g.Wo) * g.stride - g.pad;
        }
    }
    auto load_stage = [&](int buf, long long kb0) {
        const long long kb = kb0 + qc * CH;
        const bool kok = kb < KB;
        const int tap = kok ? (int)(kb / g.CPB) : 0;
        const int cb = (int)(kb - (long long)tap * g.CPB);
        const int ti = tap / g.kw;
        const int tj = tap - ti * g.kw;
        const uint32_t adst = smem_u32(smem + buf * A_STAGE + qr * PITCH + qc * CH);
#pragma unroll
        for (int u = 0; u < BM / ROWS_PASS; ++u) {
            const int hi = ah0[u] + ti;
            const int wi = aw0[u] + tj;
            const bool ok = kok && (unsigned)hi < (unsigned)g.H && (unsigned)wi < (unsigned)g.W;
            copy(adst + u * ROWS_PASS * PITCH,
                 ok ? sx + (apix[u] + (long long)hi * g.W + wi) * g.CPB + cb : sx, ok);
        }
        const uint32_t bdst =
            smem_u32(smem + NSTAGE * A_STAGE + buf * B_STAGE + qr * PITCH + qc * CH);
#pragma unroll
        for (int u = 0; u < BN / ROWS_PASS; ++u) {
            const int o = o0 + qr + u * ROWS_PASS;
            const bool ok = kok && o < g.O;
            copy(bdst + u * ROWS_PASS * PITCH, ok ? wk + (long long)o * KB + kb : wk, ok);
        }
    };

    const int nst = (int)((KB + BKB - 1) / BKB);
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (s < nst) load_stage(s, (long long)s * BKB);
        cp_async_commit();
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

    for (int it = 0; it < nst; ++it) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();  // stage it has landed; stage it - 1's buffer is free
        if (it + NSTAGE - 1 < nst)
            load_stage((it + NSTAGE - 1) % NSTAGE, (long long)(it + NSTAGE - 1) * BKB);
        cp_async_commit();
        const unsigned char* Ab = smem + (it % NSTAGE) * A_STAGE;
        const unsigned char* Bb = smem + NSTAGE * A_STAGE + (it % NSTAGE) * B_STAGE;
#pragma unroll
        for (int ks = 0; ks < BKB; ks += 32) {
            // A: matrix q of the x4 is rows + (q & 1) * 8, bytes + (q >> 1) * 16
            uint32_t af[4][4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
                ldsm_x4(smem_u32(Ab + (wm * 64 + mi * 16 + (lane & 15)) * PITCH + ks +
                                 (lane >> 4) * 16),
                        af[mi][0], af[mi][1], af[mi][2], af[mi][3]);
            // B: matrix q is channels + (q >> 1) * 8, bytes + (q & 1) * 16
            uint32_t bf[4][2];
#pragma unroll
            for (int nj = 0; nj < 4; nj += 2)
                ldsm_x4(smem_u32(Bb + (wn * 32 + nj * 8 + (lane & 7) + (lane >> 4) * 8) * PITCH +
                                 ks + ((lane >> 3) & 1) * 16),
                        bf[nj][0], bf[nj][1], bf[nj + 1][0], bf[nj + 1][1]);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int nj = 0; nj < 4; ++nj) mma_int<BITS>(acc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
        }
    }
    cp_async_wait<0>();
}

// f(row in the block, channel in the block, dot, dot of channel + 1) for
// each pair of neighbouring accumulators of this thread
template <class F>
__device__ __forceinline__ void sign_gemm_for_each(const int (&acc)[4][4][4], F&& f) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
                f((warp >> 1) * 64 + mi * 16 + (lane >> 2) + half * 8,
                  (warp & 1) * 32 + nj * 8 + (lane & 3) * 2, acc[mi][nj][half * 2],
                  acc[mi][nj][half * 2 + 1]);
}

// y[m, o] = dot * alpha[o] (one f32 multiply, the reference's epilogue)
// for the channel pair (o, o + 1) of row m
__device__ __forceinline__ void store_scaled(float* __restrict__ y, const float* __restrict__ alpha,
                                             long long m, int o, int O, int d0, int d1) {
    float* row = y + m * O;
    if ((O & 1) == 0 && o + 1 < O) {
        *reinterpret_cast<float2*>(row + o) =
            make_float2(__fmul_rn((float)d0, alpha[o]), __fmul_rn((float)d1, alpha[o + 1]));
    } else {
        if (o < O) row[o] = __fmul_rn((float)d0, alpha[o]);
        if (o + 1 < O) row[o + 1] = __fmul_rn((float)d1, alpha[o + 1]);
    }
}

}  // namespace
