// K6 — binary (±1) convolution backward, weight gradient, with the
// latent weight's straight-through estimator fused into its epilogue.
//
// Replaces the d(sign W) half of bdbnn_tpu/nn/kernels/binary_conv.py:
// 107-110 (jax.vjp of _forward: the conv weight gradient of xb and
// g * alpha) and the weight sign's ste_sign backward of
// bdbnn_tpu/nn/binarize.py:466-471 (BinarizerFamily.weight_sign):
//
//   dW[i, j, c, o] = 1{|W[i, j, c, o]| <= 1}
//                    * sum_{n, ho, wo} sx(n, ho*s - p + i, wo*s - p + j, c) * ga[n, ho, wo, o]
//   sx = sign(x - shift[c]) with sign(0) = +1 and 0 in the zero padding
//   (the reference pads the binarized input: a padding tap adds 0),
//   ga = g * alpha[o] formed in f32 first (the reference's order).
//
// Layouts: g f32 NHWC (N, Ho, Wo, O); x f32 NHWC; shift f32 (C,) or
// NULL; W and dW f32 HWIO = (kh*kw*C, O) row-major, the latent
// parameter's own layout; partial f32 (splits, kh*kw*C, O) scratch.
//
// Bound on the H100: the f32 operations of a GEMM of kh*kw*C x O
// outputs reduced over M = N*Ho*Wo (f32 g, so no int8 tensor cores),
// beside the bytes of x and g. The output is small (9 x 64 tiles of 64
// at layer1) and M is large (100,352 at batch 32), so M is split over
// the grid's z dimension: each block sums its contiguous share of M
// into its own slice of `partial` (the activation sign is taken while
// the x tile is loaded, as K1 does, so the ±1 activation is never
// stored for the backward), and a second kernel adds the slices in
// split order and applies the STE mask. No float atomics: the split
// count is a function of the shapes alone, so two runs give the same
// bits.
#include "common.cuh"

namespace {

constexpr int BM = 64;  // reduction-index rows (i, j, c) a block
constexpr int BN = 64;  // output channels a block
constexpr int BK = 16;  // positions a shared-memory stage
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
binary_conv_wgrad_partial_kernel(const float* __restrict__ g, const float* __restrict__ x,
                                 const float* __restrict__ shift, const float* __restrict__ alpha,
                                 float* __restrict__ partial, int N, int H, int W, int C, int O,
                                 int kh, int kw, int stride, int pad, int Ho, int Wo,
                                 long long rows_per_split) {
    __shared__ float As[BK][BM + 4];
    __shared__ float Bs[BK][BN + 4];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int Kd = kh * kw * C;
    const int k0 = blockIdx.x * BM;
    const int o0 = blockIdx.y * BN;
    const long long M = (long long)N * Ho * Wo;
    const long long mbeg = (long long)blockIdx.z * rows_per_split;
    const long long mend = min(M, mbeg + rows_per_split);

    // sign loads: lane -> reduction index (64), rows am + 4 r
    const int ak = tid % BM;
    const int am = tid / BM;
    const int kidx = k0 + ak;
    const bool kvalid = kidx < Kd;
    const Tap tap = decode_tap(kvalid ? kidx : 0, kw, C);
    const float s = (shift != nullptr && kvalid) ? shift[tap.c] : 0.f;
    // ga loads: lane -> output channel (64), rows bm + 4 r
    const int bo = tid % BN;
    const int bm = tid / BN;
    const int ob = o0 + bo;
    const float al = ob < O ? alpha[ob] : 0.f;

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (long long m0 = mbeg; m0 < mend; m0 += BK) {
#pragma unroll
        for (int r = 0; r < BK / 4; ++r) {
            const OutRow row = decode_row(m0 + am + 4 * r, mend, H, W, C, Ho, Wo, stride, pad);
            As[am + 4 * r][ak] = (float)act_sign(x, row, tap, kvalid, s, H, W, C);
        }
#pragma unroll
        for (int r = 0; r < BK / 4; ++r) {
            const long long m = m0 + bm + 4 * r;
            Bs[bm + 4 * r][bo] = (m < mend && ob < O) ? __fmul_rn(g[m * O + ob], al) : 0.f;
        }
        __syncthreads();
        float part[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) part[a][b] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float av[4], bv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) av[a] = As[kk][ty + 16 * a];
#pragma unroll
            for (int b = 0; b < 4; ++b) bv[b] = Bs[kk][tx + 16 * b];
            // one factor is ±1 or 0: the product is exact, so the FMA
            // rounds as a separate multiply and add would
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) part[a][b] = fmaf(av[a], bv[b], part[a][b]);
        }
        // blocked summation: each stage's 16 products are summed on their
        // own and then added to the total, which keeps the rounding error
        // of a long reduction near that of its 16-term blocks
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = __fadd_rn(acc[a][b], part[a][b]);
        __syncthreads();
    }

    float* out = partial + (long long)blockIdx.z * Kd * O;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int k = k0 + ty + 16 * a;
        if (k >= Kd) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int o = o0 + tx + 16 * b;
            if (o < O) out[(long long)k * O + o] = acc[a][b];
        }
    }
}

__global__ void __launch_bounds__(THREADS)
binary_conv_wgrad_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ w,
                                float* __restrict__ dw, long long KO, int splits) {
    const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (e >= KO) return;
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s = __fadd_rn(s, partial[(long long)z * KO + e]);
    // the reference's g * (|W| <= 1).astype(g.dtype): a masked entry is
    // s * 0, which keeps the sign of zero
    dw[e] = __fmul_rn(s, fabsf(w[e]) <= 1.f ? 1.f : 0.f);
}

}  // namespace

BDBNN_EXPORT int bdbnn_binary_conv_wgrad(const void* g, const void* x, const void* shift,
                                         const void* w, const void* alpha, void* partial,
                                         void* dw, int N, int H, int W, int C, int O, int kh,
                                         int kw, int stride, int pad, int Ho, int Wo, int splits,
                                         long long rows_per_split, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int Kd = kh * kw * C;
    const dim3 grid((unsigned)((Kd + BM - 1) / BM), (unsigned)((O + BN - 1) / BN),
                    (unsigned)splits);
    binary_conv_wgrad_partial_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<const float*>(shift), static_cast<const float*>(alpha),
        static_cast<float*>(partial), N, H, W, C, O, kh, kw, stride, pad, Ho, Wo,
        rows_per_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long KO = (long long)Kd * O;
    binary_conv_wgrad_reduce_kernel<<<(unsigned)((KO + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        static_cast<const float*>(partial), static_cast<const float*>(w), static_cast<float*>(dw),
        KO, splits);
    return (int)cudaGetLastError();
}
