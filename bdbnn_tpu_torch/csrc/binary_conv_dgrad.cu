// K5 — binary (±1) convolution backward, input gradient, with the
// activation sign estimator's backward fused into its epilogue.
//
// Replaces the dx half of bdbnn_tpu/nn/kernels/binary_conv.py:107-110
// (jax.vjp of _forward: conv_transpose(g * alpha, sign W)) and the
// backward rules of bdbnn_tpu/nn/binarize.py (ste / approx / ede / prox
// sign), applied to the conv's pre-sign input (react's x - act_shift):
//
//   dx[n, h, w, c] = slope(x[n, h, w, c] - shift[c])
//                    * sum_{i, j, o} ga[n, ho, wo, o] * wsign[o, i, j, c]
//   over the taps with h = ho*s - p + i, w = wo*s - p + j (a stride-2
//   tap whose h + p - i is odd lands on no output and adds nothing),
//   ga = g * alpha[o] formed in f32 first (the reference's order).
//
//   slope: approx max(0, 2 - 2|v|); ste 1{|v| <= 1};
//          ede   k*t*sech(t*v)^2 (sech = 1/cosh, computed directly);
//          prox  (2/d) * max(0, 1 - |v|/d);  none: 1.
//
// Layouts: g f32 NHWC (N, Ho, Wo, O); x f32 NHWC (N, H, W, C); shift f32
// (C,) or NULL; wsign int8 (O, kh, kw, C) as K2 writes it; alpha f32
// (O,); dx f32 NHWC (N, H, W, C).
//
// Bound on the H100: an implicit GEMM of M = N*H*W rows, N = C columns
// and K = kh*kw*O, on f32 g (not ±1: the products are exact, the sums
// are not), so the operations bound it at the f32 rate (67 TFLOP/s,
// no tensor cores) beside the bytes of g, x and dx. The design: 64x64
// output tiles, 256 threads with a 4x4 block each; a 16-deep stage
// stages ga (the alpha multiply done at load) and the weight sign (int8
// read, widened to ±1.0f) in shared memory; the sign estimator's slope
// is applied in registers at the store, so the estimator backward never
// makes its own pass over device memory. Every product is exact; each
// output is a blocked f32 sum (16 products a stage, then the stage sums
// in order). No tensor cores or asynchronous copies yet.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

enum { EST_NONE = -1, EST_APPROX = 0, EST_STE = 1, EST_EDE = 2, EST_PROX = 3 };

// The estimator's slope at pre-sign value v, with the reference's order
// of f32 operations (the _rn intrinsics keep nvcc from contracting them
// into an FMA, which rounds once where the reference rounds twice).
__device__ __forceinline__ float est_slope(float v, int est, float p0, float p1) {
    switch (est) {
        case EST_APPROX:
            return fmaxf(__fsub_rn(2.f, __fmul_rn(2.f, fabsf(v))), 0.f);
        case EST_STE:
            return fabsf(v) <= 1.f ? 1.f : 0.f;
        case EST_EDE: {  // p0 = t, p1 = k
            const float sech = __fdiv_rn(1.f, coshf(__fmul_rn(p0, v)));
            return __fmul_rn(__fmul_rn(__fmul_rn(p1, p0), sech), sech);
        }
        case EST_PROX:  // p0 = delta
            return __fmul_rn(__fdiv_rn(2.f, p0),
                             fmaxf(__fsub_rn(1.f, __fdiv_rn(fabsf(v), p0)), 0.f));
        default:
            return 1.f;
    }
}

__global__ void __launch_bounds__(THREADS)
binary_conv_dgrad_kernel(const float* __restrict__ g, const float* __restrict__ x,
                         const float* __restrict__ shift, const int8_t* __restrict__ wsign,
                         const float* __restrict__ alpha, float* __restrict__ dx, int N, int H,
                         int W, int C, int O, int kh, int kw, int stride, int pad, int Ho,
                         int Wo, int est, float p0, float p1) {
    __shared__ float As[BK][BM + 4];
    __shared__ float Bs[BK][BN + 4];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const long long M = (long long)N * H * W;
    const long long m0 = (long long)blockIdx.x * BM;
    const int c0 = blockIdx.y * BN;
    const int KK = kh * kw;
    const int K = KK * O;

    // ga loads: lane -> reduction index (16), rows ar + 16 r
    const int ak = tid % BK;
    const int ar = tid / BK;
    long long gbase[BM / 16];
    int hp[BM / 16], wp[BM / 16];
#pragma unroll
    for (int r = 0; r < BM / 16; ++r) {
        const long long m = m0 + ar + 16 * r;
        if (m < M) {
            const long long hw = (long long)H * W;
            const long long n = m / hw;
            const int rem = (int)(m - n * hw);
            const int h = rem / W;
            gbase[r] = n * Ho * Wo * (long long)O;
            hp[r] = h + pad;
            wp[r] = rem - h * W + pad;
        } else {
            gbase[r] = -1;
            hp[r] = 0;
            wp[r] = 0;
        }
    }
    // weight-sign loads: lane -> channel (64), rows bk + 4 r
    const int bc = tid % BN;
    const int bk = tid / BN;

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        {
            const int k = k0 + ak;
            const bool kvalid = k < K;
            const int t = kvalid ? k / O : 0;
            const int o = kvalid ? k - t * O : 0;
            const int i = t / kw;
            const int j = t - i * kw;
            const float al = kvalid ? alpha[o] : 0.f;
#pragma unroll
            for (int r = 0; r < BM / 16; ++r) {
                float v = 0.f;
                const int hn = hp[r] - i;
                const int wn = wp[r] - j;
                if (kvalid && gbase[r] >= 0 && hn >= 0 && wn >= 0 && hn % stride == 0 &&
                    wn % stride == 0) {
                    const int ho = hn / stride;
                    const int wo = wn / stride;
                    if (ho < Ho && wo < Wo)
                        v = __fmul_rn(g[gbase[r] + ((long long)ho * Wo + wo) * O + o], al);
                }
                As[ak][ar + 16 * r] = v;
            }
        }
#pragma unroll
        for (int r = 0; r < BK / 4; ++r) {
            const int k = k0 + bk + 4 * r;
            const int c = c0 + bc;
            float b = 0.f;
            if (k < K && c < C) {
                const int t = k / O;
                const int o = k - t * O;
                b = (float)wsign[((long long)o * KK + t) * C + c];
            }
            Bs[bk + 4 * r][bc] = b;
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

#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const long long m = m0 + ty + 16 * a;
        if (m >= M) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int c = c0 + tx + 16 * b;
            if (c >= C) continue;
            const long long e = m * C + c;
            const float v = shift != nullptr ? __fsub_rn(x[e], shift[c]) : x[e];
            dx[e] = __fmul_rn(acc[a][b], est_slope(v, est, p0, p1));
        }
    }
}

}  // namespace

BDBNN_EXPORT int bdbnn_binary_conv_dgrad(const void* g, const void* x, const void* shift,
                                         const void* wsign, const void* alpha, void* dx, int N,
                                         int H, int W, int C, int O, int kh, int kw, int stride,
                                         int pad, int Ho, int Wo, int est, float p0, float p1,
                                         void* stream) {
    const long long M = (long long)N * H * W;
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((C + BN - 1) / BN));
    binary_conv_dgrad_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<const float*>(shift), static_cast<const int8_t*>(wsign),
        static_cast<const float*>(alpha), static_cast<float*>(dx), N, H, W, C, O, kh, kw, stride,
        pad, Ho, Wo, est, p0, p1);
    return (int)cudaGetLastError();
}
