// K1 — fused activation sign + binary (±1) convolution, forward.
//
// Replaces bdbnn_tpu/nn/kernels/binary_conv.py:_make_binary_conv (the
// forward of binary_conv2d_mxu, conv(xb, sign W) * alpha) with the
// activation sign of bdbnn_tpu/nn/binarize.py (approx_sign / ste_sign
// forward, react's x - act_shift, nn/layers.py:BinaryConvReact) fused
// into its input load.
//
//   y[n, ho, wo, o] = alpha[o] * sum_{i, j, c} sx(n, ho*s - p + i, wo*s - p + j, c)
//                                            * wsign[o, i, j, c]
//   sx = sign(x - shift[c]) with sign(0) = +1, and 0 in the zero padding.
//
// Layouts: x f32 NHWC, shift f32 (C,) or NULL, wsign int8 (O, kh, kw, C)
// (= (O, K) row-major, K in HWIO flatten order), alpha f32 (O,), y f32
// NHWC (N, Ho, Wo, O) = (M, O) row-major.
//
// Bound on the H100: the work is an implicit GEMM of M = N*Ho*Wo,
// N = O, K = kh*kw*C. Counting x (f32, read once), the int8 weight sign
// and y (f32, written once), the flagship's convs do ~145 (layer1,
// 3x3 64->64) to ~840 (layer4, 3x3 512->512) int8 ops per byte against
// the card's ~590 (1979 int8 TOP/s over 3.35 TB/s): the early, wide
// layers are bound by bytes, the deep ones by int8 tensor-core
// operations. This first version runs on the CUDA cores (__dp4a), whose
// int8 rate is a small fraction of the tensor cores', so it sits well
// above either bound. The design keeps the binarized input out of
// device memory: the sign is taken
// while a 64x32 tile of the implicit im2col matrix is loaded into
// shared memory (as int8), so xb never exists in HBM; 64x32 int8 weight
// tiles sit beside it, and each of 256 threads accumulates a 4x4 block
// of outputs in int32 with __dp4a (4 MACs a instruction). Every ±1 dot
// is an exact integer (|dot| <= K <= 4608 < 2^24), so
// float(acc) * alpha[o] is the same single f32 multiply as the
// reference's (y * alpha) and the output is bitwise equal to it.
// Loads are coalesced along C (32 consecutive channels a warp). No
// cp.async/TMA pipelining and no tensor cores yet: a later PR makes it
// fast.
#include "common.cuh"

namespace {

constexpr int BM = 64;         // output rows (positions) a block
constexpr int BN = 64;         // output channels a block
constexpr int BK = 32;         // reduction depth a shared-memory stage
constexpr int LDS = BK + 4;    // row pitch in bytes: int-aligned, staggers banks
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / BK;  // 8

__global__ void __launch_bounds__(THREADS)
binary_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                       const int8_t* __restrict__ wsign, const float* __restrict__ alpha,
                       float* __restrict__ y, int N, int H, int W, int C, int O,
                       int kh, int kw, int stride, int pad, int Ho, int Wo) {
    __shared__ __align__(16) int8_t As[BM][LDS];
    __shared__ __align__(16) int8_t Bs[BN][LDS];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int lcol = tid % BK;
    const int lrow = tid / BK;
    const long long M = (long long)N * Ho * Wo;
    const long long m0 = (long long)blockIdx.x * BM;
    const int o0 = blockIdx.y * BN;
    const int K = kh * kw * C;

    OutRow rows[BM / ROWS_PER_PASS];
#pragma unroll
    for (int r = 0; r < BM / ROWS_PER_PASS; ++r)
        rows[r] = decode_row(m0 + lrow + r * ROWS_PER_PASS, M, H, W, C, Ho, Wo, stride, pad);

    int acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0;

    for (int k0 = 0; k0 < K; k0 += BK) {
        const int k = k0 + lcol;
        const bool kvalid = k < K;
        const Tap t = decode_tap(kvalid ? k : 0, kw, C);
        const float s = (shift != nullptr && kvalid) ? shift[t.c] : 0.f;
#pragma unroll
        for (int r = 0; r < BM / ROWS_PER_PASS; ++r)
            As[lrow + r * ROWS_PER_PASS][lcol] =
                (int8_t)act_sign(x, rows[r], t, kvalid, s, H, W, C);
#pragma unroll
        for (int r = 0; r < BN / ROWS_PER_PASS; ++r) {
            const int o = o0 + lrow + r * ROWS_PER_PASS;
            Bs[lrow + r * ROWS_PER_PASS][lcol] =
                (kvalid && o < O) ? wsign[(long long)o * K + k] : (int8_t)0;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 4) {
            int a4[4], b4[4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
                a4[a] = *reinterpret_cast<const int*>(&As[ty + 16 * a][kk]);
#pragma unroll
            for (int b = 0; b < 4; ++b)
                b4[b] = *reinterpret_cast<const int*>(&Bs[tx + 16 * b][kk]);
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) acc[a][b] = __dp4a(a4[a], b4[b], acc[a][b]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const long long m = m0 + ty + 16 * a;
        if (m >= M) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int o = o0 + tx + 16 * b;
            if (o < O) y[m * O + o] = (float)acc[a][b] * alpha[o];
        }
    }
}

}  // namespace

BDBNN_EXPORT int bdbnn_binary_conv_fwd(const void* x, const void* shift, const void* wsign,
                                       const void* alpha, void* y, int N, int H, int W,
                                       int C, int O, int kh, int kw, int stride, int pad,
                                       int Ho, int Wo, void* stream) {
    const long long M = (long long)N * Ho * Wo;
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((O + BN - 1) / BN));
    binary_conv_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(shift),
        static_cast<const int8_t*>(wsign), static_cast<const float*>(alpha),
        static_cast<float*>(y), N, H, W, C, O, kh, kw, stride, pad, Ho, Wo);
    return (int)cudaGetLastError();
}
