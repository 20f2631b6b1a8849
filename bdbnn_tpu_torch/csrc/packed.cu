// The packed-weight serving kernels: K3 (packbits decode) and K4
// (XNOR-popcount binary conv), forward.
//
// K3 replaces bdbnn_tpu/nn/packed.py:unpack_sign_device +
// packed_dense_weight: the export artifact's np.packbits payload
// (MSB first, flattened in HWIO order) becomes the dense f32 weight
// sign * alpha[o], in HWIO — the layout K2 (weight_binarize.cu) reads.
//   out[e] = (bit e of packed ? +1 : -1) * alpha[e % O]
// Bound on the H100: bytes (1/8 byte read, 4 bytes written per weight,
// one multiply). One thread per weight; neighbouring threads write
// neighbouring floats and share the packed byte and alpha through L1.
//
// K4 replaces bdbnn_tpu/nn/packed.py:popcount_binary_conv (+ _pack_words):
// the ±1 conv as a masked XNOR-popcount dot, with the activation sign of
// bdbnn_tpu/nn/binarize.py (react's x - act_shift) fused into its load:
//   dot = popc(mask) - 2 * popc((xbits ^ wbits) & mask),  y = dot * alpha[o]
// where mask marks the valid lanes (a zero-padding tap and k >= K are
// mask-0 lanes: the reference pads after the sign, so padding adds 0).
// Layouts as K1: x f32 NHWC, shift f32 (C,) or NULL, wsign int8
// (O, kh, kw, C), alpha f32 (O,), y f32 NHWC (N, Ho, Wo, O).
// Bound on the H100: as K1 — the bytes of f32 x and y at the wide,
// early layers, the operations at the deep ones (counted as the int8
// MACs of the same product). The design packs the activation sign
// bits, the valid mask and the weight bits into uint32 words in shared
// memory with one __ballot_sync per 32 lanes (lane b -> bit b: the
// word order is the kernel's own), 256 reduction lanes (8 words) a
// stage, so each 32-bit XOR + AND + __popc does 32 MACs and x is
// binarized without ever being written back. The integer dot equals
// K1's exactly, so the output is bitwise equal to K1's.
#include "common.cuh"

namespace {

constexpr int UNPACK_THREADS = 256;

__global__ void __launch_bounds__(UNPACK_THREADS)
unpack_sign_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ alpha,
                   float* __restrict__ out, int n, int O) {
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
        const int bit = (packed[e >> 3] >> (7 - (e & 7))) & 1;
        out[e] = (bit ? 1.f : -1.f) * alpha[e % O];
    }
}

constexpr int PBM = 64;      // output rows a block
constexpr int PBN = 64;      // output channels a block
constexpr int PW = 8;        // uint32 words (x 32 lanes) a stage
constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = PBM / WARPS;

__global__ void __launch_bounds__(WARPS * 32)
popcount_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                         const int8_t* __restrict__ wsign, const float* __restrict__ alpha,
                         float* __restrict__ y, int N, int H, int W, int C, int O,
                         int kh, int kw, int stride, int pad, int Ho, int Wo) {
    __shared__ uint32_t Xs[PBM][PW + 1];
    __shared__ uint32_t Ms[PBM][PW + 1];
    __shared__ uint32_t Ws[PBN][PW + 1];

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const long long M = (long long)N * Ho * Wo;
    const long long m0 = (long long)blockIdx.x * PBM;
    const int o0 = blockIdx.y * PBN;
    const int K = kh * kw * C;

    OutRow rows[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r)
        rows[r] = decode_row(m0 + warp + r * WARPS, M, H, W, C, Ho, Wo, stride, pad);

    int acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0;

    for (int k0 = 0; k0 < K; k0 += 32 * PW) {
        for (int wd = 0; wd < PW; ++wd) {
            const int k = k0 + wd * 32 + lane;
            const bool kvalid = k < K;
            const Tap t = decode_tap(kvalid ? k : 0, kw, C);
            const float s = (shift != nullptr && kvalid) ? shift[t.c] : 0.f;
#pragma unroll
            for (int r = 0; r < ROWS_PER_WARP; ++r) {
                const int sv = act_sign(x, rows[r], t, kvalid, s, H, W, C);
                const uint32_t xb = __ballot_sync(0xffffffffu, sv > 0);
                const uint32_t mb = __ballot_sync(0xffffffffu, sv != 0);
                if (lane == 0) {
                    Xs[warp + r * WARPS][wd] = xb;
                    Ms[warp + r * WARPS][wd] = mb;
                }
            }
#pragma unroll
            for (int r = 0; r < PBN / WARPS; ++r) {
                const int o = o0 + warp + r * WARPS;
                const bool wb = kvalid && o < O && wsign[(long long)o * K + k] > 0;
                const uint32_t ww = __ballot_sync(0xffffffffu, wb);
                if (lane == 0) Ws[warp + r * WARPS][wd] = ww;
            }
        }
        __syncthreads();
#pragma unroll
        for (int wd = 0; wd < PW; ++wd) {
            uint32_t xw[4], mw[4], ww[4];
            int valid[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                xw[a] = Xs[ty + 16 * a][wd];
                mw[a] = Ms[ty + 16 * a][wd];
                valid[a] = __popc(mw[a]);
            }
#pragma unroll
            for (int b = 0; b < 4; ++b) ww[b] = Ws[tx + 16 * b][wd];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    acc[a][b] += valid[a] - 2 * __popc((xw[a] ^ ww[b]) & mw[a]);
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

BDBNN_EXPORT int bdbnn_unpack_sign(const void* packed, const void* alpha, void* out, int n,
                                   int O, void* stream) {
    const int blocks = (n + UNPACK_THREADS - 1) / UNPACK_THREADS;
    unpack_sign_kernel<<<blocks > 65535 ? 65535 : blocks, UNPACK_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const float*>(alpha),
        static_cast<float*>(out), n, O);
    return (int)cudaGetLastError();
}

BDBNN_EXPORT int bdbnn_popcount_conv_fwd(const void* x, const void* shift, const void* wsign,
                                         const void* alpha, void* y, int N, int H, int W,
                                         int C, int O, int kh, int kw, int stride, int pad,
                                         int Ho, int Wo, void* stream) {
    const long long M = (long long)N * Ho * Wo;
    const dim3 grid((unsigned)((M + PBM - 1) / PBM), (unsigned)((O + PBN - 1) / PBN));
    popcount_conv_fwd_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(shift),
        static_cast<const int8_t*>(wsign), static_cast<const float*>(alpha),
        static_cast<float*>(y), N, H, W, C, O, kh, kw, stride, pad, Ho, Wo);
    return (int)cudaGetLastError();
}
