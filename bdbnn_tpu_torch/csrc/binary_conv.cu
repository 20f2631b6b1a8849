// K1 — fused activation sign + binary (±1) convolution, forward, on the
// int8 tensor cores.
//
// Replaces bdbnn_tpu/nn/kernels/binary_conv.py:_make_binary_conv (the
// forward of binary_conv2d_mxu, conv(xb, sign W) * alpha) with the
// activation sign of bdbnn_tpu/nn/binarize.py (approx_sign / ste_sign
// forward, react's x - act_shift, nn/layers.py:BinaryConvReact) fused
// into its prep pass.
//
//   y[n, ho, wo, o] = alpha[o] * sum_{i, j, c} sx(n, ho*s - p + i, wo*s - p + j, c)
//                                            * wsign[o, i, j, c]
//   sx = sign(x - shift[c]) with sign(0) = +1, and 0 in the zero padding;
//   under the stochastic family, given the uniform draw u (f32, x's
//   layout, never with a shift), sx = u < clip((x + 1)/2, 0, 1) ? +1 : -1
//   (bdbnn_tpu/nn/binarize.py stoch_sign, then binary_conv2d_mxu).
//
// Layouts: x f32 NHWC, shift f32 (C,) or NULL, u f32 NHWC or NULL
// (the hard sign), wsign int8 (O, kh, kw, C)
// (= (O, K) row-major, K in HWIO flatten order), alpha f32 (O,), y f32
// NHWC (N, Ho, Wo, O) = (M, O) row-major. Scratch the wrapper allocates:
// sx int8 (N, H, W, CP), CP = C rounded up to 32; and wpad int8 (O, kh,
// kw, CP) only when the weight sign cannot be read as it is (C not a
// multiple of 32, or its pointer not 16-byte aligned), else NULL.
//
// Bound on the H100: an implicit GEMM of M = N*Ho*Wo, N = O, K =
// kh*kw*C. Counting x (f32, read once), the int8 weight sign and y (f32,
// written once), the flagship's convs do ~145 (layer1, 3x3 64->64) to
// ~840 (layer4, 3x3 512->512) int8 ops per byte against the card's ~590
// (1979 int8 TOP/s over 3.35 TB/s): the early, wide layers are bound by
// bytes, the deep ones by int8 tensor-core operations.
//
// The design, in two launches of one entry:
// 1. a prep pass reads f32 x (and u, the same way) once and writes
//    sign(x - shift), or the sampled sign, as int8 ±1
//    rows of CP bytes a pixel (zero beyond C), a quarter of x's bytes:
//    every tap the GEMM gathers is then an int8 row, most of them from
//    L2, never an f32 re-read of x (205 MB at layer1, -b 256, beyond the
//    50 MB L2), and no sign is taken twice;
// 2. the implicit GEMM of sign_gemm.cuh: 128 positions x 64 channels a
//    block, a 4-stage ring of 64-byte stages in 16-byte cp.async copies
//    (a padding tap is zero-filled), ldmatrix, mma.sync m16n8k32 s8 with
//    int32 accumulators.
// Every ±1 dot is an exact integer (|dot| <= K <= 4608 < 2^24), so
// float(acc) * alpha[o] is the same single f32 multiply as the
// reference's (y * alpha) and the output is bitwise equal to it.
//
// The bf16 mode (a bf16 model) is a kernel of its own:
// binary_conv_fwd_bf16.cu.
#include "sign_gemm.cuh"

namespace {

constexpr int PREP_THREADS = 256;
using Tile = sg::Stage<64, 16>;  // 64-byte stages (two MMAs) in 16-byte copies

// Work items: (pixel, 4 channels of CP) of sx, then the bytes of wpad.
__global__ void __launch_bounds__(PREP_THREADS)
fwd_sign_prep_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                     const float* __restrict__ u, const int8_t* __restrict__ wsign,
                     int8_t* __restrict__ sx, int8_t* __restrict__ wpad, long long pixels, int C, int CP,
                     long long wrows, bool vec) {
    const long long xitems = pixels * (CP / 4);
    const long long items = xitems + (wpad != nullptr ? wrows * CP : 0);
    for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x; it < items;
         it += (long long)gridDim.x * blockDim.x) {
        if (it < xitems) {
            const long long pix = it / (CP / 4);
            const int c0 = (int)(it - pix * (CP / 4)) * 4;
            float v[4], r[4] = {0.f, 0.f, 0.f, 0.f};
            bool in[4];
            if (vec && c0 < C) {
                float sv[4] = {0.f, 0.f, 0.f, 0.f};
                load4_f(x + pix * C + c0, v);
                if (shift != nullptr) load4_f(shift + c0, sv);
#pragma unroll
                for (int e = 0; e < 4; ++e) v[e] = __fsub_rn(v[e], sv[e]);
                if (u != nullptr) load4_f(u + pix * C + c0, r);
#pragma unroll
                for (int e = 0; e < 4; ++e) in[e] = true;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = c0 + e;
                    in[e] = c < C;
                    const float xv = in[e] ? load_f(x + pix * C + c) : 0.f;
                    v[e] = shift != nullptr && in[e] ? __fsub_rn(xv, load_f(shift + c)) : xv;
                    if (u != nullptr && in[e]) r[e] = load_f(u + pix * C + c);
                }
            }
            uint32_t word = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool plus = u != nullptr ? stoch_sign_plus(v[e], r[e]) : v[e] >= 0.f;
                word |= (in[e] ? (plus ? 0x01u : 0xFFu) : 0u) << (8 * e);
            }
            *reinterpret_cast<uint32_t*>(sx + pix * CP + c0) = word;
        } else {
            const long long wi = it - xitems;
            wpad[wi] = padded_weight_sign(wsign, wi, C, CP);
        }
    }
}

__global__ void __launch_bounds__(sg::THREADS, 3)
binary_conv_fwd_kernel(const int8_t* __restrict__ sx, const int8_t* __restrict__ wk,
                       const float* __restrict__ alpha, float* __restrict__ y, ConvGeom g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int acc[4][4][4];
    sign_gemm_mainloop<false, Tile>(reinterpret_cast<const uint8_t*>(sx),
                                    reinterpret_cast<const uint8_t*>(wk), g, smem_raw, acc);
    const long long m0 = (long long)blockIdx.x * sg::BM;
    const int o0 = blockIdx.y * sg::BN;
    sign_gemm_for_each(acc, [&](int r, int c, int d0, int d1) {
        if (m0 + r >= g.M) return;
        store_scaled(y, alpha, m0 + r, o0 + c, g.O, d0, d1);
    });
}

int fwd(const void* x, const void* shift, const void* u, const void* wsign, const void* alpha,
        void* sx, void* wpad, void* y, int N, int H, int W, int C, int O, int kh, int kw,
        int stride, int pad, int Ho, int Wo, int CP, cudaStream_t st) {
    const long long pixels = (long long)N * H * W;
    const long long wrows = (long long)O * kh * kw;
    constexpr uintptr_t VEC_BYTES = 4 * sizeof(float);
    const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % VEC_BYTES == 0 &&
                     reinterpret_cast<uintptr_t>(shift) % VEC_BYTES == 0 &&
                     reinterpret_cast<uintptr_t>(u) % VEC_BYTES == 0;
    const long long items = pixels * (CP / 4) + (wpad != nullptr ? wrows * CP : 0);
    const long long pblocks = (items + PREP_THREADS - 1) / PREP_THREADS;
    fwd_sign_prep_kernel<<<(unsigned)(pblocks < 132 * 32 ? pblocks : 132 * 32), PREP_THREADS,
                              0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(shift), static_cast<const float*>(u),
        static_cast<const int8_t*>(wsign), static_cast<int8_t*>(sx), static_cast<int8_t*>(wpad),
        pixels, C, CP, wrows, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(binary_conv_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const ConvGeom g{(long long)N * Ho * Wo, H, W, O, kw, kh * kw, stride, pad, Ho, Wo, CP};
    const dim3 grid((unsigned)((g.M + sg::BM - 1) / sg::BM), (unsigned)((O + sg::BN - 1) / sg::BN));
    binary_conv_fwd_kernel<<<grid, sg::THREADS, Tile::SMEM_BYTES, st>>>(
        static_cast<const int8_t*>(sx),
        static_cast<const int8_t*>(wpad != nullptr ? wpad : wsign), static_cast<const float*>(alpha),
        static_cast<float*>(y), g);
    return (int)cudaGetLastError();
}

}  // namespace

BDBNN_EXPORT int bdbnn_binary_conv_fwd(const void* x, const void* shift, const void* u,
                                       const void* wsign, const void* alpha, void* sx, void* wpad,
                                       void* y, int N, int H, int W, int C, int O, int kh, int kw,
                                       int stride, int pad, int Ho, int Wo, int CP, void* stream) {
    return fwd(x, shift, u, wsign, alpha, sx, wpad, y, N, H, W, C, O, kh, kw, stride, pad,
                      Ho, Wo, CP, static_cast<cudaStream_t>(stream));
}
