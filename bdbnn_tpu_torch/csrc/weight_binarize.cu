// K2 — weight sign + per-output-channel alpha, one pass over W.
//
// Replaces bdbnn_tpu/nn/binarize.py:BinarizerFamily.weight_sign +
// BinarizerFamily.weight_alpha (forward), as called once per binary
// conv per forward in bdbnn_tpu/nn/layers.py:_BinaryConvBase.binary_conv.
//
//   sign[o, k] = W[k, o] >= 0 ? +1 : -1               (int8)
//   alpha[o]   = mean_k |W[k, o]|                       (default families)
//              = mean_k W² / (mean_k |W| + 1e-12)       (lab)
//
// Layouts: W f32 HWIO flattened to (K, O) row-major; sign int8
// (O, kh, kw, C) = (O, K) row-major — the layout K1 (binary_conv.cu) and
// K4 (packed.cu) read, with K contiguous; alpha f32 (O,).
//
// Bound on the H100: bytes — 4 bytes of W read and 1 byte of sign
// written per weight with 2-3 flops each (the flagship's largest conv,
// 3x3 512->512, is 9.4 MB of W). The design reads W once, coalesced
// along O (32 output channels a block, one per lane), transposes each
// 32x32 tile of signs through shared memory so the int8 writes are
// coalesced along K too, and reduces |W| (and W²) per channel in
// float64 — so alpha is the correctly rounded mean to well within the
// reference's f32 rounding, whatever the summation order.
#include "common.cuh"

namespace {

constexpr int TO = 32;  // output channels a block (one per lane)
constexpr int TK = 32;  // reduction rows a tile
constexpr int WARPS = 8;

__global__ void __launch_bounds__(TO * WARPS)
weight_binarize_kernel(const float* __restrict__ w, int8_t* __restrict__ sign,
                       float* __restrict__ alpha, int K, int O, int lab) {
    __shared__ int8_t tile[TK][TO + 1];
    __shared__ double red_abs[WARPS][TO];
    __shared__ double red_sq[WARPS][TO];

    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int o0 = blockIdx.x * TO;
    const int o = o0 + lane;
    double s_abs = 0.0, s_sq = 0.0;

    for (int k0 = 0; k0 < K; k0 += TK) {
        // read: lane -> output channel, warp -> reduction row
#pragma unroll
        for (int r = 0; r < TK / WARPS; ++r) {
            const int kl = warp + r * WARPS;
            const int k = k0 + kl;
            int8_t sv = 0;
            if (k < K && o < O) {
                const float v = w[(long long)k * O + o];
                sv = v >= 0.f ? 1 : -1;
                const double d = (double)v;
                s_abs += fabs(d);
                s_sq += d * d;
            }
            tile[kl][lane] = sv;
        }
        __syncthreads();
        // write: lane -> reduction row, warp -> output channel
#pragma unroll
        for (int r = 0; r < TO / WARPS; ++r) {
            const int ol = warp + r * WARPS;
            const int k = k0 + lane;
            if (o0 + ol < O && k < K) sign[(long long)(o0 + ol) * K + k] = tile[lane][ol];
        }
        __syncthreads();
    }

    red_abs[warp][lane] = s_abs;
    red_sq[warp][lane] = s_sq;
    __syncthreads();
    if (warp == 0 && o < O) {
        double a = 0.0, q = 0.0;
        for (int r = 0; r < WARPS; ++r) {
            a += red_abs[r][lane];
            q += red_sq[r][lane];
        }
        const float mean_abs = (float)(a / (double)K);
        if (lab) {
            const float mean_sq = (float)(q / (double)K);
            alpha[o] = mean_sq / (mean_abs + 1e-12f);
        } else {
            alpha[o] = mean_abs;
        }
    }
}

}  // namespace

BDBNN_EXPORT int bdbnn_weight_binarize(const void* w, void* sign, void* alpha, int K, int O,
                                       int lab, void* stream) {
    const dim3 grid((unsigned)((O + TO - 1) / TO));
    weight_binarize_kernel<<<grid, TO * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<int8_t*>(sign), static_cast<float*>(alpha),
        K, O, lab);
    return (int)cudaGetLastError();
}
