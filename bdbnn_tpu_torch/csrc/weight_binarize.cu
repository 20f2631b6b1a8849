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
// bf16 mode (a bf16 model, layers.py: w = latent.astype(bfloat16) before
// the sign and alpha): each weight is rounded to bf16 (RNE) first, and a
// result below the smallest normal is read as zero, so a negative weight
// that rounds to -0 or to a bf16 subnormal takes the sign +1, as the
// reference's comparison does (XLA reads subnormals as zero, as a TPU
// does); alpha is the mean of the rounded |W| (the
// sum in float64 as below, the mean rounded to f32 and then to bf16, as
// jnp.mean's f32 mean is cast to bf16), written as bf16 (O,). lab rounds
// each W² to bf16 and takes bf16(mean W² / bf16(mean |W| + 1e-12)), the
// reference's bf16 ops in order.
//
// Bound on the H100: bytes — 4 bytes of W read and 1 byte of sign
// written per weight, with a few flops each. The flagship's weights run
// from 32 KB (1x1 64->128) to 9.4 MB (3x3 512->512); a forward's 19 hold
// 44.6 MB. The design spreads each weight over the whole card:
// - grid (ceil(O / 64), splits): a block takes 64 output channels and one
//   split of the K rows (weight_binarize_splits in
//   nn/kernels/weight_binarize.py: rows a multiple of 16, about two waves
//   of the 132 SMs where K allows, 288 blocks at 3x3 512->512);
// - loads: a thread reads 4 consecutive rows of 4 consecutive channels
//   as 16-byte loads along O (O is contiguous), four at once, so a block
//   has its whole 64-row chunk (16 KB) in flight;
// - signs: the thread's 4x4 signs become 4 words (4 rows of one channel
//   each), go through shared memory, and leave as 16-byte stores along K;
// - alpha: each thread sums |W| (and W² for lab) of its channels in
//   float64, the block adds its 16 row groups in order into one partial a
//   split, and a second launch adds the partials in split order and
//   rounds once to f32 (one launch when there is one split). No atomics:
//   the order of every sum is fixed by the shapes, so alpha is bitwise
//   equal across runs; float64 keeps it the correctly rounded mean to well
//   within the reference's f32 rounding, whatever the order.
// Where O % 4, K % 16 or W's alignment rule out vectors, the same kernel
// reads and writes element by element (VEC = false).
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int TO = 64;                   // output channels a block
constexpr int THREADS = 256;
constexpr int QUADS = TO / 4;            // threads across a row's channels
constexpr int GROUPS = THREADS / QUADS;  // row groups of 4 rows
constexpr int TK = GROUPS * 4;           // rows a chunk: 64
constexpr int WSTRIDE = TK / 4 + 1;      // words of a channel in the sign tile (+1: banks)
constexpr int FINISH_THREADS = 256;

__device__ __forceinline__ float alpha_of(double s_abs, double s_sq, int K, int lab) {
    const float mean_abs = (float)(s_abs / (double)K);
    if (!lab) return mean_abs;
    const float mean_sq = (float)(s_sq / (double)K);
    return mean_sq / (mean_abs + 1e-12f);
}

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16(v), a subnormal result read as zero
__device__ __forceinline__ float round_bf16_flush(float v) {
    const float r = round_bf16(v);
    return fabsf(r) < 1.17549435e-38f ? 0.f : r;
}

// alpha of the bf16 mode, each of the reference's bf16 ops rounded
__device__ __forceinline__ __nv_bfloat16 alpha_of_bf16(double s_abs, double s_sq, int K, int lab) {
    const float mean_abs = round_bf16((float)(s_abs / (double)K));
    if (!lab) return __float2bfloat16_rn(mean_abs);
    const float mean_sq = round_bf16((float)(s_sq / (double)K));
    return __float2bfloat16_rn(__fdiv_rn(mean_sq, round_bf16(__fadd_rn(mean_abs, 1e-12f))));
}

// alpha[o] in the mode's dtype: f32, or bf16 when BF16
template <bool BF16>
__device__ __forceinline__ void store_alpha(void* alpha, int o, double s_abs, double s_sq, int K,
                                            int lab) {
    if (BF16)
        static_cast<__nv_bfloat16*>(alpha)[o] = alpha_of_bf16(s_abs, s_sq, K, lab);
    else
        static_cast<float*>(alpha)[o] = alpha_of(s_abs, s_sq, K, lab);
}

template <bool VEC, bool BF16>
__global__ void __launch_bounds__(THREADS)
weight_sign_kernel(const float* __restrict__ w, int8_t* __restrict__ sign,
                   double* __restrict__ part, void* __restrict__ alpha, int K, int O,
                   int rows, int splits, int lab) {
    __shared__ uint32_t tile[TO * WSTRIDE];
    __shared__ double red[2][GROUPS][TO];

    const int tid = threadIdx.x;
    const int q = tid % QUADS;    // channels o0 + 4q .. 4q + 3
    const int grp = tid / QUADS;  // rows c0 + 4 grp .. 4 grp + 3 of a chunk
    const int o0 = blockIdx.x * TO;
    const int o = o0 + 4 * q;
    const int kb = blockIdx.y * rows;
    const int ke = min(K, kb + rows);
    double s_abs[4] = {0.0, 0.0, 0.0, 0.0};
    double s_sq[4] = {0.0, 0.0, 0.0, 0.0};

    for (int c0 = kb; c0 < ke; c0 += TK) {
        // v[i][j]: row c0 + 4 grp + i, channel o + j; 0 outside W, which
        // adds nothing to either sum and whose sign is never stored
        float v[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int k = c0 + 4 * grp + i;
            const float* src = w + (long long)k * O + o;
            if (VEC) {
                float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
                if (k < ke && o < O) f = __ldg(reinterpret_cast<const float4*>(src));
                v[i][0] = f.x;
                v[i][1] = f.y;
                v[i][2] = f.z;
                v[i][3] = f.w;
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) v[i][j] = (k < ke && o + j < O) ? __ldg(src + j) : 0.f;
            }
            if (BF16) {
#pragma unroll
                for (int j = 0; j < 4; ++j) v[i][j] = round_bf16_flush(v[i][j]);
            }
        }
        uint32_t word[4] = {0u, 0u, 0u, 0u};  // channel o + j, row i in byte i
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const double d = (double)v[i][j];
                s_abs[j] += fabs(d);
                if (lab) {
                    if (BF16)
                        s_sq[j] += (double)round_bf16(__fmul_rn(v[i][j], v[i][j]));
                    else
                        s_sq[j] = fma(d, d, s_sq[j]);
                }
                word[j] |= (v[i][j] >= 0.f ? 0x01u : 0xFFu) << (8 * i);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) tile[(4 * q + j) * WSTRIDE + grp] = word[j];
        __syncthreads();
        const int n = min(TK, ke - c0);  // rows of this chunk
        if (VEC) {
            // n, K and c0 are multiples of 16: channel ol's row of the
            // chunk is n / 16 aligned 16-byte vectors
            const int ol = tid / 4, seg = tid % 4;
            if (seg * 16 < n && o0 + ol < O) {
                const uint32_t* t = tile + ol * WSTRIDE + seg * 4;
                *reinterpret_cast<uint4*>(sign + (long long)(o0 + ol) * K + c0 + seg * 16) =
                    make_uint4(t[0], t[1], t[2], t[3]);
            }
        } else {
            for (int e = tid; e < TO * TK; e += THREADS) {
                const int ol = e / TK, kl = e % TK;
                if (kl < n && o0 + ol < O)
                    sign[(long long)(o0 + ol) * K + c0 + kl] =
                        (int8_t)(tile[ol * WSTRIDE + kl / 4] >> (8 * (kl % 4)));
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
        red[0][grp][4 * q + j] = s_abs[j];
        red[1][grp][4 * q + j] = s_sq[j];
    }
    __syncthreads();
    if (tid < TO && o0 + tid < O) {
        double a = 0.0, s = 0.0;
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
            a += red[0][g][tid];
            s += red[1][g][tid];
        }
        if (splits == 1) {
            store_alpha<BF16>(alpha, o0 + tid, a, s, K, lab);
        } else {
            part[(long long)blockIdx.y * O + o0 + tid] = a;
            part[((long long)splits + blockIdx.y) * O + o0 + tid] = s;
        }
    }
}

// alpha[o] from the (2, splits, O) float64 partials, added in split order.
template <bool BF16>
__global__ void __launch_bounds__(FINISH_THREADS)
weight_alpha_finish_kernel(const double* __restrict__ part, void* __restrict__ alpha, int K,
                           int O, int splits, int lab) {
    const int o = blockIdx.x * FINISH_THREADS + threadIdx.x;
    if (o >= O) return;
    double a = 0.0, s = 0.0;
#pragma unroll 8
    for (int i = 0; i < splits; ++i) {
        a += part[(long long)i * O + o];
        if (lab) s += part[((long long)splits + i) * O + o];
    }
    store_alpha<BF16>(alpha, o, a, s, K, lab);
}

}  // namespace

// part: float64 (2, splits, O) scratch, or NULL when splits == 1; rows a
// multiple of 16 (weight_binarize_splits); bf16: the bf16 mode (alpha is
// then bf16).
BDBNN_EXPORT int bdbnn_weight_binarize(const void* w, void* sign, void* alpha, void* part, int K,
                                       int O, int rows, int splits, int lab, int bf16,
                                       void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = O % 4 == 0 && K % 16 == 0 && rows % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(sign) % 16 == 0;
    const dim3 grid((unsigned)((O + TO - 1) / TO), (unsigned)splits);
    const float* wf = static_cast<const float*>(w);
    int8_t* s8 = static_cast<int8_t*>(sign);
    double* pd = static_cast<double*>(part);
    auto kernel = vec ? (bf16 ? weight_sign_kernel<true, true> : weight_sign_kernel<true, false>)
                      : (bf16 ? weight_sign_kernel<false, true> : weight_sign_kernel<false, false>);
    kernel<<<grid, THREADS, 0, st>>>(wf, s8, pd, alpha, K, O, rows, splits, lab);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    auto finish = bf16 ? weight_alpha_finish_kernel<true> : weight_alpha_finish_kernel<false>;
    finish<<<(unsigned)((O + FINISH_THREADS - 1) / FINISH_THREADS), FINISH_THREADS, 0, st>>>(
        pd, alpha, K, O, splits, lab);
    return (int)cudaGetLastError();
}
