// K6 — binary (±1) convolution backward, weight gradient, with the
// latent weight's straight-through estimator fused into its epilogue, on
// the tensor cores.
//
// Replaces the d(sign W) half of bdbnn_tpu/nn/kernels/binary_conv.py:
// 107-110 (jax.vjp of _forward: the conv weight gradient of xb and
// g * alpha) and the weight sign's ste_sign backward of
// bdbnn_tpu/nn/binarize.py:466-471 (BinarizerFamily.weight_sign):
//
//   dW[i, j, c, o] = 1{|W[i, j, c, o]| <= 1}
//                    * sum_{n, ho, wo} sx(n, ho*s - p + i, wo*s - p + j, c) * ga[n, ho, wo, o]
//   sx = sign(x - shift[c]) with sign(0) = +1 and 0 in the zero padding
//   (the reference pads the binarized input: a padding tap adds 0); under
//   the stochastic family, given the forward's uniform draw u, the sampled
//   sign u < clip((x + 1)/2, 0, 1) ? +1 : -1 K1 took (stoch_sign): dW is
//   taken against the signs the forward used, never re-derived from x,
//   ga = g * alpha[o] formed in f32 first (the reference's order).
//
// Layouts: g f32 NHWC (N, Ho, Wo, O); x f32 NHWC (N, H, W, C); shift f32
// (C,) or NULL; u f32 NHWC like x or NULL (the hard sign); alpha f32 (O,); W and dW f32 HWIO = (kh*kw*C, O)
// row-major, the latent parameter's own layout. Scratch the wrapper
// allocates: gs bf16 (N, Ho, Wo, 3, OP), K5's layout of the split, OP =
// O rounded up to 32; sx bf16 (N, H, W, CP), CP = C rounded up to 8;
// partial f32 (splits, kh*kw*C, O).
//
// Bound on the H100: a GEMM of kh*kw*C x O outputs reduced over M =
// N*Ho*Wo positions. ga is f32, but it splits exactly into three bf16
// pieces (bf16x3.cuh) and each piece times ±1 or 0 is an exact bf16
// product, so the work is 3x the MACs on the bf16 tensor cores (989
// TFLOP/s dense): 6*macs operations, beside the bytes of g, x, W and dW.
//
// The design, in three launches of one entry:
// 1. a prep pass writes the split of ga as K5's split pass does (zero
//    beyond O) and the activation sign once, as bf16 ±1 rows of CP
//    (zero beyond C), so every shape goes through one aligned path and
//    the GEMM never recomputes a sign;
// 2. the GEMM: a block owns 128 dW rows (r = tap * CP + c, so a tile
//    spans two taps at C = 64) x 64 output channels and reduces over its
//    share of M (blockIdx.z; the output is small and M long: 576 x 64
//    outputs over 802,816 positions at layer1, -b 256). 8 warps of 32x32,
//    mma.sync m16n8k16 bf16 with f32 accumulators, both operands fed by
//    ldmatrix.trans from a 3-stage ring of 16-byte cp.async copies of 32
//    positions; a position whose tap falls in the padding copies zeros.
//    Each sx fragment serves the three pieces of ga. The 3-piece ga tile
//    is the larger operand, so the tall tile halves its traffic per MMA
//    against a 64-row one, and the 128-register cap keeps two blocks (16
//    warps) on an SM;
// 3. a reduce pass adds the split slices in split order and applies the
//    STE mask. No float atomics: the split count is a function of the
//    shapes alone.
// Summation: every product is exact; the MMA's own f32 accumulation
// truncates. Each 16-deep k step starts from a zeroed fragment and takes
// hi, then mid, then lo, and is added to an f32 total with a compensated
// (Kahan) add; the reduce pass adds the slices compensated too. A chain
// here is up to 802,816 terms long, so a plain round-to-nearest chain
// onto a growing same-sign total would drift by many u*sum|terms|. Each
// output is written once, by one thread, in a fixed order: two runs give
// the same bits.
//
// The bf16 mode (a bf16 model) is a kernel of its own:
// binary_conv_wgrad_bf16.cu.
#include "bf16x3.cuh"

namespace {

constexpr int BM = 128;                // dW rows a block: (tap, c) pairs
constexpr int BN = 64;                 // output channels a block
constexpr int BK = 32;                 // positions a pipeline stage
constexpr int NSTAGE = 3;              // cp.async ring depth
constexpr int MIN_BLOCKS = 2;          // blocks an SM: caps a thread at 128 registers
constexpr int WARPS_N = BN / 32;       // warps of 32x32 outputs each
constexpr int THREADS = 32 * (BM / 32) * WARPS_N;
constexpr int TPR = THREADS / BK;               // loader threads a position
constexpr int A_CHUNKS = BM / 8 / TPR;          // 16-byte sx copies a thread
static_assert(TPR * BK == THREADS && A_CHUNKS * TPR * 8 == BM && BK % 16 == 0, "A loader");
// bf16 per shared row (one position); the 16 extra bytes put the 8 rows
// an ldmatrix reads on 8 distinct bank groups
constexpr int APITCH = BM + 8;
constexpr int A_STAGE = BK * APITCH;

// The B operand: the three pieces of ga side by side
constexpr int PIECES = 3;
constexpr int B_CHUNKS = PIECES * BN / 8 / TPR;  // 16-byte gs copies a thread
constexpr int BPITCH = PIECES * BN + 8;
constexpr int B_STAGE = BK * BPITCH;
constexpr int SMEM_BYTES = NSTAGE * (A_STAGE + B_STAGE) * 2;
static_assert(B_CHUNKS * TPR * 8 == PIECES * BN, "B loader");
constexpr int PREP_THREADS = 256;
constexpr int REDUCE_THREADS = 256;
constexpr uint32_t BF16_PLUS_ONE = 0x3F80u;
constexpr uint32_t BF16_MINUS_ONE = 0xBF80u;

// Work items: (row, 8 o values) of gs, then (row, 8 c values) of sx.
__global__ void __launch_bounds__(PREP_THREADS)
wgrad_prep_kernel(const float* __restrict__ g, const float* __restrict__ alpha,
                  const float* __restrict__ x, const float* __restrict__ shift,
                  const float* __restrict__ u, __nv_bfloat16* __restrict__ gs, __nv_bfloat16* __restrict__ sx,
                  long long grows, int O, int OP, long long xrows, int C, int CP) {
    const long long gitems = grows * (OP / 8);
    const long long items = gitems + xrows * (CP / 8);
    for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x; it < items;
         it += (long long)gridDim.x * blockDim.x) {
        if (it < gitems) {
            const long long row = it / (OP / 8);
            split_ga8(g, alpha, gs, row, (int)(it - row * (OP / 8)) * 8, O, OP);
        } else {
            const long long xi = it - gitems;
            const long long row = xi / (CP / 8);
            const int c0 = (int)(xi - row * (CP / 8)) * 8;
            uint32_t p[4];
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
                uint32_t b[2];
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int c = c0 + e + q;
                    b[q] = 0u;
                    if (c < C) {
                        const float xv = x[row * C + c];
                        const float v = shift != nullptr ? __fsub_rn(xv, shift[c]) : xv;
                        const bool plus =
                            u != nullptr ? stoch_sign_plus(v, u[row * C + c]) : v >= 0.f;
                        b[q] = plus ? BF16_PLUS_ONE : BF16_MINUS_ONE;
                    }
                }
                p[e / 2] = b[0] | (b[1] << 16);
            }
            *reinterpret_cast<uint4*>(sx + row * CP + c0) = make_uint4(p[0], p[1], p[2], p[3]);
        }
    }
}

// The GEMM's rows are r = tap * CP + c, so a tile of BM rows spans
// several taps when C is small, and each 16-byte chunk of a row lies in
// one tap (CP is a multiple of 8).
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
binary_conv_wgrad_kernel(const __nv_bfloat16* __restrict__ sx, const __nv_bfloat16* __restrict__ gs,
                         float* __restrict__ partial, int N, int H, int W, int C, int O, int KK,
                         int kw, int stride, int pad, int Ho, int Wo, int OP, int CP, int Kd,
                         int rows_per_split) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Bs = As + NSTAGE * A_STAGE;

    const int r0 = blockIdx.x * BM;
    const int o0 = blockIdx.y * BN;
    const int HWo = Ho * Wo;
    const int mbeg = blockIdx.z * rows_per_split;
    const int mend = min(N * HWo, mbeg + rows_per_split);
    const long long RS = (long long)PIECES * OP;  // bf16 a gs row

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp / WARPS_N;
    const int wn = warp - wm * WARPS_N;

    // loader: TPR threads own one position of a stage, A_CHUNKS of its sx
    // chunks and B_CHUNKS of its gs row each; a thread's chunks are fixed,
    // so their taps are decoded once
    const int lr = tid / TPR;
    const int lq = tid - lr * TPR;
    int adh[A_CHUNKS], adw[A_CHUNKS], ac[A_CHUNKS];  // tap offset from (ho*s, wo*s), c
#pragma unroll
    for (int u = 0; u < A_CHUNKS; ++u) {
        const int r = r0 + (lq * A_CHUNKS + u) * 8;
        const int tap = r / CP;
        const int ti = tap / kw;
        ac[u] = tap < KK ? r - tap * CP : -1;
        adh[u] = ti - pad;
        adw[u] = tap - ti * kw - pad;
    }
    auto load_stage = [&](int buf, int m0) {
        const int m = m0 + lr;
        const bool okm = m < mend;
        int n = 0, h0 = 0, w0 = 0;
        if (okm) {
            n = m / HWo;
            const int rem = m - n * HWo;
            const int ho = rem / Wo;
            h0 = ho * stride;
            w0 = (rem - ho * Wo) * stride;
        }
        const uint32_t adst = smem_u32(As + buf * A_STAGE + lr * APITCH);
#pragma unroll
        for (int u = 0; u < A_CHUNKS; ++u) {
            const int hi = h0 + adh[u];
            const int wi = w0 + adw[u];
            const bool ok = okm && ac[u] >= 0 && (unsigned)hi < (unsigned)H &&
                            (unsigned)wi < (unsigned)W;
            cp_async16(adst + (lq * A_CHUNKS + u) * 16,
                       ok ? sx + (((long long)n * H + hi) * W + wi) * CP + ac[u] : sx, ok);
        }
        const uint32_t bdst = smem_u32(Bs + buf * B_STAGE + lr * BPITCH);
#pragma unroll
        for (int u = 0; u < B_CHUNKS; ++u) {
            const int q = lq * B_CHUNKS + u;
            const int piece = q / (BN / 8);
            const int oc = (q - piece * (BN / 8)) * 8;
            const bool ok = okm && o0 + oc < OP;
            cp_async16(bdst + (piece * BN + oc) * 2, ok ? gs + m * RS + piece * OP + o0 + oc : gs,
                       ok);
        }
    };

    const int nst = (mend - mbeg + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (s < nst) load_stage(s, mbeg + s * BK);
        cp_async_commit();
    }

    float acc[2][4][4], comp[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                acc[mi][nj][e] = 0.f;
                comp[mi][nj][e] = 0.f;
            }

    for (int it = 0; it < nst; ++it) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();  // stage it has landed; stage it - 1's buffer is free
        if (it + NSTAGE - 1 < nst)
            load_stage((it + NSTAGE - 1) % NSTAGE, mbeg + (it + NSTAGE - 1) * BK);
        cp_async_commit();
        const int buf = it % NSTAGE;
        const __nv_bfloat16* Ab = As + buf * A_STAGE;
        const __nv_bfloat16* Bb = Bs + buf * B_STAGE;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            // sx is stored (position, c): the A fragments (rows c, k =
            // positions) come transposed; matrix q of the x4 is rows
            // + (q & 1) * 8, k + (q >> 1) * 8
            uint32_t af[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int q = lane >> 3;
                const int krow = kk + (lane & 7) + (q >> 1) * 8;
                const int col = wm * 32 + mi * 16 + (q & 1) * 8;
                ldsm_x4_t(smem_u32(Ab + krow * APITCH + col), af[mi][0], af[mi][1], af[mi][2],
                          af[mi][3]);
            }
            float d[2][4][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int nj = 0; nj < 4; ++nj)
#pragma unroll
                    for (int e = 0; e < 4; ++e) d[mi][nj][e] = 0.f;
            // hi from the zeroed fragment, then mid, then lo
#pragma unroll
            for (int piece = 0; piece < PIECES; ++piece) {
                uint32_t bf[4][2];
#pragma unroll
                for (int nj = 0; nj < 4; nj += 2) {
                    const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
                    const int col = piece * BN + wn * 32 + nj * 8 + (lane >> 4) * 8;
                    ldsm_x4_t(smem_u32(Bb + krow * BPITCH + col), bf[nj][0], bf[nj][1],
                              bf[nj + 1][0], bf[nj + 1][1]);
                }
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int nj = 0; nj < 4; ++nj)
                        mma_bf16(d[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
            }
            // compensated add of the k step into the total
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int nj = 0; nj < 4; ++nj)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        kahan_add(acc[mi][nj][e], comp[mi][nj][e], d[mi][nj][e]);
        }
    }
    cp_async_wait<0>();

    float* out = partial + (long long)blockIdx.z * Kd * O;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = r0 + wm * 32 + mi * 16 + (lane >> 2) + half * 8;
            const int tap = r / CP;
            const int c = r - tap * CP;
            if (tap >= KK || c >= C) continue;
            float* orow = out + (long long)(tap * C + c) * O;
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
#pragma unroll
                for (int e2 = 0; e2 < 2; ++e2) {
                    const int o = o0 + wn * 32 + nj * 8 + (lane & 3) * 2 + e2;
                    const int k = half * 2 + e2;
                    if (o < O) orow[o] = __fsub_rn(acc[mi][nj][k], comp[mi][nj][k]);
                }
        }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
binary_conv_wgrad_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ w,
                                float* __restrict__ dw, long long KO, int splits) {
    const long long e = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
    if (e >= KO) return;
    float acc = 0.f, comp = 0.f;
    for (int z = 0; z < splits; ++z) kahan_add(acc, comp, partial[(long long)z * KO + e]);
    // the reference's g * (|W| <= 1).astype(g.dtype): a masked entry is
    // s * 0, which keeps the sign of zero
    dw[e] = __fmul_rn(__fsub_rn(acc, comp), fabsf(w[e]) <= 1.f ? 1.f : 0.f);
}

int wgrad(const void* g, const void* x, const void* shift, const void* u, const void* w,
          const void* alpha, void* gs, void* sx, void* partial, void* dw, int N, int H, int W,
          int C, int O, int kh, int kw, int stride, int pad, int Ho, int Wo, int OP, int CP,
          int splits, int rows_per_split, cudaStream_t st) {
    const long long grows = (long long)N * Ho * Wo;
    const long long xrows = (long long)N * H * W;
    const long long items = grows * (OP / 8) + xrows * (CP / 8);
    const long long pblocks = (items + PREP_THREADS - 1) / PREP_THREADS;
    wgrad_prep_kernel<<<(unsigned)(pblocks < 132 * 32 ? pblocks : 132 * 32), PREP_THREADS, 0,
                           st>>>(static_cast<const float*>(g), static_cast<const float*>(alpha),
                                 static_cast<const float*>(x), static_cast<const float*>(shift),
                                 static_cast<const float*>(u), static_cast<__nv_bfloat16*>(gs),
                                 static_cast<__nv_bfloat16*>(sx), grows, O, OP, xrows, C, CP);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(binary_conv_wgrad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const int Kd = kh * kw * C;
    const dim3 grid((unsigned)((kh * kw * CP + BM - 1) / BM), (unsigned)((O + BN - 1) / BN),
                    (unsigned)splits);
    binary_conv_wgrad_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(sx), static_cast<const __nv_bfloat16*>(gs),
        static_cast<float*>(partial), N, H, W, C, O, kh * kw, kw, stride, pad, Ho, Wo, OP, CP, Kd,
        rows_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long KO = (long long)Kd * O;
    binary_conv_wgrad_reduce_kernel
        <<<(unsigned)((KO + REDUCE_THREADS - 1) / REDUCE_THREADS), REDUCE_THREADS, 0, st>>>(
            static_cast<const float*>(partial), static_cast<const float*>(w),
            static_cast<float*>(dw), KO, splits);
    return (int)cudaGetLastError();
}

}  // namespace

BDBNN_EXPORT int bdbnn_binary_conv_wgrad(const void* g, const void* x, const void* shift,
                                         const void* u, const void* w, const void* alpha,
                                         void* gs, void* sx, void* partial, void* dw, int N,
                                         int H, int W, int C, int O, int kh, int kw, int stride,
                                         int pad, int Ho, int Wo, int OP, int CP, int splits,
                                         int rows_per_split, void* stream) {
    return wgrad(g, x, shift, u, w, alpha, gs, sx, partial, dw, N, H, W, C, O, kh, kw,
                        stride, pad, Ho, Wo, OP, CP, splits, rows_per_split,
                        static_cast<cudaStream_t>(stream));
}
