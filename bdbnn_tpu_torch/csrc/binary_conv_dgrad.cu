// K5 — binary (±1) convolution backward, input gradient, with the
// activation sign estimator's backward fused into its epilogue, on the
// tensor cores.
//
// Replaces the dx half of bdbnn_tpu/nn/kernels/binary_conv.py:107-110
// (jax.vjp of _forward: conv_transpose(g * alpha, sign W)) and the
// backward rules of bdbnn_tpu/nn/binarize.py (ste / approx / ede / prox
// sign), applied to the conv's pre-sign input (react's x - act_shift):
//
//   dx[n, h, w, c] = slope(x[n, h, w, c] - shift[c])
//                    * sum_{i, j, o} ga[n, ho, wo, o] * wsign[o, i, j, c]
//   over the taps with h = ho*s - p + i, w = wo*s - p + j,
//   ga = g * alpha[o] formed in f32 first (the reference's order).
//
//   slope: approx max(0, 2 - 2|v|); ste 1{|v| <= 1};
//          ede   k*t*sech(t*v)^2 (sech = 1/cosh, computed directly);
//          prox  (2/d) * max(0, 1 - |v|/d);  none: 1.
//
// Layouts: g f32 NHWC (N, Ho, Wo, O); x f32 NHWC (N, H, W, C); shift f32
// (C,) or NULL; wsign int8 (O, kh, kw, C) as K2 writes it; alpha f32
// (O,); dx f32 NHWC (N, H, W, C). Scratch the wrapper allocates: gs bf16
// (N, Ho, Wo, 3, OP) and wb bf16 (kh*kw, OP, CP), OP = O rounded up to
// the 32-deep stage, CP = C rounded up to 8; taps int32, the parity-class
// table of nn/kernels/binary_conv.py:dgrad_tap_table.
//
// Bound on the H100: an implicit GEMM of M = N*H*W rows, C columns and
// K = (taps on the stride grid) * O. g is f32, so an exact int8 product
// is closed; but ga splits exactly into three bf16 pieces (hi = bf16(ga),
// mid = bf16(ga - hi), lo = ga - hi - mid, all exact), and each piece
// times ±1 is an exact bf16 product. So the work is 3x the MACs on the
// bf16 tensor cores (989 TFLOP/s dense): 6*macs operations, beside the
// bytes of g, x and dx.
//
// The design, in two launches of one entry:
// 1. a split pass forms ga with the reference's f32 multiply and writes
//    hi, mid, lo as whole 16-byte rows (zero beyond O), and widens the
//    int8 sign to bf16 ±1 by tap (zero beyond O and C), so every shape
//    goes through one aligned path;
// 2. the GEMM: blockIdx.z is the stride-parity class (h mod s, w mod s)
//    of the dx rows, and only the taps of that class reach g (1, 2, 2, 4
//    of 9 at 3x3 s2 p1), each at a fixed offset (di, dj) from (h/s, w/s)
//    — no off-grid tap is loaded or multiplied. 64x64 tiles, 4 warps of
//    32x32, mma.sync m16n8k16 bf16 with f32 accumulators fed by ldmatrix
//    from a 3-stage ring of 16-byte cp.async copies (a tap that falls
//    outside g copies zeros); row offsets are computed once per block, so
//    the K loop does no integer division.
// Summation: every product is exact; the MMA's own f32 accumulation
// truncates, and truncation is biased when the terms share a sign. Each
// 16-deep k step therefore starts from a zeroed fragment, takes hi first
// (a sum of 16 8-bit products is exact), then mid and lo (whose signs are
// mixed, so their truncation does not drift), and is added to an f32
// total with compensated (Kahan) __fadd_rn/__fsub_rn: a plain chain of
// hundreds of round-to-nearest adds onto a growing same-sign total would
// itself drift by several u*sum|terms|. Each output is written once, by
// one thread, in a fixed order: two runs give the same bits. The split,
// the copy / ldmatrix / mma helpers and the compensated add are shared
// with K6 (bf16x3.cuh).
//
// bf16 mode (a bf16 model): g, x, shift and alpha are bf16, and so is
// dx. The reference's cotangent of the conv is ga = bf16(g * alpha), so
// the split pass writes that one piece and the GEMM runs one MMA a k
// step where the f32 mode runs three. The sum is rounded to bf16 (the
// reference's bf16 conv output), and the slope is taken at v = bf16(x -
// shift) with each of the estimator's ops rounded to bf16 (t, k, delta
// too), dx = bf16(bf16(sum) * slope), as the reference's bf16 backward
// rules compute it.
#include "bf16x3.cuh"

namespace {

constexpr int BM = 64;                 // dx rows of one parity class a block
constexpr int BN = 64;                 // input channels a block
constexpr int BK = 32;                 // o values a pipeline stage (x PIECES)
constexpr int NSTAGE = 3;              // cp.async ring depth
constexpr int WARPS_N = BN / 32;       // warps of 32x32 outputs each
constexpr int THREADS = 32 * (BM / 32) * WARPS_N;
constexpr int B_CHUNKS = BK * BN / 8 / THREADS;
static_assert(B_CHUNKS * THREADS * 8 == BK * BN && BK % 16 == 0, "B loader");
// bf16 per shared B row; the 16 extra bytes put the 8 rows an ldmatrix
// reads on 8 distinct bank groups
constexpr int BPITCH = BN + 8;
constexpr int B_STAGE = BK * BPITCH;
constexpr int SPLIT_THREADS = 256;

// The A operand's shape for PIECES pieces of ga (3 in the f32 mode, 1 in
// the bf16 mode)
template <int PIECES>
struct ATile {
    static constexpr int CHUNKS = BM * PIECES * BK / 8 / THREADS;  // 16-byte copies a thread
    static constexpr int TPR = PIECES * BK / 8 / CHUNKS;            // threads an A row
    static constexpr int PITCH = PIECES * BK + 8;
    static constexpr int STAGE = BM * PITCH;
    static constexpr int SMEM_BYTES = NSTAGE * (STAGE + B_STAGE) * 2;
    static_assert(CHUNKS * THREADS * 8 == BM * PIECES * BK && TPR * CHUNKS * 8 == PIECES * BK,
                  "A loader");
};

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

// dx of the bf16 mode: bf16(sum * slope) at v = bf16(x - shift), each of
// the estimator's ops rounded to bf16 as the reference's bf16 backward
// rules round them (r below); sum is the bf16-rounded conv sum.
__device__ __forceinline__ float est_dx_bf16(float sum, float v, int est, float p0, float p1) {
    auto r = round_to_bf16;
    switch (est) {
        case EST_APPROX:
            return r(__fmul_rn(sum, fmaxf(r(__fsub_rn(2.f, __fmul_rn(2.f, fabsf(v)))), 0.f)));
        case EST_STE:
            return fabsf(v) <= 1.f ? sum : __fmul_rn(sum, 0.f);
        case EST_EDE: {  // p0 = t, p1 = k
            const float t = r(p0), k = r(p1);
            const float sech = r(__fdiv_rn(1.f, r(coshf(r(__fmul_rn(t, v))))));
            const float s = r(__fmul_rn(r(__fmul_rn(r(__fmul_rn(k, t)), sech)), sech));
            return r(__fmul_rn(sum, s));
        }
        case EST_PROX: {  // p0 = delta
            const float d = r(p0);
            const float s = r(__fmul_rn(r(__fdiv_rn(2.f, d)),
                                        fmaxf(r(__fsub_rn(1.f, r(__fdiv_rn(fabsf(v), d)))), 0.f)));
            return r(__fmul_rn(sum, s));
        }
        default:
            return sum;
    }
}

// Work items: (row, 8 o values) of gs, then (tap, o, 8 c values) of wb.
// T: float (three pieces of ga), or __nv_bfloat16 (the bf16 mode's one).
template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
dgrad_split_kernel(const T* __restrict__ g, const T* __restrict__ alpha,
                   const int8_t* __restrict__ wsign, __nv_bfloat16* __restrict__ gs,
                   __nv_bfloat16* __restrict__ wb, long long rows, int O, int OP, int KK,
                   int C, int CP) {
    const long long gitems = rows * (OP / 8);
    const long long items = gitems + (long long)KK * OP * (CP / 8);
    for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x; it < items;
         it += (long long)gridDim.x * blockDim.x) {
        if (it < gitems) {
            const long long row = it / (OP / 8);
            split_ga8(g, alpha, gs, row, (int)(it - row * (OP / 8)) * 8, O, OP);
        } else {
            const long long wi = it - gitems;
            const long long to = wi / (CP / 8);  // tap * OP + o
            const int c0 = (int)(wi - to * (CP / 8)) * 8;
            const int t = (int)(to / OP);
            const int o = (int)(to - (long long)t * OP);
            uint32_t p[4];
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
                uint32_t b[2];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int c = c0 + e + u;
                    const float s =
                        (o < O && c < C) ? (float)wsign[((long long)o * KK + t) * C + c] : 0.f;
                    b[u] = bf16_bits(__float2bfloat16_rn(s));
                }
                p[e / 2] = b[0] | (b[1] << 16);
            }
            *reinterpret_cast<uint4*>(wb + to * CP + c0) = make_uint4(p[0], p[1], p[2], p[3]);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
binary_conv_dgrad_kernel(const __nv_bfloat16* __restrict__ gs, const __nv_bfloat16* __restrict__ wb,
                         const int* __restrict__ taps, const T* __restrict__ x,
                         const T* __restrict__ shift, T* __restrict__ dx, int N, int H,
                         int W, int C, int Ho, int Wo, int stride, int OP, int CP, int est,
                         float p0, float p1) {
    constexpr bool BF16 = sizeof(T) == 2;
    constexpr int PIECES = BF16 ? 1 : 3;
    using A = ATile<PIECES>;
    constexpr int A_CHUNKS = A::CHUNKS, A_TPR = A::TPR, APITCH = A::PITCH, A_STAGE = A::STAGE;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Bs = As + NSTAGE * A_STAGE;
    __shared__ long long row_dx[BM];  // dx offset of row (n, h, w) at c = 0, or -1

    // the parity class (a, b) of this block's dx rows: h = a + s*hh, w = b + s*ww
    const int cls = blockIdx.z;
    const int a = cls / stride;
    const int b = cls - a * stride;
    const int Hc = H > a ? (H - a + stride - 1) / stride : 0;
    const int Wc = W > b ? (W - b + stride - 1) / stride : 0;
    const long long HWc = (long long)Hc * Wc;
    const long long Mc = (long long)N * HWc;
    const long long m0 = (long long)blockIdx.x * BM;
    if (m0 >= Mc) return;  // the same for the whole block
    const int c0 = blockIdx.y * BN;
    const int tap0 = __ldg(taps + cls);
    const int ntap = __ldg(taps + cls + 1) - tap0;
    const int* tapv = taps + stride * stride + 1 + 3 * tap0;  // (i*kw + j, di, dj) a tap
    const long long RS = (long long)PIECES * OP;             // bf16 a gs row

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp / WARPS_N;
    const int wn = warp - wm * WARPS_N;

    // loader: A_TPR threads own one A row, A_CHUNKS of its 12 chunks each
    const int ar = tid / A_TPR;
    const int aq0 = (tid - ar * A_TPR) * A_CHUNKS;
    int ahh = 0, aww = 0;
    long long abase = -1;  // gs row of (n, hh, ww)
    {
        const long long m = m0 + ar;
        long long off = -1;
        if (m < Mc) {
            const long long n = m / HWc;
            const int rem = (int)(m - n * HWc);
            ahh = rem / Wc;
            aww = rem - ahh * Wc;
            abase = (n * Ho + ahh) * (long long)Wo + aww;
            off = ((n * H + a + stride * ahh) * (long long)W + b + stride * aww) * C;
        }
        if (aq0 == 0) row_dx[ar] = off;
    }

    auto load_stage = [&](int buf, int t, int o0) {
        const int tidx = __ldg(tapv + 3 * t);
        const int di = __ldg(tapv + 3 * t + 1);
        const int dj = __ldg(tapv + 3 * t + 2);
        const bool ok = abase >= 0 && (unsigned)(ahh + di) < (unsigned)Ho &&
                        (unsigned)(aww + dj) < (unsigned)Wo;
        const __nv_bfloat16* src = ok ? gs + (abase + (long long)di * Wo + dj) * RS + o0 : gs;
        const uint32_t adst = smem_u32(As + buf * A_STAGE + ar * APITCH);
#pragma unroll
        for (int u = 0; u < A_CHUNKS; ++u) {
            const int q = aq0 + u;
            const int piece = q / (BK / 8);
            const int sub = q - piece * (BK / 8);
            cp_async16(adst + (piece * BK + sub * 8) * 2, ok ? src + piece * OP + sub * 8 : gs,
                       ok);
        }
#pragma unroll
        for (int r = 0; r < B_CHUNKS; ++r) {
            const int id = tid + r * THREADS;
            const int krow = id / (BN / 8);
            const int cc = id - krow * (BN / 8);
            const int c = c0 + cc * 8;
            const bool okb = c < CP;
            const __nv_bfloat16* bsrc = okb ? wb + ((long long)tidx * OP + o0 + krow) * CP + c : wb;
            cp_async16(smem_u32(Bs + buf * B_STAGE + krow * BPITCH + cc * 8), bsrc, okb);
        }
    };

    const int nst = ntap * (OP / BK);
    int lt = 0, lo0 = 0;  // the next stage to load: tap slot, first o
    auto load_next = [&](int buf) {
        load_stage(buf, lt, lo0);
        if ((lo0 += BK) == OP) {
            lo0 = 0;
            ++lt;
        }
    };
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (s < nst) load_next(s);
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
        if (it + NSTAGE - 1 < nst) load_next((it + NSTAGE - 1) % NSTAGE);
        cp_async_commit();
        const int buf = it % NSTAGE;
        const __nv_bfloat16* Ab = As + buf * A_STAGE;
        const __nv_bfloat16* Bb = Bs + buf * B_STAGE;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t bf[4][2];
#pragma unroll
            for (int nj = 0; nj < 4; nj += 2) {
                const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
                const int col = wn * 32 + nj * 8 + (lane >> 4) * 8;
                ldsm_x4_t(smem_u32(Bb + krow * BPITCH + col), bf[nj][0], bf[nj][1], bf[nj + 1][0],
                          bf[nj + 1][1]);
            }
            float d[2][4][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int nj = 0; nj < 4; ++nj)
#pragma unroll
                    for (int e = 0; e < 4; ++e) d[mi][nj][e] = 0.f;
            uint32_t af[PIECES][2][4];
#pragma unroll
            for (int piece = 0; piece < PIECES; ++piece)
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    const int row = wm * 32 + mi * 16 + (lane & 15);
                    const int col = piece * BK + kk + (lane >> 4) * 8;
                    ldsm_x4(smem_u32(Ab + row * APITCH + col), af[piece][mi][0], af[piece][mi][1],
                            af[piece][mi][2], af[piece][mi][3]);
                }
            // hi from the zeroed fragment, then mid, then lo
#pragma unroll
            for (int piece = 0; piece < PIECES; ++piece)
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int nj = 0; nj < 4; ++nj)
                        mma_bf16(d[mi][nj], af[piece][mi], bf[nj][0], bf[nj][1]);
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
    __syncthreads();  // row_dx is visible even when the class has no tap

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const long long base = row_dx[wm * 32 + mi * 16 + (lane >> 2) + half * 8];
            if (base < 0) continue;
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
#pragma unroll
                for (int e2 = 0; e2 < 2; ++e2) {
                    const int c = c0 + wn * 32 + nj * 8 + (lane & 3) * 2 + e2;
                    if (c >= C) continue;
                    const long long e = base + c;
                    const float xv = load_f(x + e);
                    const float v = shift != nullptr ? __fsub_rn(xv, load_f(shift + c)) : xv;
                    const int k = half * 2 + e2;
                    const float sum = __fsub_rn(acc[mi][nj][k], comp[mi][nj][k]);
                    if constexpr (BF16)
                        dx[e] = __float2bfloat16_rn(
                            est_dx_bf16(round_to_bf16(sum), round_to_bf16(v), est, p0, p1));
                    else
                        dx[e] = __fmul_rn(sum, est_slope(v, est, p0, p1));
                }
        }
}

template <typename T>
int dgrad(const void* g, const void* x, const void* shift, const void* wsign, const void* alpha,
          const void* taps, void* gs, void* wb, void* dx, int N, int H, int W, int C, int O, int kh,
          int kw, int stride, int Ho, int Wo, int OP, int CP, int est, float p0, float p1,
          cudaStream_t st) {
    const long long rows = (long long)N * Ho * Wo;
    const long long items = rows * (OP / 8) + (long long)kh * kw * OP * (CP / 8);
    const long long sblocks = (items + SPLIT_THREADS - 1) / SPLIT_THREADS;
    dgrad_split_kernel<T><<<(unsigned)(sblocks < 132 * 32 ? sblocks : 132 * 32), SPLIT_THREADS, 0,
                            st>>>(static_cast<const T*>(g), static_cast<const T*>(alpha),
                                  static_cast<const int8_t*>(wsign),
                                  static_cast<__nv_bfloat16*>(gs), static_cast<__nv_bfloat16*>(wb),
                                  rows, O, OP, kh * kw, C, CP);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    constexpr int SMEM_BYTES = ATile<sizeof(T) == 2 ? 1 : 3>::SMEM_BYTES;
    err = cudaFuncSetAttribute(binary_conv_dgrad_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const long long mmax = (long long)N * ((H + stride - 1) / stride) * ((W + stride - 1) / stride);
    const dim3 grid((unsigned)((mmax + BM - 1) / BM), (unsigned)((C + BN - 1) / BN),
                    (unsigned)(stride * stride));
    binary_conv_dgrad_kernel<T><<<grid, THREADS, SMEM_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(gs), static_cast<const __nv_bfloat16*>(wb),
        static_cast<const int*>(taps), static_cast<const T*>(x), static_cast<const T*>(shift),
        static_cast<T*>(dx), N, H, W, C, Ho, Wo, stride, OP, CP, est, p0, p1);
    return (int)cudaGetLastError();
}

}  // namespace

// bf16: the bf16 mode (g, x, shift, alpha and dx bf16; gs (N, Ho, Wo, 1,
// OP))
BDBNN_EXPORT int bdbnn_binary_conv_dgrad(const void* g, const void* x, const void* shift,
                                         const void* wsign, const void* alpha, const void* taps,
                                         void* gs, void* wb, void* dx, int N, int H, int W, int C,
                                         int O, int kh, int kw, int stride, int Ho, int Wo, int OP,
                                         int CP, int est, float p0, float p1, int bf16,
                                         void* stream) {
    auto run = bf16 ? dgrad<__nv_bfloat16> : dgrad<float>;
    return run(g, x, shift, wsign, alpha, taps, gs, wb, dx, N, H, W, C, O, kh, kw, stride, Ho, Wo,
               OP, CP, est, p0, p1, static_cast<cudaStream_t>(stream));
}
