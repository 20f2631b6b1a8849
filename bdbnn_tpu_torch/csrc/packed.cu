// The packed-weight serving kernels: K3 (packbits decode) and K4 (the
// popcount binary conv on the binary tensor cores), forward.
//
// K3 replaces bdbnn_tpu/nn/packed.py:unpack_sign_device +
// packed_dense_weight: the export artifact's np.packbits payload
// (MSB first, flattened in HWIO order) becomes the dense f32 weight
// sign * alpha[o], in HWIO — the layout K2 (weight_binarize.cu) reads.
//   out[e] = (bit e of packed ? +1 : -1) * alpha[e % O]
// Bound on the H100: bytes (1/8 byte read, 4 bytes written per weight,
// one multiply); a forward's 19 weights write 44.6 MB. Where O % 4 == 0
// (every flagship conv) one thread takes a quad, 4 weights: half of a
// packed byte and 4 consecutive channels of one row, so it reads their
// alphas as one float4 (one % a quad) and writes one float4, and a warp's
// store covers 512 contiguous bytes. (A byte a thread, two float4 stores
// each, left every 32-byte sector half written by each store and took 1.6x
// as long at 3x3 512->512 on the H100.) Otherwise (O % 4 != 0, which
// includes every tail byte, or alpha or out off 16 bytes) a thread takes
// a byte and each of its weights on its own, as out[e] above. The grid is
// a grid-stride loop of at most two waves of blocks.
//
// K4 replaces bdbnn_tpu/nn/packed.py:popcount_binary_conv (+ _pack_words):
// the ±1 conv as a popcount dot on 1-bit words, with the activation sign
// of bdbnn_tpu/nn/binarize.py (react's x - act_shift) fused into its
// prep pass. The reference masks the XOR to the valid lanes, since a
// zero-padding tap is a third value (0: the reference pads after the
// sign). The binary tensor cores sum 256 lanes at once, so the mask of a
// spatial padding tap (one per row) cannot ride inside the MMA; K4 uses
// the identity, exact over the valid lanes of a row (x, w in {0, 1} for
// -1, +1; x = 0 at a padding tap and past C):
//   dot = 4 popc(x & w) - 2 popc(x) - 2 popc(m & w) + popc(m)
//   y = dot * alpha[o]
// where popc(m) = C * (valid taps of the row), popc(x) sums the prep
// pass's per-pixel counts over the row's valid taps, and popc(m & w)
// sums a per-(tap, o) table of the weight's +1 counts over them. AND is
// the only b1 operation wgmma has, so a later wgmma version keeps this
// identity (the card's ptxas takes .xor.popc too, as two AND BMMAs).
// Layouts as K1: x f32 NHWC, shift f32 (C,) or NULL, wsign int8
// (O, kh, kw, C), alpha f32 (O,), y f32 NHWC (N, Ho, Wo, O). Scratch the
// wrapper allocates: xbits (N, H, W, CPB) bytes and xcount int32
// (N, H, W); wbits (O, kh, kw, CPB) bytes and wcount int32 (kh*kw, O).
// CPB = C rounded up to 64 lanes, in bytes, so each 8-byte copy lies in
// one tap. Lane c of a pixel is bit c % 32 of its uint32 word c / 32 (the
// reference's _pack_words order).
// Bound on the H100: as K1 — the bytes of f32 x and y at the wide,
// early layers, the operations at the deep ones, counted as the int8
// MACs of the same product (NVIDIA publishes no b1 rate for the H100).
// The design, in two launches of one entry:
// 1. a prep pass: a warp packs a pixel's signs, 32 channels a
//    __ballot_sync, and counts its +1s; another packs one tap of one
//    channel's weight signs and counts them;
// 2. the implicit GEMM of sign_gemm.cuh on the bit rows (128 positions x
//    64 channels a block, a 4-stage ring of 32-byte stages in 8-byte
//    cp.async copies, ldmatrix), mma.sync m16n8k256 b1 AND-popc (one
//    BMMA.168256.AND.POPC): a row carries 8 times fewer bytes than K1's
//    and the 64-lane padding and 32-byte stage keep its MMAs to what the
//    row needs. Before the main loop each thread sums its row's valid
//    taps' counts; a row's valid taps form a rectangle of the kernel, so
//    the block keeps 2-D prefix sums of its channels' weight counts in
//    shared memory and the epilogue takes popc(m & w) from four of them.
// The integer dot equals K1's exactly, so the output is bitwise K1's.
#include "sign_gemm.cuh"

namespace {

constexpr int UNPACK_THREADS = 256;
// two waves of the H100's 132 SMs at 8 blocks of 256 threads an SM
constexpr int UNPACK_MAX_BLOCKS = 2 * 132 * 8;

__device__ __forceinline__ float signed_alpha(uint32_t byte, int i, float a) {
    return ((byte >> (7 - i)) & 1u ? 1.f : -1.f) * a;
}

template <bool VEC>
__global__ void __launch_bounds__(UNPACK_THREADS)
unpack_sign_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ alpha,
                   float* __restrict__ out, int n, int O) {
    const int stride = gridDim.x * UNPACK_THREADS;
    if (VEC) {
        // a quad q: weights 4q .. 4q + 3, half of byte q / 2 (the high
        // half first), channels 4q % O .. + 3
        for (int q = blockIdx.x * UNPACK_THREADS + threadIdx.x; q < n / 4; q += stride) {
            const uint32_t byte = __ldg(packed + q / 2);
            const uint32_t nib = q & 1 ? byte : byte >> 4;  // bits 3..0: weights 0..3
            const float4 a = __ldg(reinterpret_cast<const float4*>(alpha + (4 * q) % O));
            reinterpret_cast<float4*>(out)[q] =
                make_float4(signed_alpha(nib, 4, a.x), signed_alpha(nib, 5, a.y),
                            signed_alpha(nib, 6, a.z), signed_alpha(nib, 7, a.w));
        }
    } else {
        for (int b = blockIdx.x * UNPACK_THREADS + threadIdx.x; b < (n + 7) / 8; b += stride) {
            const uint32_t byte = __ldg(packed + b);
            for (int i = 0; i < 8 && 8 * b + i < n; ++i)
                out[8 * b + i] = signed_alpha(byte, i, __ldg(alpha + (8 * b + i) % O));
        }
    }
}

constexpr int PREP_THREADS = 256;
using Tile = sg::Stage<32, 8>;  // 32-byte stages (one MMA) in 8-byte copies

// Warp items: a pixel of x (its words and its +1 count), then a (channel,
// tap) of wsign (its words and its +1 count).
__global__ void __launch_bounds__(PREP_THREADS)
popcount_prep_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                     const int8_t* __restrict__ wsign, uint32_t* __restrict__ xbits,
                     int* __restrict__ xcount, uint32_t* __restrict__ wbits,
                     int* __restrict__ wcount, long long pixels, int C, int O, int KK, int CW) {
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * (PREP_THREADS / 32);
    for (long long it = ((long long)blockIdx.x * PREP_THREADS + threadIdx.x) >> 5;
         it < pixels + (long long)O * KK; it += warps) {
        // a row of C signs: x - shift of a pixel, or a weight tap's
        const bool is_x = it < pixels;
        const long long row = is_x ? it : it - pixels;  // wsign row = o * KK + tap
        int count = 0;  // this lane's +1s
        for (int wd = 0; wd < CW; ++wd) {
            const int c = wd * 32 + lane;
            bool plus = false;
            if (c < C) {
                if (is_x) {
                    const float xv = x[row * C + c];
                    plus = (shift != nullptr ? __fsub_rn(xv, shift[c]) : xv) >= 0.f;
                } else {
                    plus = wsign[row * C + c] > 0;
                }
            }
            const uint32_t word = __ballot_sync(0xffffffffu, plus);
            count += plus;
            if (lane == 0) (is_x ? xbits : wbits)[row * CW + wd] = word;
        }
        count = __reduce_add_sync(0xffffffffu, count);
        if (lane == 0) {
            if (is_x)
                xcount[row] = count;
            else
                wcount[(row % KK) * O + row / KK] = count;
        }
    }
}

__global__ void __launch_bounds__(sg::THREADS, 3)
popcount_conv_fwd_kernel(const uint32_t* __restrict__ xbits, const int* __restrict__ xcount,
                         const uint32_t* __restrict__ wbits, const int* __restrict__ wcount,
                         const float* __restrict__ alpha, float* __restrict__ y, ConvGeom g,
                         int C, int kh) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // after the ring: the 2-D prefix sums over the taps of the block's
    // channels' +1 weight counts, (kh + 1) x (kw + 1) x BN
    int* wpre = reinterpret_cast<int*>(smem_raw + Tile::SMEM_BYTES);
    __shared__ int rterm[sg::BM];  // popc(m) - 2 popc(x) of the row
    __shared__ unsigned rtaps[sg::BM];  // its valid taps: i0 | i1 << 8 | j0 << 16 | j1 << 24
    const long long m0 = (long long)blockIdx.x * sg::BM;
    const int o0 = blockIdx.y * sg::BN;
    const int kw = g.kw;
    const int pw = kw + 1;
    {
        // the row terms of row threadIdx.x (BM == THREADS): its valid taps
        // are the rectangle [i0, i1) x [j0, j1) of the kernel
        const long long m = m0 + threadIdx.x;
        int term = 0;
        unsigned taps = 0;
        if (m < g.M) {
            const long long hw = (long long)g.Ho * g.Wo;
            const long long n = m / hw;
            const int rem = (int)(m - n * hw);
            const int ho = rem / g.Wo;
            const int h0 = ho * g.stride - g.pad;
            const int w0 = (rem - ho * g.Wo) * g.stride - g.pad;
            const int i0 = min(kh, max(0, -h0)), i1 = max(i0, min(kh, g.H - h0));
            const int j0 = min(kw, max(0, -w0)), j1 = max(j0, min(kw, g.W - w0));
            int px = 0;
#pragma unroll 9
            for (int t = 0; t < g.KK; ++t) {
                const int i = t / kw, j = t - (t / kw) * kw;
                if (i >= i0 && i < i1 && j >= j0 && j < j1)
                    px += xcount[(n * g.H + h0 + i) * g.W + w0 + j];
            }
            term = C * (i1 - i0) * (j1 - j0) - 2 * px;
            taps = (unsigned)i0 | (unsigned)i1 << 8 | (unsigned)j0 << 16 | (unsigned)j1 << 24;
        }
        rterm[threadIdx.x] = term;
        rtaps[threadIdx.x] = taps;
        // the weight counts at (i + 1, j + 1), zeros in row and column 0
        const int cells = (kh + 1) * pw * sg::BN;
        for (int e = threadIdx.x; e < cells; e += sg::THREADS) {
            const int c = e % sg::BN;
            const int cell = e / sg::BN;
            const int i = cell / pw - 1, j = cell % pw - 1;
            wpre[e] = i >= 0 && j >= 0 && o0 + c < g.O ? wcount[(i * kw + j) * g.O + o0 + c] : 0;
        }
        __syncthreads();
        if (threadIdx.x < sg::BN) {
            for (int i = 1; i <= kh; ++i)
                for (int j = 1; j <= kw; ++j) {
                    int* p = wpre + (i * pw + j) * sg::BN + threadIdx.x;
                    *p += p[-pw * sg::BN] + p[-sg::BN] - p[-(pw + 1) * sg::BN];
                }
        }
    }
    int acc[4][4][4];
    sign_gemm_mainloop<true, Tile>(reinterpret_cast<const uint8_t*>(xbits),
                                   reinterpret_cast<const uint8_t*>(wbits), g, smem_raw, acc);
    __syncthreads();
    // popc(m & w) of row r at channel c of the block: the +1 weights of the
    // row's valid taps, a rectangle sum of the prefix table
    auto mask_w = [&](int r, int c) {
        const unsigned t = rtaps[r];
        const int i0 = t & 255, i1 = (t >> 8) & 255, j0 = (t >> 16) & 255, j1 = t >> 24;
        const int* p = wpre + c;
        return p[(i1 * pw + j1) * sg::BN] - p[(i0 * pw + j1) * sg::BN] -
               p[(i1 * pw + j0) * sg::BN] + p[(i0 * pw + j0) * sg::BN];
    };
    sign_gemm_for_each(acc, [&](int r, int c, int d0, int d1) {
        const int o = o0 + c;
        if (m0 + r >= g.M || o >= g.O) return;
        const int e0 = 4 * d0 + rterm[r] - 2 * mask_w(r, c);
        const int e1 = o + 1 < g.O ? 4 * d1 + rterm[r] - 2 * mask_w(r, c + 1) : 0;
        store_scaled(y, alpha, m0 + r, o, g.O, e0, e1);
    });
}

}  // namespace

BDBNN_EXPORT int bdbnn_unpack_sign(const void* packed, const void* alpha, void* out, int n,
                                   int O, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = O % 4 == 0 && reinterpret_cast<uintptr_t>(alpha) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int items = vec ? n / 4 : (n + 7) / 8;  // quads, or bytes
    const int blocks = (items + UNPACK_THREADS - 1) / UNPACK_THREADS;
    const dim3 grid((unsigned)(blocks < UNPACK_MAX_BLOCKS ? blocks : UNPACK_MAX_BLOCKS));
    const uint8_t* p = static_cast<const uint8_t*>(packed);
    const float* a = static_cast<const float*>(alpha);
    float* o = static_cast<float*>(out);
    auto kernel = vec ? unpack_sign_kernel<true> : unpack_sign_kernel<false>;
    kernel<<<grid, UNPACK_THREADS, 0, st>>>(p, a, o, n, O);
    return (int)cudaGetLastError();
}

BDBNN_EXPORT int bdbnn_popcount_conv_fwd(const void* x, const void* shift, const void* wsign,
                                         const void* alpha, void* xbits, void* xcount,
                                         void* wbits, void* wcount, void* y, int N, int H, int W,
                                         int C, int O, int kh, int kw, int stride, int pad,
                                         int Ho, int Wo, int CPB, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long pixels = (long long)N * H * W;
    const long long items = pixels + (long long)O * kh * kw;
    const long long pblocks = (items + PREP_THREADS / 32 - 1) / (PREP_THREADS / 32);
    popcount_prep_kernel<<<(unsigned)(pblocks < 132 * 32 ? pblocks : 132 * 32), PREP_THREADS, 0,
                           st>>>(static_cast<const float*>(x), static_cast<const float*>(shift),
                                 static_cast<const int8_t*>(wsign), static_cast<uint32_t*>(xbits),
                                 static_cast<int*>(xcount), static_cast<uint32_t*>(wbits),
                                 static_cast<int*>(wcount), pixels, C, O, kh * kw, CPB / 4);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int smem = Tile::SMEM_BYTES + (kh + 1) * (kw + 1) * sg::BN * (int)sizeof(int);
    err = cudaFuncSetAttribute(popcount_conv_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const ConvGeom g{(long long)N * Ho * Wo, H, W, O, kw, kh * kw, stride, pad, Ho, Wo, CPB};
    const dim3 grid((unsigned)((g.M + sg::BM - 1) / sg::BM), (unsigned)((O + sg::BN - 1) / sg::BN));
    popcount_conv_fwd_kernel<<<grid, sg::THREADS, smem, st>>>(
        static_cast<const uint32_t*>(xbits), static_cast<const int*>(xcount),
        static_cast<const uint32_t*>(wbits), static_cast<const int*>(wcount),
        static_cast<const float*>(alpha), static_cast<float*>(y), g, C, kh);
    return (int)cudaGetLastError();
}
