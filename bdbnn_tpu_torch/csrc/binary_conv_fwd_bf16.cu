// K1 bf16 — fused activation sign + binary (±1) convolution, forward, in
// the bf16 mode (a bf16 model), on Hopper's int8 warpgroup MMA.
//
// Replaces, for bf16 operands, bdbnn_tpu/nn/kernels/binary_conv.py:
// _make_binary_conv (the forward of binary_conv2d_mxu, conv(xb, sign W) *
// alpha) with the activation sign of bdbnn_tpu/nn/binarize.py fused in:
//
//   y[n, ho, wo, o] = bf16(bf16(dot) * alpha[o])
//   dot = sum_{i, j, c} sx(n, ho*s - p + i, wo*s - p + j, c) * wsign[o, i, j, c]
//   sx = sign(x - shift[c]) (sign(0) = +1; the sign of the bf16-rounded
//   difference, which the exact one shares) and 0 in the zero padding;
//   given the uniform bf16 draw u (never with a shift), sx = u <
//   clip(bf16(x + 1)/2, 0, 1) ? +1 : -1.
//
// The reference's bf16 conv rounds the exact dot to bf16 and its bf16
// multiply rounds again; the product of two bf16 values is exact in f32,
// so the epilogue's one rounding of it gives the reference's bits.
//
// Layouts: x, u bf16 NHWC (N, H, W, C); shift bf16 (C,) or NULL; wsign
// int8 (O, kh, kw, C); alpha bf16 (O,); y bf16 NHWC (N, Ho, Wo, O).
// Scratch the wrapper allocates only when the weight sign cannot be read
// by TMA as it is (C not a multiple of 64, or its pointer off 16 bytes):
// wpad int8 (O, kh, kw, CP), CP = C rounded up to 64.
//
// Bound on the H100: an implicit GEMM of M = N*Ho*Wo positions x O
// channels x K = kh*kw*C. Counting bf16 x (read once), the int8 weight
// sign and bf16 y (written once), the flagship's early wide layers are
// bound by bytes, the deep ones by int8 tensor-core operations.
//
// The design (the f32 mode, binary_conv.cu, writes an int8 sign copy in a
// prep pass and gathers it through mma.sync):
// - a block owns 128 positions (two warpgroups of 64) x 64 channels and
//   walks the channels in chunks of 64. For each chunk it reads the input
//   rows its positions touch, halo included, once (a contiguous range of
//   NHWC pixels, since consecutive positions touch consecutive rows), and
//   signs them into shared memory as int8 (80-byte rows, so an
//   ldmatrix's 8 rows meet no bank conflict), with one zero row that
//   every padding tap reads. The sx round trip through device memory
//   goes;
// - every tap then gathers its im2col rows from that buffer: each lane
//   hands ldmatrix the address of its position's pixel at the tap, which
//   gives the warpgroup's A fragment in registers, and
//   wgmma.mma_async m64n64k32 s8 (s32 accumulators) reads the weight
//   sign from shared memory. The chunk's weight sign, all taps at once
//   (9 x 64 bytes deep for a 3 x 3 conv), is brought by TMA, one box of
//   64 channels x 64 bytes a tap in the 64-byte swizzle that wgmma reads,
//   completing on an mbarrier while the threads sign the halo (boxes 16
//   bytes wide, the unswizzled core-matrix layout, took 0.85 ms more a
//   -b 256 step on the H100);
// - the epilogue scales and rounds in registers, stages the tile through
//   shared memory and writes it as 16-byte rows of 8 channels.
// Every ±1 dot is an exact integer (|dot| <= K < 2^24), so float(acc) is
// exact and the output is bitwise its plain version's.
#include "hopper.cuh"

namespace {

constexpr int BM = 128;                  // positions a block, two warpgroups of 64
constexpr int BN = 64;                   // output channels a block
constexpr int CK = 64;                   // channels (bytes of sign) a chunk, each tap
constexpr int THREADS = 256;
constexpr int HP = CK + 16;              // bytes a halo row (one pixel's chunk)
constexpr int B_TAP = BN * CK;           // bytes of one tap's B in a chunk: 64 rows of 64
constexpr int B_ATOM = 8 * CK;           // bytes of 8 such rows, one 64-byte-swizzle atom
constexpr int YPITCH = BN + 8;           // bf16 a staged output row
constexpr int HEAD = 1024;               // the mbarrier, then B from a 1 KB boundary
constexpr int PAD_THREADS = 256;

struct Geom {
    long long M;
    int H, W, C, O, kh, kw, stride, pad, Ho, Wo, CPB, nchunks;
};

__device__ __forceinline__ uint64_t smem_desc_b(uint32_t addr) {
    // K-major, as TMA's 64-byte swizzle lands a tap: a 64-byte row of K
    // for each channel, 8 channels an atom
    return smem_desc(addr, 16, B_ATOM, 2);
}

template <bool STOCH, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
binary_conv_fwd_kernel_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ shift,
                const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ alpha,
                __nv_bfloat16* __restrict__ y, const __grid_constant__ CUtensorMap wmap, Geom G) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
    const uint32_t bar = smem_u32(smem);
    const uint32_t b_base = bar + HEAD;
    const int KK = G.kh * G.kw;
    unsigned char* halo = smem + HEAD + KK * B_TAP;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wg = warp >> 2;
    const int wq = warp & 3;
    const long long m0 = (long long)blockIdx.x * BM;
    const int o0 = blockIdx.y * BN;
    const long long HWo = (long long)G.Ho * G.Wo;

    // the input rows the tile touches: global rows n*H + h from the first
    // position's top tap row to the last position's bottom one
    const long long m_last = min(m0 + BM, G.M) - 1;
    const long long n_a = m0 / HWo, n_b = m_last / HWo;
    const int ho_a = (int)((m0 - n_a * HWo) / G.Wo);
    const int ho_b = (int)((m_last - n_b * HWo) / G.Wo);
    const long long g_lo = n_a * G.H + max(0, ho_a * G.stride - G.pad);
    const long long g_hi = n_b * G.H + min(G.H - 1, ho_b * G.stride - G.pad + G.kh - 1);
    const int npx = (int)((g_hi - g_lo + 1) * G.W);  // <= the wrapper's halo_rows * W
    const long long p_lo = g_lo * G.W;

    // this lane's A row: position m0 + wg*64 + wq*16 + lane % 16, its pixel
    // at tap (0, 0) as a halo row index
    const long long m = m0 + wg * 64 + wq * 16 + (lane & 15);
    const bool mok = m < G.M;
    int h0 = -(1 << 24), w0 = 0;  // a row past the end: every tap is outside
    long long pb = 0;
    if (mok) {
        const long long n = m / HWo;
        const int rem = (int)(m - n * HWo);
        const int ho = rem / G.Wo;
        h0 = ho * G.stride - G.pad;
        w0 = (rem - ho * G.Wo) * G.stride - G.pad;
        pb = (n * G.H + h0) * G.W + w0 - p_lo;
    }

    if (tid == 0) {
        mbar_init(bar, 1);
        mbar_init_fence();
    }
    if (tid < CK / 16)  // the zero row every padding tap reads
        *reinterpret_cast<uint4*>(halo + npx * HP + tid * 16) = make_uint4(0, 0, 0, 0);
    __syncthreads();

    int acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;
    // a tap's A fragments, loaded before its products are issued and
    // waited for before the next tap's are loaded: registers of a product
    // in flight that other instructions define would make ptxas serialize
    // every wgmma (groups of 3 taps a wait, and two taps alternating in
    // flight, were slower on the H100)
    uint32_t af[2][4] = {};

    for (int kc = 0; kc < G.nchunks; ++kc) {
        if (kc > 0) __syncthreads();  // every read of the last chunk's halo and B ended
        if (tid == 0) {
            mbar_expect_tx(bar, (uint32_t)(KK * B_TAP));
            for (int t = 0; t < KK; ++t)
                tma_load_2d(b_base + t * B_TAP, &wmap, bar, t * G.CPB + kc * CK, o0);
        }
        // sign the chunk's halo: 8 channels an item, 8 items a pixel; a
        // thread's channel group is the same in every item (THREADS % 8
        // == 0), and it loads 4 items before it signs them
        const int oc = tid & 7;
        const int c0 = kc * CK + oc * 8;
        const int nc = G.C - c0;
        const uint4 sv = !STOCH && shift != nullptr && nc > 0 ? load8(shift + c0, nc, VEC)
                                                               : make_uint4(0, 0, 0, 0);
        const int items = npx * (CK / 8);
        for (int it0 = tid; it0 < items; it0 += 4 * THREADS) {
            uint4 xv[4], uv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int it = it0 + j * THREADS;
                xv[j] = uv[j] = make_uint4(0, 0, 0, 0);
                if (it < items && nc > 0) {
                    const long long off = (p_lo + (it >> 3)) * G.C + c0;
                    xv[j] = load8(x + off, nc, VEC);
                    if (STOCH) uv[j] = load8(u + off, nc, VEC);
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int it = it0 + j * THREADS;
                if (it >= items) continue;
                uint32_t sb[2] = {0, 0};
                if (VEC && !STOCH && nc > 0) {
                    // the reference's bf16 x - shift, then >= 0; a pair's
                    // masks become int8 +1 (0x01) or -1 (0xFF) bytes
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        unsigned ge[2];
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const uint32_t xp = word(xv[j], 2 * h + e), sp = word(sv, 2 * h + e);
                            ge[e] = __hge2_mask(
                                __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&xp),
                                        *reinterpret_cast<const __nv_bfloat162*>(&sp)),
                                __float2bfloat162_rn(0.f));
                        }
                        sb[h] = 0xFFFFFFFFu ^ (__byte_perm(ge[0], ge[1], 0x6420) & 0xFEFEFEFEu);
                    }
                } else if (nc > 0) {
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        if (e >= nc) continue;  // a channel past C: 0
                        const uint32_t xp = word(xv[j], e >> 1);
                        const float xf = (e & 1) ? hi_f(xp) : lo_f(xp);
                        bool plus;
                        if (STOCH) {
                            const uint32_t up = word(uv[j], e >> 1);
                            plus = stoch_sign_plus_bf16(xf, (e & 1) ? hi_f(up) : lo_f(up));
                        } else {
                            const uint32_t sp = word(sv, e >> 1);
                            plus = __fsub_rn(xf, (e & 1) ? hi_f(sp) : lo_f(sp)) >= 0.f;
                        }
                        sb[e >> 2] |= (plus ? 0x01u : 0xFFu) << (8 * (e & 3));
                    }
                }
                *reinterpret_cast<uint2*>(halo + (it >> 3) * HP + oc * 8) =
                    make_uint2(sb[0], sb[1]);
            }
        }
        __syncthreads();
        mbar_wait(bar, (uint32_t)(kc & 1));
        for (int t = 0; t < KK; ++t) {
            const int ti = t / G.kw;
            const int tj = t - ti * G.kw;
            const bool ok = mok && (unsigned)(h0 + ti) < (unsigned)G.H &&
                            (unsigned)(w0 + tj) < (unsigned)G.W;
            const long long row = ok ? pb + (long long)ti * G.W + tj : npx;
            const uint32_t addr = smem_u32(halo + row * HP + (lane >> 4) * 16);
            __syncwarp();
            // matrix q of the x4 is rows + (q & 1) * 8, bytes + (q >> 1) * 16
            ldsm_x4(addr, af[0][0], af[0][1], af[0][2], af[0][3]);
            ldsm_x4(addr + 32, af[1][0], af[1][1], af[1][2], af[1][3]);
            wgmma_fence();
            const uint32_t bt = b_base + t * B_TAP;
            wgmma_s8_m64n64k32(acc, af[0], smem_desc_b(bt), (kc | t) != 0);
            wgmma_s8_m64n64k32(acc, af[1], smem_desc_b(bt + 32), 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(acc);
            fence_frag(af[0]);
            fence_frag(af[1]);
        }
    }

    // epilogue: acc[4j + e] is row lane/4 + 8(e >> 1), channel 8j +
    // 2(lane % 4) + (e & 1) of this warp's 16 x 64; staged over the halo
    __syncthreads();
    __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(halo);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const int o = o0 + col;
        const float al0 = o < G.O ? __bfloat162float(alpha[o]) : 0.f;
        const float al1 = o + 1 < G.O ? __bfloat162float(alpha[o + 1]) : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = wg * 64 + wq * 16 + (lane >> 2) + 8 * hh;
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                __fmul_rn(round_to_bf16((float)acc[4 * j + 2 * hh]), al0),
                __fmul_rn(round_to_bf16((float)acc[4 * j + 2 * hh + 1]), al1));
            *reinterpret_cast<__nv_bfloat162*>(ys + row * YPITCH + col) = v;
        }
    }
    __syncthreads();
    const bool vec_y = VEC && G.O % 8 == 0;
    for (int it = tid; it < BM * (BN / 8); it += THREADS) {
        const int row = it >> 3;
        const int o = o0 + (it & 7) * 8;
        const long long mm = m0 + row;
        if (mm >= G.M || o >= G.O) continue;
        const __nv_bfloat16* src = ys + row * YPITCH + (it & 7) * 8;
        __nv_bfloat16* dst = y + mm * G.O + o;
        if (vec_y) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
            for (int e = 0; e < 8 && o + e < G.O; ++e) dst[e] = src[e];
        }
    }
}

// the weight sign padded to CP channels a tap (zero beyond C)
__global__ void __launch_bounds__(PAD_THREADS)
fwd_wpad_kernel(const int8_t* __restrict__ wsign, int8_t* __restrict__ wpad, long long total, int C,
            int CP) {
    for (long long i = (long long)blockIdx.x * PAD_THREADS + threadIdx.x; i < total;
         i += (long long)gridDim.x * PAD_THREADS) {
        wpad[i] = padded_weight_sign(wsign, i, C, CP);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (so
// the library links against the runtime alone)
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
                cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

template <bool STOCH, bool VEC>
int launch(const void* x, const void* shift, const void* u, const void* alpha, void* y,
           const CUtensorMap& map, const Geom& G, int smem_bytes, cudaStream_t st) {
    auto kernel = binary_conv_fwd_kernel_bf16<STOCH, VEC>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((G.M + BM - 1) / BM), (unsigned)((G.O + BN - 1) / BN));
    using B = __nv_bfloat16;
    kernel<<<grid, THREADS, smem_bytes, st>>>(static_cast<const B*>(x), static_cast<const B*>(shift),
                                              static_cast<const B*>(u),
                                              static_cast<const B*>(alpha), static_cast<B*>(y),
                                              map, G);
    return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for a halo of halo_rows input rows
// of W pixels and kh*kw taps (the wrapper checks it against the card's
// 227 KB before it launches)
BDBNN_EXPORT int bdbnn_binary_conv_fwd_bf16_smem(int halo_rows, int W, int kh, int kw) {
    const int rows = (halo_rows * W + 1) * HP;
    const int halo = rows > BM * YPITCH * 2 ? rows : BM * YPITCH * 2;
    return 1024 + HEAD + kh * kw * B_TAP + halo;
}

// x, shift (or NULL), u (or NULL), alpha, y bf16; wsign int8 (O, kh, kw,
// C); wpad int8 (O, kh, kw, CP) scratch or NULL (then wsign is read as it
// is: C % 64 == 0 and 16-byte aligned); halo_rows as
// nn/kernels/binary_conv.py fwd_halo_rows gives it
BDBNN_EXPORT int bdbnn_binary_conv_fwd_bf16(const void* x, const void* shift, const void* u,
                                            const void* wsign, const void* alpha, void* wpad,
                                            void* y, int N, int H, int W, int C, int O, int kh,
                                            int kw, int stride, int pad, int Ho, int Wo, int CP,
                                            int halo_rows, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int KK = kh * kw;
    const void* wb = wsign;
    int cpb = C;
    if (wpad != nullptr) {
        const long long total = (long long)O * KK * CP;
        const long long blocks = (total + PAD_THREADS - 1) / PAD_THREADS;
        fwd_wpad_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), PAD_THREADS, 0, st>>>(
            static_cast<const int8_t*>(wsign), static_cast<int8_t*>(wpad), total, C, CP);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        wb = wpad;
        cpb = CP;
    }
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    // the weight sign as (O rows) x (kh*kw*CPB bytes), read in boxes of
    // one tap's 64 bytes x 64 channels, each landing in the 64-byte
    // swizzle wgmma reads
    CUtensorMap map;
    const cuuint64_t dims[2] = {(cuuint64_t)KK * cpb, (cuuint64_t)O};
    const cuuint64_t strides[1] = {(cuuint64_t)KK * cpb};
    const cuuint32_t box[2] = {(cuuint32_t)CK, (cuuint32_t)BN};
    const cuuint32_t estr[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wb), dims, strides, box,
               estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    const Geom G{(long long)N * Ho * Wo, H, W, C, O, kh, kw, stride, pad, Ho, Wo, cpb, CP / CK};
    const int smem_bytes = bdbnn_binary_conv_fwd_bf16_smem(halo_rows, W, kh, kw);
    const bool vec = C % 8 == 0 && aligned16(x) && aligned16(shift) && aligned16(u) &&
                     aligned16(y);
    if (u != nullptr)
        return (vec ? launch<true, true> : launch<true, false>)(x, shift, u, alpha, y, map, G,
                                                                smem_bytes, st);
    return (vec ? launch<false, true> : launch<false, false>)(x, shift, u, alpha, y, map, G,
                                                              smem_bytes, st);
}
