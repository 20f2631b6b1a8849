// K6 bf16 — binary (±1) convolution backward, weight gradient, in the
// bf16 mode (a bf16 model), with the latent weight's straight-through
// estimator fused into its epilogue, on Hopper's warpgroup MMA.
//
// Replaces, for bf16 operands, the d(sign W) half of
// bdbnn_tpu/nn/kernels/binary_conv.py:107-110 (jax.vjp of _forward: the
// conv weight gradient of xb and the bf16 cotangent g * alpha) and the
// weight sign's ste_sign backward (bdbnn_tpu/nn/binarize.py:466-471):
//
//   dW[i, j, c, o] = f32(bf16(S) * 1{|bf16(W[i, j, c, o])| <= 1})
//   S = sum_{n, ho, wo} sx(n, ho*s - p + i, wo*s - p + j, c) * ga[n, ho, wo, o]
//   ga = bf16(g * alpha[o]) (the reference's bf16 multiply), sx =
//   sign(x - shift[c]) with sign(0) = +1 and 0 in the zero padding, or,
//   given the forward's bf16 draw u, the sampled sign u < clip(bf16(x +
//   1)/2, 0, 1) ? +1 : -1 that K1 took.
//
// Layouts: g bf16 NHWC (N, Ho, Wo, O); x bf16 NHWC (N, H, W, C); shift
// bf16 (C,) or NULL; u bf16 like x or NULL; alpha bf16 (O,); W and dW f32
// HWIO = (kh*kw*C, O). Scratch the wrapper allocates when the reduction
// is split: partial f64 (splits, kh*kw*C, O).
//
// Bound on the H100: a GEMM of kh*kw*C x O outputs over M = N*Ho*Wo
// positions, 2*MACs on the bf16 tensor cores beside the bytes of g, x, W
// and dW. But every product is exact (±1 times a bf16 value) and the sum
// must stay within 4u*sum|terms| (u = 2^-24) of the exact one, so the
// tensor cores' f32 sums are folded into f64 totals every 32 positions:
// that fold (an f32-to-f64 conversion, 16 a clock an SM, and an f64 add)
// and the operands' bytes through L2 bound this kernel on the card, not
// its ~4,096 bf16 flop/clk/SM.
//
// The design (the f32 mode, binary_conv_wgrad.cu, writes sign and ga
// copies in a prep pass, folds after every k step and splits the reduction
// into partials of about the bound's size):
// - a block owns 128 dW rows (r = tap * CP + c, two warpgroups of 64) x
//   64 output channels, and is warp-specialized: two producer warpgroups
//   copy each stage of 128 positions of bf16 x (and u) and g into a
//   raw ring by cp.async, a stage ahead (none with u: the draw doubles a
//   stage), and when a stage has landed build the operands in shared
//   memory from it: the sign
//   (the hard sign of x - shift, by bf16x2 subtract and compare, or the
//   sampled one; 0 in the padding) and bf16(g * alpha). No sx or ga copy
//   goes through device memory. A 2-stage ring with full/empty mbarriers
//   hands the operands to the two consumer warpgroups;
// - the sign tile is stored (position, r) and reaches each consumer warp
//   as its wgmma A fragment by ldmatrix.trans; the ga tile is stored as
//   wgmma's MN-major core matrices (8 positions x 8 channels, 16 padding
//   bytes between channel groups so the stores meet no bank conflict),
//   and wgmma.mma_async m64n64k16 bf16 reads it from shared memory into
//   f32 accumulators;
// - fold: every chain of L = 2 wgmma k steps (32 positions) starts from
//   scale-d = 0, and its f32 result is added to an f64 total (the
//   conversion is exact, the add on the f64 pipe, which nothing else
//   here uses: 2 instructions where a compensated f32 pair took 7);
// - the tile stays 128 x 64, since its f64 totals hold the register file:
//   a consumer thread keeps 32 f32 accumulators and 32 f64 totals (96
//   registers) of its warpgroup's 64 x 64. A 128 x 128 tile doubles that
//   to 192 a thread, past the 160 a consumer gets beside producers that
//   spill below 96; a 256 x 64 tile takes four consumer warpgroups, 512 x
//   160 + 256 x 96 registers against the SM's 65,536. At 128-position
//   stages their rings would take 279 and 340 KB of shared memory, where
//   this one takes 209 of the 227 KB a block may have;
// - the reduction over positions is split only as far as filling the
//   card's 132 SMs takes (nn/kernels/binary_conv.py wgrad_bf16_splits:
//   a function of the shapes alone, partials a few MB); a second pass
//   adds the splits' f64 totals in split order. No float atomics, one
//   writer per output: two runs give the same bits.
//
// Why L = 2 (the error bound the gate holds). chip_smoke.py's gate holds
// S to 4u*sum|terms| beside one bf16 rounding of the exact sum. Model of
// the tensor cores: products are exact, and each wgmma k step forms c +
// (its 16 products) with at most one truncation of the result, an error
// below ulp(c') <= 2u|c'| for the running value c' (truncation, not
// rounding to nearest: on the H100 the f32 modes' same-sign probes,
// chip_smoke.py phase_k5_same_sign and phase_k6_same_sign, drift by about
// one u*sum|terms| in one direction, where rounding to nearest would
// cancel). A chain of L steps from zero errs by less than
// 2u * sum_{j<=L} |c'_j| <= 2u * L * sum|chain's terms| (the bound is
// reached by a large first step followed by steps whose bits all fall
// below the running value's last place). The f64 total of a split, and
// the f64 sum of the splits, add at most 2^-53 * sum|chain results| an
// addition: under (chains) * 2^-53 * sum|terms| = 0.00003u * sum|terms|
// for the 15,680 chains of a layer1 split at -b 4,160; the total is
// rounded to bf16 once (2^-9 |S|), inside the gate's one-bf16-rounding
// allowance 2^-8 |S|. So to first order in u the chains get the whole
// 4u*sum|terms|: 2u * L <= 4u, L = 2. (L = 1 with a Kahan fold, the f32
// mode's, is 2u + 2u.) The fold then costs an f32-to-f64 conversion and
// an f64 add for every 32 positions of an output, where a Kahan fold
// after every k step spends 5 f32 operations for every 16.
#include "hopper.cuh"

namespace {

constexpr int BM = 128;                 // dW rows a block, two warpgroups of 64
constexpr int BN = 64;                  // output channels a block
constexpr int BK = 128;                 // positions a stage: eight 16-deep k steps
constexpr int CHAIN = 2;                // k steps a chain between folds (L above)
constexpr int CONSUMERS = 256;          // two warpgroups: wgmma and the fold
constexpr int PRODUCERS = 256;          // two warpgroups: loads and operands
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int NSTAGE = 2;               // stages in the operand ring
constexpr int APITCH = BM + 8;          // bf16 a sign-tile row (one position): the 8
                                        // rows an ldmatrix reads fall on 8 bank groups
constexpr int A_STAGE = BK * APITCH * 2;            // bytes
constexpr int B_SBO = 144;                          // bytes between channel groups
constexpr int B_LBO = (BN / 8) * B_SBO;             // bytes between position groups
constexpr int B_STAGE = (BK / 8) * B_LBO;           // bytes
constexpr int STAGE = A_STAGE + B_STAGE;
constexpr int RAW_X = BK * BM * 2;      // bytes of a stage's raw x (or u) chunks
constexpr int RAW_G = BK * BN * 2;      // bytes of a stage's raw g chunks
constexpr int TABLES = (BM + BN) * 2;   // shift of each tile row, alpha of each channel
constexpr int POS = BK * 16;             // bytes of a stage's position table
// the raw ring: stages of loads in flight ahead of the operands (fewer
// when the draw u doubles a stage's bytes). The position tables, shared
// by the producers, take two slots whatever the ring's depth: stage s's
// table is written after the producers' barrier of stage s - 1, which
// each producer passes only once it has read stage s - 2's, the table
// the write replaces
template <bool STOCH>
struct Raw {
    static constexpr int STAGES = STOCH ? 1 : 2;
    static constexpr int BYTES = RAW_X * (STOCH ? 2 : 1) + RAW_G;
    static constexpr int SMEM = NSTAGE * STAGE + STAGES * BYTES + 2 * POS + TABLES + 2 * NSTAGE * 8;
};
constexpr int REDUCE_THREADS = 256;
constexpr int A_PER = BK * (BM / 8) / PRODUCERS;  // sign chunks a producer a stage
constexpr int B_PER = BK * (BN / 8) / PRODUCERS;  // g chunks a producer a stage
// registers a thread once the producers hand theirs over (entry: 64K / 512)
constexpr int PRODUCER_REGS = 96;
constexpr int CONSUMER_REGS = 160;
static_assert(BK % (CHAIN * 16) == 0 && A_PER * PRODUCERS == BK * (BM / 8) &&
                  B_PER * PRODUCERS == BK * (BN / 8) && BK <= PRODUCERS,
              "whole chains a stage; whole chunks a producer");
static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 65536, "registers");
static_assert(Raw<false>::SMEM <= 232448 && Raw<true>::SMEM <= 232448, "shared memory");

struct Geom {
    int H, W, C, O, KK, kw, stride, pad, Ho, Wo, CP, M, rows_per_split, splits;
};

// dW = f32(bf16(S) * 1{|bf16(W)| <= 1}), S rounded to bf16 once from
// f64: a masked entry is s * 0, which keeps the sign of zero, as the
// reference's g * (|W| <= 1).astype(g.dtype)
__device__ __forceinline__ float masked(double s, float w) {
    return __fmul_rn(__bfloat162float(__double2bfloat16(s)),
                     fabsf(round_to_bf16(w)) <= 1.f ? 1.f : 0.f);
}

template <bool STOCH, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
binary_conv_wgrad_kernel_bf16(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ shift, const __nv_bfloat16* __restrict__ u,
                  const __nv_bfloat16* __restrict__ alpha, const float* __restrict__ w,
                  double* __restrict__ part, float* __restrict__ dw, Geom G) {
    using R = Raw<STOCH>;
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t base = smem_u32(smem);
    unsigned char* raw = smem + NSTAGE * STAGE;
    int4* pos_tab = reinterpret_cast<int4*>(raw + R::STAGES * R::BYTES);  // stage s: + BK * (s & 1)
    __nv_bfloat16* sh_tab = reinterpret_cast<__nv_bfloat16*>(raw + R::STAGES * R::BYTES + 2 * POS);
    __nv_bfloat16* al_tab = sh_tab + BM;
    const uint32_t full0 = smem_u32(sh_tab) + TABLES;  // stage s: + 8s
    const uint32_t empty0 = full0 + 8 * NSTAGE;

    const int r0 = blockIdx.x * BM;
    const int o0 = blockIdx.y * BN;
    const int mbeg = blockIdx.z * G.rows_per_split;
    const int mend = min(G.M, mbeg + G.rows_per_split);
    const int HWo = G.Ho * G.Wo;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nst = mend > mbeg ? (mend - mbeg + BK - 1) / BK : 0;

    // the tile's shift (by row r = tap * CP + c) and alpha, and the ring's
    // barriers: a stage is full when every producer has stored its part,
    // empty when every consumer has read it
    if (tid < BM) {
        const int r = r0 + tid;
        const int tap = r / G.CP;
        const int c = r - tap * G.CP;
        sh_tab[tid] = !STOCH && shift != nullptr && tap < G.KK && c < G.C
                          ? shift[c] : __ushort_as_bfloat16(0);
    } else if (tid < BM + BN) {
        const int o = o0 + tid - BM;
        al_tab[tid - BM] = o < G.O ? alpha[o] : __ushort_as_bfloat16(0);
    }
    if (tid == 0) {
        for (int st = 0; st < NSTAGE; ++st) {
            mbar_init(full0 + 8 * st, PRODUCERS);
            mbar_init(empty0 + 8 * st, CONSUMERS);
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        // producers: each thread copies A_PER chunks of x (and u) of one
        // 8-row group of the sign tile (one tap, 8 channels) at positions
        // tp/16 + (PRODUCERS/16)j, and B_PER chunks of g of one channel
        // group at positions tp/8 + (PRODUCERS/8)j, into the raw ring
        // (cp.async, R::STAGES - 1 stages ahead):
        // neighbouring lanes copy neighbouring 16 bytes of one pixel or g
        // row. When a stage has landed it turns its own copies into the
        // operands, the sign tile and the ga tile; its copies are its own
        // alone, stored chunk-major (no bank conflict).
        regs_release<PRODUCER_REGS>();
        const int tp = tid - CONSUMERS;
        const int oa = tp & 15;  // the sign tile's 8-row group
        const int og = tp & 7;   // the ga tile's channel group
        int ac, adh, adw;        // channel (-1 past the taps); tap offset from (ho*s, wo*s)
        {
            const int r = r0 + oa * 8;
            const int tap = r / G.CP;
            const int ti = tap / G.kw;
            ac = tap < G.KK && r - tap * G.CP < G.C ? r - tap * G.CP : -1;
            adh = ti - G.pad;
            adw = tap - ti * G.kw - G.pad;
        }
        const int nca = G.C - ac;
        const uint4 sv = *reinterpret_cast<const uint4*>(sh_tab + oa * 8);
        const uint4 av = *reinterpret_cast<const uint4*>(al_tab + og * 8);
        const int ob = o0 + og * 8;
        // producers 0 .. BK-1 each follow one position of the stage, (n, ho, wo),
        // stepped by BK positions a stage without a division, and publish
        // it in the stage's position table
        const int step_ho = BK / G.Wo, step_wo = BK - step_ho * G.Wo;
        int m = mbeg + tp, n = 0, ho = 0, wo = 0;
        if (tp < BK && m < mend) {
            n = m / HWo;
            const int rem = m - n * HWo;
            ho = rem / G.Wo;
            wo = rem - ho * G.Wo;
        }
        // one 16-byte chunk into the raw ring: cp.async (a zero fill where
        // !ok), or, off the vector path, loaded and stored here
        auto copy = [&](unsigned char* dst, const __nv_bfloat16* src, int nc, bool ok) {
            if (VEC) {
                cp_async16(smem_u32(dst), ok ? src : x, ok);
            } else {
                *reinterpret_cast<uint4*>(dst) = ok ? load8(src, nc, false) : make_uint4(0, 0, 0, 0);
            }
        };
        // stage s's copies into raw slot s % R::STAGES; returns the A_PER
        // bits of which of its sign chunks lie inside the image
        auto issue = [&](int s) -> uint32_t {
            unsigned char* rs = raw + (s % R::STAGES) * R::BYTES;
            int4* pos = pos_tab + BK * (s & 1);
            if (tp < BK) {
                const int h0 = ho * G.stride, w0 = wo * G.stride;
                pos[tp] = m < mend ? make_int4((n * G.H + h0) * G.W + w0, h0, w0, 0)
                                   : make_int4(0, -(1 << 24), 0, 0);
                m += BK;
                wo += step_wo;
                ho += step_ho;
                if (wo >= G.Wo) {
                    wo -= G.Wo;
                    ++ho;
                }
                while (ho >= G.Ho) {
                    ho -= G.Ho;
                    ++n;
                }
            }
            asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");  // the table is written
            uint32_t mask = 0;
#pragma unroll
            for (int j = 0; j < A_PER; ++j) {
                const int4 pj = pos[(tp >> 4) + (PRODUCERS / 16) * j];
                const int h = pj.y + adh, wi = pj.z + adw;
                const bool ok = ac >= 0 && (unsigned)h < (unsigned)G.H && (unsigned)wi < (unsigned)G.W;
                const long long at = ok ? (long long)(pj.x + adh * G.W + adw) * G.C + ac : 0;
                const int off = (j * PRODUCERS + tp) * 16;
                copy(rs + off, x + at, nca, ok);
                if (STOCH) copy(rs + RAW_X + RAW_G + off, u + at, nca, ok);
                mask |= (uint32_t)ok << j;
            }
#pragma unroll
            for (int j = 0; j < B_PER; ++j) {
                const int mj = mbeg + s * BK + (tp >> 3) + (PRODUCERS / 8) * j;
                const bool ok = mj < mend && ob < G.O;
                copy(rs + RAW_X + (j * PRODUCERS + tp) * 16,
                     g + (ok ? (long long)mj * G.O + ob : 0), G.O - ob, ok);
            }
            return mask;
        };
        auto transform = [&](int s, uint32_t okmask) {
            const unsigned char* rs = raw + (s % R::STAGES) * R::BYTES;
            unsigned char* as = smem + (s % NSTAGE) * STAGE;
#pragma unroll
            for (int j = 0; j < A_PER; ++j) {
                const int off = (j * PRODUCERS + tp) * 16;
                uint4 out = make_uint4(0, 0, 0, 0);
                if (okmask >> j & 1u) {
                    const uint4 xv = *reinterpret_cast<const uint4*>(rs + off);
                    uint4 uv = make_uint4(0, 0, 0, 0);
                    if (STOCH) uv = *reinterpret_cast<const uint4*>(rs + RAW_X + RAW_G + off);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        uint32_t bits;
                        if (VEC && !STOCH) {
                            // the reference's bf16 x - shift, then >= 0: +1
                            // is -1 with the sign bit flipped
                            const uint32_t xp = word(xv, i), sp = word(sv, i);
                            const unsigned ge = __hge2_mask(
                                __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&xp),
                                        *reinterpret_cast<const __nv_bfloat162*>(&sp)),
                                __float2bfloat162_rn(0.f));
                            bits = 0xBF80BF80u ^ (ge & 0x80008000u);
                        } else {
                            bits = 0;
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                if (2 * i + e >= nca) continue;  // a channel past C: 0
                                const uint32_t xp = word(xv, i);
                                const float xf = e ? hi_f(xp) : lo_f(xp);
                                bool plus;
                                if (STOCH) {
                                    const uint32_t up = word(uv, i);
                                    plus = stoch_sign_plus_bf16(xf, e ? hi_f(up) : lo_f(up));
                                } else {
                                    const uint32_t sp = word(sv, i);
                                    plus = __fsub_rn(xf, e ? hi_f(sp) : lo_f(sp)) >= 0.f;
                                }
                                bits |= (plus ? 0x3F80u : 0xBF80u) << (16 * e);
                            }
                        }
                        set_word(out, i, bits);
                    }
                }
                const int p = (tp >> 4) + (PRODUCERS / 16) * j;
                *reinterpret_cast<uint4*>(as + (p * APITCH + oa * 8) * 2) = out;
            }
#pragma unroll
            for (int j = 0; j < B_PER; ++j) {
                const int p = (tp >> 3) + (PRODUCERS / 8) * j;
                const uint4 gv =
                    *reinterpret_cast<const uint4*>(rs + RAW_X + (j * PRODUCERS + tp) * 16);
                uint4 out;
#pragma unroll
                for (int i = 0; i < 4; ++i) set_word(out, i, ga_bf16x2(word(gv, i), word(av, i)));
                *reinterpret_cast<uint4*>(as + A_STAGE + (p >> 3) * B_LBO + og * B_SBO +
                                          (p & 7) * 16) = out;
            }
        };
        // masks of the stages in flight, the newest in the low byte
        static_assert(R::STAGES <= 8, "a byte a stage in flight");
        uint64_t ring = 0;
#pragma unroll
        for (int s = 0; s < R::STAGES - 1; ++s) {
            ring = (ring << 8) | (s < nst ? issue(s) : 0u);
            cp_async_commit();
        }
        for (int s = 0; s < nst; ++s) {
            const int ahead = s + R::STAGES - 1;
            ring = (ring << 8) | (ahead < nst ? issue(ahead) : 0u);
            cp_async_commit();
            cp_async_wait<R::STAGES - 1>();  // this thread's copies of stage s landed
            const int slot = s % NSTAGE;
            mbar_wait(empty0 + 8 * slot, ((s / NSTAGE) & 1) ^ 1);
            transform(s, (uint32_t)(ring >> (8 * (R::STAGES - 1))) & 0xFFu);
            fence_proxy_async();
            mbar_arrive(full0 + 8 * slot);
        }
        cp_async_wait<0>();
        return;
    }

    // consumers: warpgroup wg owns dW rows wg*64 .. +63 of the tile, its
    // warp wq rows wq*16 .. +15 of those. A chain is waited for before its
    // fold (a read of the accumulators of a product in flight would make
    // ptxas serialize every wgmma); the two consumer warpgroups take turns
    // on the tensor cores, one folding while the other's chain runs
    regs_claim<CONSUMER_REGS>();
    const int wg = warp >> 2;
    const int wq = warp & 3;
    float acc[32];
    double tot[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        acc[i] = 0.f;
        tot[i] = 0.0;
    }
    uint32_t af[CHAIN][4] = {};
    // one chain: CHAIN k steps of a stage from k step k0, the first from
    // scale-d = 0; then wait for it
    auto chain = [&](int slot, int k0) {
        __syncwarp();
        const unsigned char* as = smem + slot * STAGE;
#pragma unroll
        for (int k = 0; k < CHAIN; ++k) {
            // the sign tile is stored (position, r): the A fragment (rows r,
            // k = positions) comes transposed; matrix q of the x4 is rows +
            // (q & 1) * 8, positions + (q >> 1) * 8
            const int q = lane >> 3;
            const int krow = (k0 + k) * 16 + (lane & 7) + (q >> 1) * 8;
            const int col = wg * 64 + wq * 16 + (q & 1) * 8;
            ldsm_x4_t(smem_u32(as + (krow * APITCH + col) * 2), af[k][0], af[k][1], af[k][2],
                      af[k][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < CHAIN; ++k) {
            const uint32_t bk = base + slot * STAGE + A_STAGE + (k0 + k) * 2 * B_LBO;
            wgmma_bf16_m64n64k16(acc, af[k], smem_desc(bk, B_LBO, B_SBO), k);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int k = 0; k < CHAIN; ++k) fence_frag(af[k]);
    };
    for (int s = 0; s < nst; ++s) {
        const int slot = s % NSTAGE;
        mbar_wait(full0 + 8 * slot, (s / NSTAGE) & 1);
#pragma unroll
        for (int k0 = 0; k0 < BK / 16; k0 += CHAIN) {
            chain(slot, k0);
            if (k0 + CHAIN == BK / 16) mbar_arrive(empty0 + 8 * slot);  // the stage is read
            fold_f64(tot, acc);
        }
    }

    // epilogue: thread element acc[4j + e] is row lane/4 + 8(e >> 1),
    // column 8j + 2(lane % 4) + (e & 1) of its warp's 16 x 64
    const long long KO = (long long)G.KK * G.C * G.O;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = r0 + wg * 64 + wq * 16 + (lane >> 2) + 8 * (e >> 1);
            const int o = o0 + 8 * j + 2 * (lane & 3) + (e & 1);
            const int tap = r / G.CP;
            const int c = r - tap * G.CP;
            if (tap >= G.KK || c >= G.C || o >= G.O) continue;
            const long long idx = (long long)(tap * G.C + c) * G.O + o;
            const int i = 4 * j + e;
            if (G.splits == 1)
                dw[idx] = masked(tot[i], w[idx]);
            else
                part[blockIdx.z * KO + idx] = tot[i];
        }
}

// the splits' f64 totals added in split order, then the STE mask
__global__ void __launch_bounds__(REDUCE_THREADS)
binary_conv_wgrad_reduce_kernel_bf16(const double* __restrict__ part, const float* __restrict__ w,
                         float* __restrict__ dw, long long KO, int splits) {
    const long long e = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
    if (e >= KO) return;
    double s = part[e];
    for (int z = 1; z < splits; ++z) s = __dadd_rn(s, part[z * KO + e]);
    dw[e] = masked(s, w[e]);
}

template <bool STOCH, bool VEC>
int wgrad_bf16(const void* g, const void* x, const void* shift, const void* u, const void* w,
               const void* alpha, void* part, void* dw, const Geom& G, cudaStream_t st) {
    auto kernel = binary_conv_wgrad_kernel_bf16<STOCH, VEC>;
    constexpr int SMEM_BYTES = Raw<STOCH>::SMEM;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((G.KK * G.CP + BM - 1) / BM), (unsigned)((G.O + BN - 1) / BN),
                    (unsigned)G.splits);
    using B = __nv_bfloat16;
    kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
        static_cast<const B*>(g), static_cast<const B*>(x), static_cast<const B*>(shift),
        static_cast<const B*>(u), static_cast<const B*>(alpha), static_cast<const float*>(w),
        static_cast<double*>(part), static_cast<float*>(dw), G);
    err = cudaGetLastError();
    if (err != cudaSuccess || G.splits == 1) return (int)err;
    const long long KO = (long long)G.KK * G.C * G.O;
    binary_conv_wgrad_reduce_kernel_bf16<<<(unsigned)((KO + REDUCE_THREADS - 1) / REDUCE_THREADS),
                               REDUCE_THREADS, 0, st>>>(static_cast<const double*>(part),
                                                        static_cast<const float*>(w),
                                                        static_cast<float*>(dw), KO, G.splits);
    return (int)cudaGetLastError();
}

}  // namespace

// g, x, shift (or NULL), u (or NULL), alpha bf16; w, dw f32; partial
// (splits, kh*kw*C, O) f64 scratch when splits > 1 (else unused)
BDBNN_EXPORT int bdbnn_binary_conv_wgrad_bf16(const void* g, const void* x, const void* shift,
                                              const void* u, const void* w, const void* alpha,
                                              void* partial, void* dw, int N, int H, int W,
                                              int C, int O, int kh, int kw, int stride, int pad,
                                              int Ho, int Wo, int CP, int splits,
                                              int rows_per_split, void* stream) {
    const Geom G{H, W, C, O, kh * kw, kw, stride, pad, Ho, Wo, CP, N * Ho * Wo, rows_per_split,
                 splits};
    const bool vec = C % 8 == 0 && O % 8 == 0 && aligned16(g) && aligned16(x) &&
                     aligned16(shift) && aligned16(u) && aligned16(alpha);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (u != nullptr)
        return (vec ? wgrad_bf16<true, true> : wgrad_bf16<true, false>)(g, x, shift, u, w, alpha,
                                                                        partial, dw, G, st);
    return (vec ? wgrad_bf16<false, true> : wgrad_bf16<false, false>)(g, x, shift, u, w, alpha,
                                                                      partial, dw, G, st);
}
