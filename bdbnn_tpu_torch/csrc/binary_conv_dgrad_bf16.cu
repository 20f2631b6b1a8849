// K5 bf16 — binary (±1) convolution backward, input gradient, in the bf16
// mode (a bf16 model), with the activation sign estimator's backward
// fused into its epilogue, on Hopper's warpgroup MMA.
//
// Replaces, for bf16 operands, the dx half of
// bdbnn_tpu/nn/kernels/binary_conv.py:107-110 (jax.vjp of _forward:
// conv_transpose(g * alpha, sign W)) and the estimator backward rules of
// bdbnn_tpu/nn/binarize.py:106-325 in their bf16 ops:
//
//   dx[n, h, w, c] = bf16(bf16(S) * slope(v)), v = bf16(x[n, h, w, c] - shift[c])
//   S = sum over the taps (i, j) with h = ho*s - p + i, w = wo*s - p + j
//       on the stride grid, and o, of ga[n, ho, wo, o] * wsign[o, i, j, c]
//   ga = bf16(g * alpha[o]) (the reference's bf16 multiply)
//
// and the slope in the reference's bf16 ops (est_dx_bf16: each op rounded
// to bf16, EDE's t, k and prox's delta too).
//
// Layouts: g bf16 NHWC (N, Ho, Wo, O); x bf16 NHWC (N, H, W, C); shift
// bf16 (C,) or NULL; wsign int8 (O, kh, kw, C) as K2 writes it; alpha
// bf16 (O,); dx bf16 NHWC (N, H, W, C); taps int32, the parity-class
// table of nn/kernels/binary_conv.py:dgrad_tap_table. Scratch the wrapper
// allocates: wb bf16 (kh*kw, OP, CP), the weight sign as bf16 ±1 (zero
// beyond O and C), OP = O rounded up to the 32-deep stage, CP = C
// rounded up to 8 — 4.7 MB at the flagship's widest conv. No copy of
// g * alpha goes through device memory.
//
// Bound on the H100: an implicit GEMM of M = N*H*W dx rows, C columns
// and K = (taps on the stride grid) * O, 2*MACs on the bf16 tensor cores
// beside the bytes of g, x and dx. But every product is exact (±1 times a
// bf16 value) and the sum must stay within 4u*sum|terms| (u = 2^-24) of
// the exact one, so the tensor cores' f32 sums are folded into a more
// exact total every 32 products (1.36e10 folds a -b 256 step): that fold,
// and the latency of the short wgmma chains it forces, bound this kernel
// on the card, not its bf16 operations.
//
// The design (the f32 mode, binary_conv_dgrad.cu, writes the split of g *
// alpha in a prep pass and feeds mma.sync from it):
// - persistent blocks, one an SM, walk the tiles in a fixed order: a
//   tile is 128 dx rows of one stride-parity class (h mod s, w mod s) x 64
//   channels, and only the taps of that class reach g (1, 2, 2, 4 of 9 at
//   3x3 s2 p1), each at a fixed offset (di, dj) from (h/s, w/s). The
//   channel tiles of one row tile are neighbours in the order, so their
//   reads of g meet in L2;
// - a block is warp-specialized: one producer warpgroup fills a ring of
//   stages behind full/empty mbarriers, a stage being 32 o values of
//   every tap of the class. It copies by cp.async the halo of g rows the
//   tile's 128 dx rows reach at any tap (whole rows of Wo pixels between
//   the first row's lowest tap row and the last row's highest: a
//   contiguous range, nn/kernels/binary_conv.py dgrad_halo_span) and each
//   tap's 32 x 64 slice of wb, as wgmma's MN-major core matrices; it
//   issues the next stage's copies before it turns this stage's halo into
//   bf16(g * alpha) in place. A g value is read from L2 once per channel
//   tile and stage, whatever the number of taps that reach it (9 at 3x3
//   s1);
// - four consumer warpgroups, each 64 rows x 32 channels of the tile,
//   hand ldmatrix, for every tap, the halo row of their lane's dx row at
//   that tap (a zero row where the tap falls off g), which gives the
//   wgmma A fragment in registers, and run wgmma.mma_async m64n32k16 bf16
//   on their half of the tap's wb slice into f32 accumulators;
// - fold: every chain of L = 2 k steps (one tap's 32 o values) starts
//   from scale-d = 0, is waited for, and its sums are added to f64 totals
//   (the conversion is exact). A chain waits many times as long as its
//   tensor work takes, and a warpgroup cannot fold one chain while another of
//   its own runs: ptxas serializes every wgmma once an instruction reads
//   the accumulators of any chain between a wgmma and its wait (C7514),
//   and injects waits where two chains are issued under one branch
//   (C7519). So the latency is hidden across warpgroups, four of them
//   taking turns, and each folds 16 sums a chain (two warpgroups of 64
//   x 64, each folding 32, were slower on the H100). setmaxnreg gives the
//   consumers the registers the producers leave;
// - the epilogue rounds each total to bf16 once, applies the slope of
//   bf16(x - shift) (x read at the tile's start, so its latency hides
//   behind the main loop) and writes dx; one writer an output and a fixed
//   order of taps and o: two runs give the same bits.
//
// Why L = 2 (the error bound the gate holds). chip_smoke.py's gate holds
// S to 4u*sum|terms| beside one bf16 rounding of the exact sum. Model of
// the tensor cores: products are exact, and each wgmma k step forms c +
// (its 16 products) with at most one truncation of the result, an error
// below ulp(c') <= 2u|c'| for the running value c' (truncation, not
// rounding to nearest: the f32 modes' same-sign probes drift in one
// direction on the H100). A chain of L steps from zero errs by less than
// 2u * sum_{j<=L} |c'_j| <= 2u * L * sum|chain's terms|. The f64 totals
// add at most 2^-53 * sum|chain results| an addition: under 144 *
// 2^-53 * sum|terms| for the 144 chains of a layer4 output, 2e-6
// u*sum|terms|; the total is rounded to bf16 once (2^-9 |S|), inside the
// gate's one-bf16-rounding allowance 2^-8 |S|. So to first order in u the
// chains get the whole 4u*sum|terms|: 2u * L <= 4u, L = 2 — one tap's
// 32-deep stage slice a chain. (Half the sums in f32 pairs by TwoSum on
// the FP32 pipe, 7 adds a fold, would keep this bound, but were slower on
// the H100 than f64 alone; so were the two k steps of a chain in two
// accumulator sets, added in f32, which spill at this register budget.)
#include "hopper.cuh"

namespace {

constexpr int BM = 128;                 // dx rows a tile
constexpr int BN = 64;                  // input channels a tile
constexpr int WN = 32;                  // channels a consumer warpgroup: 64 rows x 32
constexpr int BK = 32;                  // o values a stage: one chain of two k steps a tap
constexpr int CONSUMERS = 512;          // four warpgroups: wgmma and the fold
constexpr int PRODUCERS = 128;          // one warpgroup: copies and bf16(g * alpha)
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int ENTRY_REGS = 96;          // a thread's registers at launch (64K / 640, in 8s)
// registers a thread once the producers hand theirs over
constexpr int PRODUCER_REGS = 64;
constexpr int CONSUMER_REGS = 104;
constexpr int HP = BK * 2 + 16;         // bytes a halo row: the 16 extra put the 8 rows an
                                        // ldmatrix reads on 8 distinct bank groups
constexpr int B_SBO = 128;              // bytes between 8-channel groups of a tap's slice
constexpr int B_LBO = (BN / 8) * B_SBO; // bytes between 8-o groups
constexpr int B_TAP = (BK / 8) * B_LBO; // bytes of one tap's 32 x 64 slice
constexpr int HEAD = 2048;              // the ring's mbarriers and the tap table, then the stages
constexpr int TAB0 = 128;               // the tap table's offset in the head
constexpr int TAB_INTS = (HEAD - TAB0) / 4;
constexpr int MAX_STAGES = 3;
constexpr int WSIGN_THREADS = 256;
static_assert(PRODUCERS % (BK / 8) == 0 && PRODUCERS == 2 * (BK * BN / 8) / 4,
              "a producer's halo chunks share one o group; two B chunks a tap");
static_assert(BK == 32, "one chain of two k steps a tap a stage");
static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= THREADS * ENTRY_REGS &&
                  THREADS * ENTRY_REGS <= 65536,
              "registers");

struct Geom {
    int N, H, W, C, O, Ho, Wo, stride, OP, CP;
    int nchunk, ctiles, mtiles, tiles;      // o stages a tile; tiles of (class, rows, channels)
    int halo_px, b_bytes, stage_bytes, nstage, tab_ints;
    int est;
    float p0, p1;
};

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

// One tile of the walk: its parity class (a, b), the class's grid (Hc x
// Wc, Mc rows), first row m0, channel offset c0, its taps in the table,
// and the halo: g pixels p_lo .. p_lo + npx - 1 (every index below 2^31:
// the wrapper checks N*H*W and N*Ho*Wo)
struct Tile {
    int a, b, Hc, Wc, c0, tap0, ntap, Mc, m0, p_lo, npx;
};

// Tile `tile` of the walk (channel tiles innermost, then the row tiles,
// then the classes, so that each block's share of every class — 1, 2, 2
// and 4 taps at 3x3 s2 — is about the same): false when its rows lie past
// its class's grid. tab is the tap table in shared memory. Producers and
// consumers decode the same tiles in the same order.
__device__ __forceinline__ bool decode(const Geom& G, const int* tab, int tile, Tile& T) {
    const int ss = G.stride * G.stride;
    const int per = G.ctiles * G.mtiles;
    const int z = tile / per;
    const int r = tile - z * per;
    const int mt = r / G.ctiles;
    const int ct = r - mt * G.ctiles;
    T.a = z / G.stride;
    T.b = z - T.a * G.stride;
    T.Hc = G.H > T.a ? (G.H - T.a + G.stride - 1) / G.stride : 0;
    T.Wc = G.W > T.b ? (G.W - T.b + G.stride - 1) / G.stride : 0;
    const int HWc = T.Hc * T.Wc;
    T.Mc = G.N * HWc;
    T.m0 = mt * BM;
    if (T.m0 >= T.Mc) return false;
    T.c0 = ct * BN;
    T.tap0 = tab[z];
    T.ntap = tab[z + 1] - T.tap0;
    // the halo: global g rows n*Ho + ho from the first row's lowest tap
    // row to the last row's highest, each clipped to its image
    // (dgrad_halo_span)
    int dmin = 0, dmax = 0;
    const int* tv = tab + ss + 1 + 3 * T.tap0;
    for (int t = 0; t < T.ntap; ++t) {
        const int di = tv[3 * t + 1];
        dmin = t == 0 ? di : min(dmin, di);
        dmax = t == 0 ? di : max(dmax, di);
    }
    const int last = min(T.m0 + BM, T.Mc) - 1;
    const int na = T.m0 / HWc, nb = last / HWc;
    const int ha = (T.m0 - na * HWc) / T.Wc, hb = (last - nb * HWc) / T.Wc;
    const int lo = na * G.Ho + min(G.Ho - 1, max(0, ha + dmin));
    const int hi = nb * G.Ho + min(G.Ho - 1, max(0, hb + dmax));
    T.p_lo = lo * G.Wo;
    T.npx = (hi - lo + 1) * G.Wo;
    return true;
}

// The next stage of the producers' walk after (tile, T, oc): the next o
// chunk, or the first of the next tile with taps; false past the end
__device__ __forceinline__ bool next_stage(const Geom& G, const int* tab, int& tile, Tile& T,
                                           int& oc) {
    if (++oc < G.nchunk) return true;
    oc = 0;
    for (tile += gridDim.x; tile < G.tiles; tile += gridDim.x)
        if (decode(G, tab, tile, T) && T.ntap > 0) return true;
    return false;
}

// Two bf16 values of x at p (one where only one lies before C) as a word
template <bool VEC>
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, int n) {
    if (VEC) return *reinterpret_cast<const uint32_t*>(p);
    uint32_t v = __bfloat16_as_ushort(p[0]);
    if (n > 1) v |= (uint32_t)__bfloat16_as_ushort(p[1]) << 16;
    return v;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
binary_conv_dgrad_kernel_bf16(const __nv_bfloat16* __restrict__ g,
                              const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ shift,
                              const __nv_bfloat16* __restrict__ alpha,
                              const __nv_bfloat16* __restrict__ wb, const int* __restrict__ taps,
                              __nv_bfloat16* __restrict__ dx, Geom G) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
    const uint32_t full0 = smem_u32(smem);           // stage s: + 8s
    const uint32_t empty0 = full0 + 8 * MAX_STAGES;
    int* tab = reinterpret_cast<int*>(smem + TAB0);  // the tap table (dgrad_tap_table)
    const int* tapv = tab + G.stride * G.stride + 1; // (i*kw + j, di, dj) a tap
    unsigned char* stages = smem + HEAD;             // stage slot: B (taps x B_TAP), then the halo
    const uint32_t stages_u = smem_u32(stages);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    for (int i = tid; i < G.tab_ints; i += THREADS) tab[i] = __ldg(taps + i);
    if (tid == 0) {
        for (int st = 0; st < G.nstage; ++st) {
            mbar_init(full0 + 8 * st, PRODUCERS);
            mbar_init(empty0 + 8 * st, CONSUMERS);
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        // producer: one thread of the warpgroup. Its halo chunks are (pixel
        // tp/4 + 32j, o group tp % 4), so its alpha group is fixed. B chunk
        // q = tp + 128j is (tap j/2, o (q/64 % 4)*8 + q % 8, channel group
        // q/8 % 8): 8 neighbouring lanes store one 128-byte core matrix row.
        // A stage's copies are issued before the last stage is turned into
        // bf16(g * alpha), so one stage's loads are in flight while the
        // thread works on the other's
        regs_release<PRODUCER_REGS>();
        const int tp = tid - CONSUMERS;
        const int og = tp & 3;
        const int oi0 = (tp & 7) | (((tp >> 6) & 1) << 3);
        const int b_dst0 = (oi0 >> 3) * B_LBO + ((tp >> 3) & 7) * B_SBO + (oi0 & 7) * 16;
        auto issue = [&](const Tile& T, int oc, int S) {
            const int slot = S % G.nstage;
            mbar_wait(empty0 + 8 * slot, ((S / G.nstage) & 1) ^ 1);
            unsigned char* st = stages + slot * G.stage_bytes;
            unsigned char* hs = st + G.b_bytes;
            const int o0 = oc * BK;
            const int c = T.c0 + ((tp >> 3) & 7) * 8;
            const bool okc = c < G.CP;
            for (int ts = 0; ts < T.ntap; ++ts) {
                const long long row = (long long)tapv[3 * (T.tap0 + ts)] * G.OP + o0 + oi0;
#pragma unroll
                for (int h = 0; h < 2; ++h)  // o and o + 16
                    cp_async16(smem_u32(st + ts * B_TAP + b_dst0 + h * 2 * B_LBO),
                               okc ? wb + (row + 16 * h) * G.CP + c : wb, okc);
            }
            const int o = o0 + og * 8;
            const int no = G.O - o;
            const uint4 av = no > 0 && !VEC ? load8(alpha + o, no, false) : make_uint4(0, 0, 0, 0);
            for (int px = tp >> 2; px < T.npx; px += PRODUCERS / 4) {
                unsigned char* dst = hs + px * HP + og * 16;
                const __nv_bfloat16* src = g + (long long)(T.p_lo + px) * G.O + o;
                if (VEC) {
                    cp_async16(smem_u32(dst), no > 0 ? src : g, no > 0);
                } else {  // loaded and turned into bf16(g * alpha) here
                    const uint4 gv = no > 0 ? load8(src, no, false) : make_uint4(0, 0, 0, 0);
                    uint4 out;
#pragma unroll
                    for (int i = 0; i < 4; ++i) set_word(out, i, ga_bf16x2(word(gv, i), word(av, i)));
                    *reinterpret_cast<uint4*>(dst) = out;
                }
            }
            if (tp < BK / 8)  // the zero row every tap off g reads
                *reinterpret_cast<uint4*>(hs + T.npx * HP + tp * 16) = make_uint4(0, 0, 0, 0);
            cp_async_commit();
        };
        // bf16(g * alpha) in place on the chunks this thread copied; then
        // the stage is full
        auto finish = [&](const Tile& T, int oc, int S) {
            const int slot = S % G.nstage;
            if (VEC) {
                const int o = oc * BK + og * 8;
                if (o < G.O) {
                    const uint4 av = load8(alpha + o, G.O - o, true);
                    unsigned char* hs = stages + slot * G.stage_bytes + G.b_bytes;
                    for (int px = tp >> 2; px < T.npx; px += PRODUCERS / 4) {
                        uint4* p = reinterpret_cast<uint4*>(hs + px * HP + og * 16);
                        const uint4 gv = *p;
                        uint4 out;
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            set_word(out, i, ga_bf16x2(word(gv, i), word(av, i)));
                        *p = out;
                    }
                }
            }
            fence_proxy_async();  // wgmma reads the B slices through the async proxy
            mbar_arrive(full0 + 8 * slot);
        };
        int tile = blockIdx.x, oc = -1;
        Tile T;
        bool have = false;
        for (; tile < G.tiles && !have; tile += gridDim.x) have = decode(G, tab, tile, T) && T.ntap > 0;
        if (!have) return;
        tile -= gridDim.x;
        oc = 0;
        if (T.npx > G.halo_px) __trap();  // the wrapper sized the halo too small
        issue(T, oc, 0);
        for (int S = 0;; ++S) {
            int tile2 = tile, oc2 = oc;
            Tile T2 = T;
            const bool more = next_stage(G, tab, tile2, T2, oc2);
            if (more) {
                if (T2.npx > G.halo_px) __trap();
                issue(T2, oc2, S + 1);
                cp_async_wait<1>();  // this thread's copies of stage S landed
            } else {
                cp_async_wait<0>();
            }
            finish(T, oc, S);
            if (!more) return;
            tile = tile2;
            oc = oc2;
            T = T2;
        }
    }

    // consumers: warpgroup wg owns rows (wg/2)*64 .. +63 and channels
    // (wg%2)*32 .. +31 of the tile, its warp wq rows wq*16 .. +15 of
    // those. Four warpgroups, each waiting for one chain at a time, keep
    // the tensor cores and the fold's pipes busy between them
    regs_claim<CONSUMER_REGS>();
    const int wg = warp >> 2;
    const int wq = warp & 3;
    const int rb = (wg >> 1) * 64 + wq * 16;  // the warp's first row in the tile
    const int cb = (wg & 1) * WN;             // the warpgroup's first channel in the tile
    float acc[16] = {};
    uint32_t af[2][4] = {};
    double tot[16];
    int S = 0;  // stages consumed, over the tiles
    for (int tile = blockIdx.x; tile < G.tiles; tile += gridDim.x) {
        Tile T;
        if (!decode(G, tab, tile, T)) continue;
        const int HWc = T.Hc * T.Wc;
        // this lane's A row (ldmatrix hands row lane % 16 of the warp's 16)
        int ah = -(1 << 24), aw = 0;  // a row past the end: every tap falls off g
        int apb = 0;
        {
            const int m = T.m0 + rb + (lane & 15);
            if (m < T.Mc) {
                const int n = m / HWc;
                const int rem = m - n * HWc;
                ah = rem / T.Wc;
                aw = rem - ah * T.Wc;
                apb = (n * G.Ho + ah) * G.Wo + aw - T.p_lo;
            }
        }
        // this thread's two epilogue rows (lane/4 and lane/4 + 8 of the
        // warp's 16): their dx offsets, and their x, read now
        long long off[2];
        uint32_t xw[2][4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int m = T.m0 + rb + (lane >> 2) + 8 * hr;
            off[hr] = -1;
            if (m < T.Mc) {
                const int n = m / HWc;
                const int rem = m - n * HWc;
                const int hh = rem / T.Wc;
                const int ww = rem - hh * T.Wc;
                off[hr] = ((long long)(n * G.H + T.a + G.stride * hh) * G.W + T.b +
                           G.stride * ww) * G.C;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = T.c0 + cb + 8 * j + 2 * (lane & 3);
                xw[hr][j] = off[hr] >= 0 && c < G.C ? load_pair<VEC>(x + off[hr] + c, G.C - c) : 0u;
            }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) tot[i] = 0.0;

        for (int oc = 0; T.ntap > 0 && oc < G.nchunk; ++oc, ++S) {
            const int slot = S % G.nstage;
            mbar_wait(full0 + 8 * slot, (S / G.nstage) & 1);
            const uint32_t st = stages_u + slot * G.stage_bytes;
            const uint32_t hs = st + G.b_bytes;
            for (int t = 0; t < T.ntap; ++t) {
                // chain (oc, t): tap t's 32 o values, from zero
                const int di = tapv[3 * (T.tap0 + t) + 1];
                const int dj = tapv[3 * (T.tap0 + t) + 2];
                const bool ok = (unsigned)(ah + di) < (unsigned)G.Ho &&
                                (unsigned)(aw + dj) < (unsigned)G.Wo;
                const int row = ok ? apb + di * G.Wo + dj : T.npx;
                // matrix q of the x4 is rows + (q & 1) * 8, o + (q >> 1) * 8
                const uint32_t addr = hs + row * HP + (lane >> 4) * 16;
                __syncwarp();
                ldsm_x4(addr, af[0][0], af[0][1], af[0][2], af[0][3]);
                ldsm_x4(addr + 32, af[1][0], af[1][1], af[1][2], af[1][3]);
                wgmma_fence();
                const uint32_t bt = st + t * B_TAP + (cb / 8) * B_SBO;
                wgmma_bf16_m64n32k16(acc, af[0], smem_desc(bt, B_LBO, B_SBO), 0);
                wgmma_bf16_m64n32k16(acc, af[1], smem_desc(bt + 2 * B_LBO, B_LBO, B_SBO), 1);
                wgmma_commit();
                wgmma_wait<0>();
                fence_acc(acc);
                fence_frag(af[0]);
                fence_frag(af[1]);
                if (t == T.ntap - 1) mbar_arrive(empty0 + 8 * slot);  // the stage is read
                fold_f64(tot, acc);
            }
        }

        // epilogue: the sums of element 4j + e are row lane/4 + 8(e >> 1),
        // channel 8j + 2(lane % 4) + (e & 1) of this warp's 16 x 32
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            if (off[hr] < 0) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = T.c0 + cb + 8 * j + 2 * (lane & 3);
                if (c >= G.C) continue;
                const uint32_t sw = shift != nullptr ? load_pair<VEC>(shift + c, G.C - c) : 0u;
                float d[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float xv = e ? hi_f(xw[hr][j]) : lo_f(xw[hr][j]);
                    const float sv = e ? hi_f(sw) : lo_f(sw);
                    const float v = shift != nullptr ? __fsub_rn(xv, sv) : xv;
                    // the total rounded to bf16 once
                    const float sum = __bfloat162float(__double2bfloat16(tot[4 * j + 2 * hr + e]));
                    d[e] = est_dx_bf16(sum, round_to_bf16(v), G.est, G.p0, G.p1);
                }
                __nv_bfloat16* p = dx + off[hr] + c;
                if (VEC) {
                    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(d[0], d[1]);
                } else {
                    p[0] = __float2bfloat16_rn(d[0]);
                    if (c + 1 < G.C) p[1] = __float2bfloat16_rn(d[1]);
                }
            }
        }
    }
}

// wb (kh*kw, OP, CP) bf16 ±1 from the int8 sign (O, kh, kw, C), zero
// beyond O and C: 8 channels an item
__global__ void __launch_bounds__(WSIGN_THREADS)
dgrad_wsign_bf16_kernel(const int8_t* __restrict__ wsign, __nv_bfloat16* __restrict__ wb, int O,
                        int OP, int KK, int C, int CP) {
    const long long items = (long long)KK * OP * (CP / 8);
    for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x; it < items;
         it += (long long)gridDim.x * blockDim.x) {
        const long long to = it / (CP / 8);  // tap * OP + o
        const int c0 = (int)(it - to * (CP / 8)) * 8;
        const int t = (int)(to / OP);
        const int o = (int)(to - (long long)t * OP);
        uint32_t p[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
            uint32_t b[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int c = c0 + e + u;
                const float v = o < O && c < C ? (float)wsign[((long long)o * KK + t) * C + c] : 0.f;
                b[u] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
            }
            p[e / 2] = b[0] | (b[1] << 16);
        }
        *reinterpret_cast<uint4*>(wb + to * CP + c0) = make_uint4(p[0], p[1], p[2], p[3]);
    }
}

int stage_bytes(int halo_px, int maxtaps) {
    const int b = maxtaps * B_TAP + (halo_px + 1) * HP;
    return (b + 1023) / 1024 * 1024;
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            n = 132;
    }
    return n;
}

}  // namespace

// Dynamic shared memory of one block for a halo of halo_px g pixels, the
// most taps of a class and nstage stages (the wrapper checks it against
// the card's 227 KB before it launches)
BDBNN_EXPORT int bdbnn_binary_conv_dgrad_bf16_smem(int halo_px, int maxtaps, int nstage) {
    return 1024 + HEAD + nstage * stage_bytes(halo_px, maxtaps);
}

// g, x, shift (or NULL), alpha, dx bf16; wsign int8 (O, kh, kw, C); taps
// the parity-class table; wb (kh*kw, OP, CP) bf16 scratch; halo_px,
// maxtaps and nstage as nn/kernels/binary_conv.py dgrad_bf16_schedule
// gives them; est, p0, p1 the estimator (ESTIMATORS)
BDBNN_EXPORT int bdbnn_binary_conv_dgrad_bf16(const void* g, const void* x, const void* shift,
                                              const void* wsign, const void* alpha,
                                              const void* taps, void* wb, void* dx, int N, int H,
                                              int W, int C, int O, int kh, int kw, int stride,
                                              int Ho, int Wo, int OP, int CP, int halo_px,
                                              int maxtaps, int nstage, int est, float p0, float p1,
                                              void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int KK = kh * kw;
    const int tab_ints = stride * stride + 1 + 3 * KK;
    if (nstage < 2 || nstage > MAX_STAGES || tab_ints > TAB_INTS) return (int)cudaErrorInvalidValue;
    const long long items = (long long)KK * OP * (CP / 8);
    const long long wblocks = (items + WSIGN_THREADS - 1) / WSIGN_THREADS;
    dgrad_wsign_bf16_kernel<<<(unsigned)(wblocks < 132 * 8 ? wblocks : 132 * 8), WSIGN_THREADS, 0,
                              st>>>(static_cast<const int8_t*>(wsign),
                                    static_cast<__nv_bfloat16*>(wb), O, OP, KK, C, CP);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    Geom G;
    G.N = N;
    G.H = H;
    G.W = W;
    G.C = C;
    G.O = O;
    G.Ho = Ho;
    G.Wo = Wo;
    G.stride = stride;
    G.OP = OP;
    G.CP = CP;
    G.nchunk = OP / BK;
    G.ctiles = (C + BN - 1) / BN;
    const long long mmax = (long long)N * ((H + stride - 1) / stride) * ((W + stride - 1) / stride);
    G.mtiles = (int)((mmax + BM - 1) / BM);
    G.tiles = G.ctiles * stride * stride * G.mtiles;
    G.halo_px = halo_px;
    G.b_bytes = maxtaps * B_TAP;
    G.stage_bytes = stage_bytes(halo_px, maxtaps);
    G.nstage = nstage;
    G.tab_ints = tab_ints;
    G.est = est;
    G.p0 = p0;
    G.p1 = p1;
    const int smem = bdbnn_binary_conv_dgrad_bf16_smem(halo_px, maxtaps, nstage);
    const bool vec = C % 8 == 0 && O % 8 == 0 && aligned16(g) && aligned16(x) &&
                     aligned16(shift) && aligned16(alpha) && aligned16(dx);
    auto kernel = vec ? binary_conv_dgrad_kernel_bf16<true> : binary_conv_dgrad_kernel_bf16<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = G.tiles < sm_count() ? G.tiles : sm_count();
    using B = __nv_bfloat16;
    kernel<<<blocks, THREADS, smem, st>>>(static_cast<const B*>(g), static_cast<const B*>(x),
                                          static_cast<const B*>(shift),
                                          static_cast<const B*>(alpha),
                                          static_cast<const B*>(wb), static_cast<const int*>(taps),
                                          static_cast<B*>(dx), G);
    return (int)cudaGetLastError();
}
