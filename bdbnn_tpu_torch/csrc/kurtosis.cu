// K7 — grouped kurtosis regularizer, forward and gradient, over every
// hooked latent weight in one grid per pass.
//
// Replaces bdbnn_tpu/losses/kurtosis.py:51-113 (kurtosis, kurtosis_loss,
// kurtosis_regularization) and its jax.grad. For each tensor t of n
// elements, with d = w - mu (mu the f32-rounded mean):
//
//   S1..S4 = sum d, d^2, d^3, d^4        kurt = (S4/n) / (S2/(n-1))^2
//   loss_t = (kurt - target_t)^2         out = avg | sum | max over t
//   dkurt/dw_i = c*(4 d_i^3/S2^2 - 4 S4 d_i/S2^3) - mean_j(same),
//                c = (n-1)^2/n, mean_j(same) = c*(4 S3/S2^2 - 4 S4 S1/S2^3)/n
//   grad_i = weight_t * 2 (kurt - target_t) * dkurt/dw_i
//
// with weight_t = 1/T (avg), 1 (sum), or 1/ties on the largest loss
// (max, jnp.max's gradient). S1 is 0 in exact arithmetic; keeping it
// follows the reference's f32 autodiff through d = w - mean(w).
//
// The tensor table is a kernel parameter, passed by value
// (__grid_constant__): the weights' addresses and sizes, the offsets of
// their gradients in the output buffer, the first block of each tensor
// (block b belongs to the t with bstart_t <= b < bstart_{t+1}; `chunk`
// elements a block), the targets and whether a tensor takes 16-byte
// loads and stores. The wrapper builds it once per set of tensors on the
// host and the launch carries it, so a call copies nothing host to
// device, and a CUDA graph that captures the call keeps it in its nodes.
// Output buffer `out` f32: kurt (T) | loss | gradients at goff_t; scratch
// `partial` f64 (5, blocks): per block sum w, S1, S2, S3, S4.
//
// Bound on the H100: bytes. The centered two-pass form (the raw-moment
// form Sum w^k cancels catastrophically once |mu|/sigma is large,
// kurtosis.py:64-69) reads the weights once for the mean and once for
// the centered moments, and the gradient pass reads them a third time
// and writes the gradient: 4 x 44.6 MB for the flagship's 19 tensors,
// ~53 us at 3.35 TB/s, against ~27 us for one read and one write.
//
// The design, in three launches of one entry:
// 1. mean: each block sums its chunk in f64 (float4 loads, warp shuffles,
//    then the block's warps in order) into partial[0][b];
// 2. moments: each block recomputes its tensor's mean from the partials
//    (one warp, a fixed order) and writes S1..S4 of its chunk. The grid
//    walks the blocks in reverse, so its first blocks read what pass 1
//    read last, which the 50 MB L2 still holds;
// 3. gradient + finalize: each block recomputes its tensor's moments
//    from the partials (one warp, the same fixed order, so every block of
//    a tensor gets the same bits), forms the gradient's coefficients and
//    writes its chunk's gradient (float4), walking forward, so it starts
//    on what pass 2 read last. Block 0 also writes kurt and the loss; in
//    max mode every block finds the largest loss and its ties. Without
//    the gradient this pass runs as one block that only finalizes.
// Every sum is f64 in an order fixed by the shapes, so two runs give the
// same bits, and no block depends on another's completion within a pass.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_T = 128;

// nn/kernels/kurtosis.py's _Table mirrors this struct field for field
struct Table {
    const float* ptr[MAX_T];
    long long goff[MAX_T];  // gradient offsets in out (f32 elements)
    int n[MAX_T];
    int bstart[MAX_T + 1];
    float target[MAX_T];
    int T;
    int chunk;
    unsigned char vec[MAX_T];  // 16-byte aligned weight and gradient
};
// the whole kernel parameter list must stay within the classic 4 KB
static_assert(sizeof(Table) + 64 <= 4096, "K7's table outgrows a kernel parameter list");

__device__ __forceinline__ int tensor_of(const Table& tb, int b) {
    int lo = 0, hi = tb.T - 1;  // the last t with bstart[t] <= b
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (tb.bstart[mid] <= b) lo = mid;
        else hi = mid - 1;
    }
    return lo;
}

__device__ __forceinline__ double warp_sum(double v) {
    // butterfly: every lane ends with the same bits
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// fixed-order block sums of NQ doubles a thread; valid in warp 0
template <int NQ>
__device__ __forceinline__ void block_sums(double (&v)[NQ]) {
    __shared__ double sh[NQ][WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < NQ; ++q) v[q] = warp_sum(v[q]);
    if (lane == 0) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) sh[q][warp] = v[q];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) v[q] = warp_sum(lane < WARPS ? sh[q][lane] : 0.0);
    }
}

// fixed-order warp sum of partial q over tensor t's blocks (SoA layout)
__device__ __forceinline__ double partial_sum(const double* partial, const Table& tb, int t,
                                              int q) {
    const int lane = threadIdx.x & 31;
    const long long total = tb.bstart[tb.T];
    double s = 0.0;
    for (int b = tb.bstart[t] + lane; b < tb.bstart[t + 1]; b += 32) s += partial[q * total + b];
    return warp_sum(s);
}

// a block's element range [beg, end) of tensor t, and how many float4s
// of it take 16-byte accesses
struct Range {
    long long beg, end, nv;
};

__device__ __forceinline__ Range range_of(const Table& tb, int t, int b) {
    const long long beg = (long long)(b - tb.bstart[t]) * tb.chunk;
    const long long end = min((long long)tb.n[t], beg + tb.chunk);
    return {beg, end, tb.vec[t] ? (end - beg) / 4 : 0};
}

__global__ void __launch_bounds__(THREADS)
kurt_mean_kernel(const __grid_constant__ Table tb, double* __restrict__ partial) {
    const int b = blockIdx.x;
    const int t = tensor_of(tb, b);
    const float* w = tb.ptr[t];
    const Range r = range_of(tb, t, b);
    double s[1] = {0.0};
#pragma unroll 4
    for (long long q = threadIdx.x; q < r.nv; q += THREADS) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(w + r.beg) + q);
        s[0] += (double)v.x;
        s[0] += (double)v.y;
        s[0] += (double)v.z;
        s[0] += (double)v.w;
    }
    for (long long i = r.beg + 4 * r.nv + threadIdx.x; i < r.end; i += THREADS)
        s[0] += (double)__ldg(w + i);
    block_sums(s);
    if (threadIdx.x == 0) partial[b] = s[0];
}

__device__ __forceinline__ void add_moments(double (&s)[4], float x, float mu) {
    const double d = (double)__fsub_rn(x, mu);
    const double d2 = d * d;
    s[0] += d;
    s[1] += d2;
    s[2] += d2 * d;
    s[3] += d2 * d2;
}

__global__ void __launch_bounds__(THREADS)
kurt_moments_kernel(const __grid_constant__ Table tb, double* __restrict__ partial) {
    __shared__ float mu_sh;
    const int total = tb.bstart[tb.T];
    const int b = total - 1 - (int)blockIdx.x;  // reverse sweep: L2 hits first
    const int t = tensor_of(tb, b);
    if (threadIdx.x < 32) {
        const double tot = partial_sum(partial, tb, t, 0);
        if (threadIdx.x == 0) mu_sh = (float)(tot / (double)tb.n[t]);
    }
    __syncthreads();
    const float mu = mu_sh;
    const float* w = tb.ptr[t];
    const Range r = range_of(tb, t, b);
    double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
    for (long long q = threadIdx.x; q < r.nv; q += THREADS) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(w + r.beg) + q);
        add_moments(s, v.x, mu);
        add_moments(s, v.y, mu);
        add_moments(s, v.z, mu);
        add_moments(s, v.w, mu);
    }
    for (long long i = r.beg + 4 * r.nv + threadIdx.x; i < r.end; i += THREADS)
        add_moments(s, __ldg(w + i), mu);
    block_sums(s);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) partial[(q + 1) * (long long)total + b] = s[q];
    }
}

// a warp's S1..S4 and kurtosis of tensor t from the partials; every lane
// holds the same bits
__device__ __forceinline__ double tensor_kurt(const Table& tb, const double* partial, int t,
                                              double (&s)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] = partial_sum(partial, tb, t, q + 1);
    const double n = (double)tb.n[t];
    const double var = s[1] / (n - 1.0);
    return (s[3] / n) / (var * var);
}

__device__ __forceinline__ float grad_of(float x, float mu, double A, double B, double C) {
    const double d = (double)__fsub_rn(x, mu);
    return (float)(A * d * d * d + B * d + C);
}

__global__ void __launch_bounds__(THREADS)
kurt_grad_kernel(const __grid_constant__ Table tb, const double* __restrict__ partial, int mode,
                 float* __restrict__ out, int with_grad) {
    __shared__ double loss_sh[MAX_T];
    __shared__ double kurt_sh[MAX_T];
    __shared__ double S_sh[4];
    __shared__ double coef_sh[3];
    __shared__ float mu_sh;
    const int T = tb.T;
    const int b = blockIdx.x;
    const int t = tensor_of(tb, b);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // every tensor's loss where the reduction needs them (max), or where
    // this block writes them (block 0); else only this block's tensor
    const bool every = mode == 2 || b == 0;
    for (int u = every ? warp : 0; u < (every ? T : (warp == 0 ? 1 : 0)); u += WARPS) {
        const int v = every ? u : t;
        double s[4];
        const double kurt = tensor_kurt(tb, partial, v, s);
        if (lane == 0) {
            const double diff = kurt - (double)tb.target[v];
            kurt_sh[v] = kurt;
            loss_sh[v] = diff * diff;
        }
    }
    if (warp == WARPS - 1) {
        double s[4];
        tensor_kurt(tb, partial, t, s);
        const double tot = partial_sum(partial, tb, t, 0);
        if (lane == 0) {
            for (int q = 0; q < 4; ++q) S_sh[q] = s[q];
            mu_sh = (float)(tot / (double)tb.n[t]);
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        double red = 0.0, wt;
        if (mode == 2) {  // max: the gradient is shared by the tied maxima
            red = loss_sh[0];
            for (int v = 1; v < T; ++v) red = fmax(red, loss_sh[v]);
            int ties = 0;
            for (int v = 0; v < T; ++v) ties += loss_sh[v] == red;
            wt = loss_sh[t] == red ? 1.0 / ties : 0.0;
        } else {
            if (b == 0) {
                for (int v = 0; v < T; ++v) red += loss_sh[v];
                if (mode == 0) red /= (double)T;
            }
            wt = mode == 0 ? 1.0 / T : 1.0;
        }
        if (b == 0) {
            for (int v = 0; v < T; ++v) out[v] = (float)kurt_sh[v];
            out[T] = (float)red;
        }
        const double n = (double)tb.n[t];
        const double c = (n - 1.0) * (n - 1.0) / n;
        const double s2 = S_sh[1];
        const double scale = wt * 2.0 * (kurt_sh[t] - (double)tb.target[t]);
        const double A = scale * c * 4.0 / (s2 * s2);
        const double B = -scale * c * 4.0 * S_sh[3] / (s2 * s2 * s2);
        coef_sh[0] = A;
        coef_sh[1] = B;
        coef_sh[2] = -(A * S_sh[2] + B * S_sh[0]) / n;
    }
    __syncthreads();
    if (!with_grad) return;
    const double A = coef_sh[0], B = coef_sh[1], C = coef_sh[2];
    const float mu = mu_sh;
    const float* w = tb.ptr[t];
    float* g = out + tb.goff[t];
    const Range r = range_of(tb, t, b);
#pragma unroll 4
    for (long long q = threadIdx.x; q < r.nv; q += THREADS) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(w + r.beg) + q);
        reinterpret_cast<float4*>(g + r.beg)[q] =
            make_float4(grad_of(v.x, mu, A, B, C), grad_of(v.y, mu, A, B, C),
                        grad_of(v.z, mu, A, B, C), grad_of(v.w, mu, A, B, C));
    }
    for (long long i = r.beg + 4 * r.nv + threadIdx.x; i < r.end; i += THREADS)
        g[i] = grad_of(__ldg(w + i), mu, A, B, C);
}

}  // namespace

BDBNN_EXPORT int bdbnn_kurtosis_grouped(const void* table, int mode, int with_grad,
                                        void* partial, void* out, void* stream) {
    Table tb;
    memcpy(&tb, table, sizeof(Table));
    if (tb.T < 1 || tb.T > MAX_T || tb.chunk < 1 || tb.bstart[tb.T] < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = tb.bstart[tb.T];
    double* part = static_cast<double*>(partial);
    float* o = static_cast<float*>(out);
    kurt_mean_kernel<<<blocks, THREADS, 0, st>>>(tb, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kurt_moments_kernel<<<blocks, THREADS, 0, st>>>(tb, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    kurt_grad_kernel<<<with_grad ? blocks : 1, THREADS, 0, st>>>(tb, part, mode, o, with_grad);
    return (int)cudaGetLastError();
}
