// K7 — grouped kurtosis regularizer, forward and gradient, over every
// hooked latent weight in one launch per pass.
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
// Layout: `meta` int64 [ptr_0..ptr_{T-1} | n_0.. | goff_0.. | bstart_0..bstart_T]:
// the weights' device addresses, sizes, offsets into the flat f32
// gradient, and the first block of each tensor (block b belongs to the
// t with bstart_t <= b < bstart_{t+1}; `chunk` elements a block, as the
// wrapper laid the table out).
//
// Bound on the H100: bytes. The weights are read once for the mean,
// once for the centered moments (the centered two-pass form: the raw-
// moment form Sum w^k cancels catastrophically once |mu|/sigma is large,
// kurtosis.py:64-69) and once for the gradient, which is written once —
// four passes over 44.6 MB for the flagship's 19 tensors, ~53 us at
// 3.35 TB/s. Each pass is one grid over all tensors' blocks; sums are
// taken in f64 and in a fixed order (block trees, then the per-tensor
// partials by one warp), so two runs give the same bits and the result
// does not depend on the block count.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NPART = 5;  // per block: sum w, S1, S2, S3, S4
constexpr int NCOEF = 4;  // per tensor: A, B, C, mu (f32 value)
constexpr int MAX_T = 256;

struct Meta {
    const long long* m;
    int T;
    long long chunk;
    __device__ const float* ptr(int t) const {
        return reinterpret_cast<const float*>(m[t]);
    }
    __device__ long long n(int t) const { return m[T + t]; }
    __device__ long long goff(int t) const { return m[2 * T + t]; }
    __device__ int bstart(int t) const { return (int)m[3 * T + t]; }
    __device__ int tensor_of(int b) const {
        int t = 0;
        while (t + 1 < T && bstart(t + 1) <= b) ++t;
        return t;
    }
};

// fixed-order tree sum of one double per thread; valid in thread 0
__device__ double block_sum(double v, double* sh) {
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if ((int)threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
        __syncthreads();
    }
    const double r = sh[0];
    __syncthreads();
    return r;
}

// fixed-order warp sum of partial[b * NPART + q] over tensor t's blocks
__device__ double warp_partial_sum(const double* partial, const Meta& meta, int t, int q) {
    const int lane = threadIdx.x % 32;
    double s = 0.0;
    for (int b = meta.bstart(t) + lane; b < meta.bstart(t + 1); b += 32) s += partial[b * NPART + q];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    return s;
}

__global__ void __launch_bounds__(THREADS)
kurt_sum_kernel(Meta meta, double* __restrict__ partial) {
    __shared__ double sh[THREADS];
    const int b = blockIdx.x;
    const int t = meta.tensor_of(b);
    const float* w = meta.ptr(t);
    const long long beg = (long long)(b - meta.bstart(t)) * meta.chunk;
    const long long end = min(meta.n(t), beg + meta.chunk);
    double s = 0.0;
    for (long long i = beg + threadIdx.x; i < end; i += THREADS) s += (double)w[i];
    s = block_sum(s, sh);
    if (threadIdx.x == 0) partial[b * NPART] = s;
}

__global__ void __launch_bounds__(THREADS)
kurt_moments_kernel(Meta meta, double* __restrict__ partial, double* __restrict__ coef) {
    __shared__ double sh[THREADS];
    __shared__ float mu_sh;
    const int b = blockIdx.x;
    const int t = meta.tensor_of(b);
    if (threadIdx.x < 32) {
        const double tot = warp_partial_sum(partial, meta, t, 0);
        if (threadIdx.x == 0) {
            mu_sh = (float)(tot / (double)meta.n(t));
            if (b == meta.bstart(t)) coef[t * NCOEF + 3] = (double)mu_sh;
        }
    }
    __syncthreads();
    const float mu = mu_sh;
    const float* w = meta.ptr(t);
    const long long beg = (long long)(b - meta.bstart(t)) * meta.chunk;
    const long long end = min(meta.n(t), beg + meta.chunk);
    double s1 = 0.0, s2 = 0.0, s3 = 0.0, s4 = 0.0;
    for (long long i = beg + threadIdx.x; i < end; i += THREADS) {
        const double d = (double)__fsub_rn(w[i], mu);
        const double d2 = d * d;
        s1 += d;
        s2 += d2;
        s3 += d2 * d;
        s4 += d2 * d2;
    }
    s1 = block_sum(s1, sh);
    s2 = block_sum(s2, sh);
    s3 = block_sum(s3, sh);
    s4 = block_sum(s4, sh);
    if (threadIdx.x == 0) {
        partial[b * NPART + 1] = s1;
        partial[b * NPART + 2] = s2;
        partial[b * NPART + 3] = s3;
        partial[b * NPART + 4] = s4;
    }
}

// one block of 1024 threads: warp w finalizes tensors w, w + 32, ...
__global__ void __launch_bounds__(1024)
kurt_finalize_kernel(Meta meta, const double* __restrict__ partial,
                     const float* __restrict__ targets, int mode, double* __restrict__ coef,
                     float* __restrict__ kurt_out, float* __restrict__ loss_out) {
    __shared__ double S[MAX_T][4];
    __shared__ double kurt_sh[MAX_T];
    __shared__ double loss_sh[MAX_T];
    __shared__ double wt_sh[MAX_T];
    const int T = meta.T;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int t = warp; t < T; t += blockDim.x / 32) {
        double s[4];
        for (int q = 0; q < 4; ++q) s[q] = warp_partial_sum(partial, meta, t, q + 1);
        if (lane == 0) {
            const double n = (double)meta.n(t);
            const double var = s[1] / (n - 1.0);
            const double kurt = (s[3] / n) / (var * var);
            const double diff = kurt - (double)targets[t];
            for (int q = 0; q < 4; ++q) S[t][q] = s[q];
            kurt_sh[t] = kurt;
            loss_sh[t] = diff * diff;
            kurt_out[t] = (float)kurt;
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        double red = 0.0;
        if (mode == 2) {  // max: the gradient is shared by the tied maxima
            red = loss_sh[0];
            for (int t = 1; t < T; ++t) red = fmax(red, loss_sh[t]);
            int ties = 0;
            for (int t = 0; t < T; ++t) ties += loss_sh[t] == red;
            for (int t = 0; t < T; ++t) wt_sh[t] = loss_sh[t] == red ? 1.0 / ties : 0.0;
        } else {
            for (int t = 0; t < T; ++t) red += loss_sh[t];
            if (mode == 0) red /= (double)T;
            for (int t = 0; t < T; ++t) wt_sh[t] = mode == 0 ? 1.0 / T : 1.0;
        }
        loss_out[0] = (float)red;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const double n = (double)meta.n(t);
        const double c = (n - 1.0) * (n - 1.0) / n;
        const double s2 = S[t][1];
        const double scale = wt_sh[t] * 2.0 * (kurt_sh[t] - (double)targets[t]);
        const double A = scale * c * 4.0 / (s2 * s2);
        const double B = -scale * c * 4.0 * S[t][3] / (s2 * s2 * s2);
        coef[t * NCOEF + 0] = A;
        coef[t * NCOEF + 1] = B;
        coef[t * NCOEF + 2] = -(A * S[t][2] + B * S[t][0]) / n;
    }
}

__global__ void __launch_bounds__(THREADS)
kurt_grad_kernel(Meta meta, const double* __restrict__ coef, float* __restrict__ grad) {
    const int b = blockIdx.x;
    const int t = meta.tensor_of(b);
    const double A = coef[t * NCOEF + 0];
    const double B = coef[t * NCOEF + 1];
    const double C = coef[t * NCOEF + 2];
    const float mu = (float)coef[t * NCOEF + 3];
    const float* w = meta.ptr(t);
    float* out = grad + meta.goff(t);
    const long long beg = (long long)(b - meta.bstart(t)) * meta.chunk;
    const long long end = min(meta.n(t), beg + meta.chunk);
    for (long long i = beg + threadIdx.x; i < end; i += THREADS) {
        const double d = (double)__fsub_rn(w[i], mu);
        out[i] = (float)(A * d * d * d + B * d + C);
    }
}

}  // namespace

BDBNN_EXPORT int bdbnn_kurtosis_grouped(const void* meta, const void* targets, int T,
                                        int total_blocks, int chunk, int mode, int with_grad,
                                        void* partial, void* coef, void* kurt_out,
                                        void* loss_out, void* grad, void* stream) {
    if (T < 1 || T > MAX_T || chunk < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Meta m{static_cast<const long long*>(meta), T, chunk};
    double* part = static_cast<double*>(partial);
    double* cf = static_cast<double*>(coef);
    kurt_sum_kernel<<<total_blocks, THREADS, 0, st>>>(m, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kurt_moments_kernel<<<total_blocks, THREADS, 0, st>>>(m, part, cf);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    kurt_finalize_kernel<<<1, 1024, 0, st>>>(m, part, static_cast<const float*>(targets), mode,
                                            cf, static_cast<float*>(kurt_out),
                                            static_cast<float*>(loss_out));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (with_grad)
        kurt_grad_kernel<<<total_blocks, THREADS, 0, st>>>(m, cf, static_cast<float*>(grad));
    return (int)cudaGetLastError();
}
