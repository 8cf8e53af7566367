// A chain of HRNet BasicBlocks with identity residuals, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of scripts/probe/fused_block/
// fused_block_kernels.py (P5): _eval_kernel (wrapper chain_pallas_eval) and
// _train_kernel (wrapper chain_pallas_train).  Per block, NCHW, C channels
// in and out, with x the block's input:
//
//   u = round(conv3x3(x, W1));  a = relu(round(bn1(u)))
//   v = round(conv3x3(a, W2));  y = relu(round(round(bn2(v)) + x))
//
// where round() rounds to the compute type T (bfloat16 or float32: the
// identity) and bn(t) = (t - mean) * inv * gamma + beta in float32, each
// operation rounded on its own, inv = 1 / sqrt(var + eps).  That is
// fhpe_tpu's model (fhpe_tpu/models/pose_hrnet.py::BasicBlock): the conv
// output is rounded before BatchNorm normalizes it in float32.  P5's
// kernels fold BN into the float32 accumulator instead; the plain version
// (fhpe_tpu_torch/ops/branch_chain.py) follows the model too.
//
// * Eval (fhpe_branch_chain_eval): mean and var are the running statistics.
//   Two launches per block; BN, ReLU and the residual are the epilogues of
//   the two convs, so device memory sees a and each block's output once.
// * Train (fhpe_branch_chain_train): mean and var are the batch statistics
//   of u and v over (B, H, W), exact over the whole batch, as P5's three
//   phases per block compute them: conv1 writes u and per-tile partial
//   statistics (count, mean, sum of squared deviations); a small launch
//   merges them per channel in a fixed order (Chan's formula, in float64:
//   a two-pass variance, no atomics, so two runs give the same bits);
//   conv2 applies BN1 and ReLU to u in its loads (P5's pre_norm_relu) and
//   writes v and its partials; a third launch merges them; an elementwise
//   launch writes the block output.  u, v and every block output stay in
//   device memory for the backward (ops/branch_chain.py::BranchChainFn).
//
// What bounds it: each conv is a (C) x (B*H*W) x (9C) matrix product,
// 18 C^2 operations per pixel against 4 C bytes in and out (bf16), so
// 4.5 C operations per byte: above the H100's ~295 bf16 operations per
// byte of HBM from C = 66 on, the tensor cores bound it; below, the bytes.
// HRNet's branches run at C = 32 ... 384.
//
// Design (simple and right first; TMA, wgmma and one persistent launch for
// the whole chain are later work): an implicit GEMM per conv, the core in
// conv3x3_core.cuh (64 x 64 output tiles, K = 9C in steps of 32, bfloat16
// on the tensor cores through wmma, float32 on the CUDA cores).  The
// accumulators go through shared memory to the epilogue, which rounds,
// normalizes and writes coalesced along pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3x3_core.cuh"

namespace {

using namespace conv3x3;

constexpr int kReduceThreads = 256;
constexpr int kEltThreads = 256;

enum Epilogue { kRawStats = 0, kBnRelu = 1, kBnAddRelu = 2 };

template <typename T>
struct ConvArgs {
  const T* in;      // (B, C, H, W)
  const T* weight;  // (C, C, 3, 3)
  T* out;           // (B, C, H, W)
  const T* res;     // kBnAddRelu: the residual; may be `out` itself
  Bn pre;           // kPre: relu(round(bn(in))) applied in the loads
  Bn post;          // kBnRelu / kBnAddRelu
  float eps;
  float* part_mean;  // kRawStats: (tiles along N, C) per-tile mean ...
  float* part_m2;    // ... and sum of squared deviations from it
  int b, c, h, w;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int kMode, bool kPre>
__global__ void __launch_bounds__(kThreads)
chain_conv3x3(const ConvArgs<T> p) {
  __shared__ __align__(128) unsigned char smem[Smem<T>::kBytes];
  __shared__ float s_mean[kBM], s_inv[kBM], s_gamma[kBM], s_beta[kBM];
  float* cs = reinterpret_cast<float*>(smem);

  const int c = p.c, hw = p.h * p.w, n_total = p.b * hw;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const Pixel px = tile_pixel(n0, c, p.h, p.w, n_total, tid);
  const int ln = px.ln, lk = px.lk;

  conv_tile<T, kPre>(p.in, p.weight, p.pre, c, p.h, p.w, m0, px, smem);
  if (kMode != kRawStats) {
    for (int r = tid; r < kBM; r += kThreads) {
      const int o = m0 + r;
      if (o < c) {
        s_mean[r] = p.post.mean[o];
        s_inv[r] = p.post.inv ? p.post.inv[o]
                              : 1.f / sqrtf(__fadd_rn(p.post.var[o], p.eps));
        s_gamma[r] = p.post.gamma[o];
        s_beta[r] = p.post.beta[o];
      }
    }
  }
  __syncthreads();

#pragma unroll 4
  for (int j = 0; j < kBM / 2; ++j) {
    const int r = lk + 2 * j, o = m0 + r;
    if (o >= c || !px.ok) continue;
    const float v = round_to<T>(cs[r * kLdc + ln]);
    const int idx = px.off + o * hw;
    if (kMode == kRawStats) {
      cs[r * kLdc + ln] = v;
      p.out[idx] = from_f32<T>(v);
    } else {
      float t = round_to<T>(bn(v, s_mean[r], s_inv[r], s_gamma[r], s_beta[r]));
      if (kMode == kBnAddRelu)
        t = round_to<T>(__fadd_rn(t, to_f32(p.res[idx])));
      p.out[idx] = from_f32<T>(relu(t));
    }
  }
  if (kMode != kRawStats) return;

  // Per-channel statistics of this tile's rounded outputs: count, mean and
  // the sum of squared deviations from it (two passes over shared memory).
  __syncthreads();
  const int lane = tid % 32, warp = tid / 32;
  const int cnt = min(kBN, n_total - n0);
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int o = m0 + r;
    if (o >= c) break;
    const float v0 = lane < cnt ? cs[r * kLdc + lane] : 0.f;
    const float v1 = lane + 32 < cnt ? cs[r * kLdc + lane + 32] : 0.f;
    const float mean =
        __shfl_sync(0xffffffffu, warp_sum(v0 + v1), 0) / static_cast<float>(cnt);
    const float d0 = lane < cnt ? v0 - mean : 0.f;
    const float d1 = lane + 32 < cnt ? v1 - mean : 0.f;
    const float m2 = warp_sum(d0 * d0 + d1 * d1);
    if (lane == 0) {
      p.part_mean[blockIdx.x * c + o] = mean;
      p.part_m2[blockIdx.x * c + o] = m2;
    }
  }
}

// Chan et al.'s merge of (count, mean, M2) b into a.
__device__ __forceinline__ void merge(double& n, double& mean, double& m2,
                                      double nb, double mb, double m2b) {
  if (nb == 0.0) return;
  const double tot = n + nb, delta = mb - mean;
  mean += delta * (nb / tot);
  m2 += m2b + delta * delta * (n * nb / tot);
  n = tot;
}

// One block per channel: the tiles' partials merged in a fixed order
// (a strided walk per thread, then a tree); writes the batch mean, the
// biased variance and 1/sqrt(var + eps), float32.
__global__ void __launch_bounds__(kReduceThreads)
chain_stats_reduce(const float* __restrict__ part_mean,
             const float* __restrict__ part_m2, int tiles, int n_total, int c,
             float eps, float* __restrict__ mean_out,
             float* __restrict__ var_out, float* __restrict__ inv_out) {
  __shared__ double sn[kReduceThreads], smean[kReduceThreads],
      sm2[kReduceThreads];
  const int o = blockIdx.x, tid = threadIdx.x;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int t = tid; t < tiles; t += kReduceThreads)
    merge(n, mean, m2, static_cast<double>(min(kBN, n_total - t * kBN)),
          part_mean[t * c + o], part_m2[t * c + o]);
  sn[tid] = n;
  smean[tid] = mean;
  sm2[tid] = m2;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      merge(n, mean, m2, sn[tid + s], smean[tid + s], sm2[tid + s]);
      sn[tid] = n;
      smean[tid] = mean;
      sm2[tid] = m2;
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float var = static_cast<float>(m2 / n);
    mean_out[o] = static_cast<float>(mean);
    var_out[o] = var;
    inv_out[o] = 1.f / sqrtf(__fadd_rn(var, eps));
  }
}

// Train-mode block output: relu(round(round(bn2(v)) + x)).
template <typename T>
__global__ void __launch_bounds__(kEltThreads)
chain_block_output(const T* __restrict__ v, const T* __restrict__ res,
             T* __restrict__ out, Bn bn2, int c, int hw, int total) {
  for (int e = blockIdx.x * kEltThreads + threadIdx.x; e < total;
       e += gridDim.x * kEltThreads) {
    const int ch = (e / hw) % c;
    float t = round_to<T>(bn(to_f32(v[e]), bn2.mean[ch], bn2.inv[ch],
                             bn2.gamma[ch], bn2.beta[ch]));
    t = round_to<T>(__fadd_rn(t, to_f32(res[e])));
    out[e] = from_f32<T>(relu(t));
  }
}

template <typename T, int kMode, bool kPre>
cudaError_t launch_conv(const ConvArgs<T>& a, cudaStream_t stream) {
  const int n_total = a.b * a.h * a.w;
  const dim3 grid((n_total + kBN - 1) / kBN, (a.c + kBM - 1) / kBM);
  chain_conv3x3<T, kMode, kPre><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int chain_eval(const void* x, void* y, void* tmp, int nb, int b, int c,
               int h, int w, const void* const* weights,
               const void* const* gammas, const void* const* betas,
               const void* const* means, const void* const* vars, float eps,
               cudaStream_t stream) {
  const T* cur = static_cast<const T*>(x);
  T* out = static_cast<T*>(y);
  T* a = static_cast<T*>(tmp);
  for (int k = 0; k < nb; ++k) {
    for (int half = 0; half < 2; ++half) {
      const int i = 2 * k + half;
      ConvArgs<T> args{};
      args.in = half == 0 ? cur : a;
      args.weight = static_cast<const T*>(weights[i]);
      args.out = half == 0 ? a : out;
      args.res = cur;  // block k >= 1: out itself, read where it is written
      args.post = {static_cast<const float*>(means[i]),
                   static_cast<const float*>(vars[i]), nullptr,
                   static_cast<const float*>(gammas[i]),
                   static_cast<const float*>(betas[i])};
      args.eps = eps;
      args.b = b;
      args.c = c;
      args.h = h;
      args.w = w;
      const cudaError_t err =
          half == 0 ? launch_conv<T, kBnRelu, false>(args, stream)
                    : launch_conv<T, kBnAddRelu, false>(args, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cur = out;
  }
  return 0;
}

template <typename T>
int chain_train(const void* x, void* outs, void* pre, float* mean_out,
                float* var_out, float* inv_out, float* part, int nb, int b,
                int c, int h, int w, const void* const* weights,
                const void* const* gammas, const void* const* betas,
                float eps, cudaStream_t stream) {
  const int total = b * c * h * w, n_total = b * h * w;
  const int tiles = (n_total + kBN - 1) / kBN;
  const T* cur = static_cast<const T*>(x);
  const int elt_blocks = min((total + kEltThreads - 1) / kEltThreads, 4096);
  for (int k = 0; k < nb; ++k) {
    T* u = static_cast<T*>(pre) + static_cast<size_t>(2 * k) * total;
    T* v = u + total;
    T* o = static_cast<T*>(outs) + static_cast<size_t>(k) * total;
    for (int half = 0; half < 2; ++half) {
      const int i = 2 * k + half;
      ConvArgs<T> args{};
      args.in = half == 0 ? cur : u;
      args.weight = static_cast<const T*>(weights[i]);
      args.out = half == 0 ? u : v;
      args.eps = eps;
      args.part_mean = part;
      args.part_m2 = part + static_cast<size_t>(tiles) * c;
      args.b = b;
      args.c = c;
      args.h = h;
      args.w = w;
      cudaError_t err;
      if (half == 0) {
        err = launch_conv<T, kRawStats, false>(args, stream);
      } else {
        args.pre = {mean_out + (i - 1) * c, nullptr, inv_out + (i - 1) * c,
                    static_cast<const float*>(gammas[i - 1]),
                    static_cast<const float*>(betas[i - 1])};
        err = launch_conv<T, kRawStats, true>(args, stream);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      chain_stats_reduce<<<c, kReduceThreads, 0, stream>>>(
          args.part_mean, args.part_m2, tiles, n_total, c, eps,
          mean_out + i * c, var_out + i * c, inv_out + i * c);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int i = 2 * k + 1;
    const Bn bn2{mean_out + i * c, nullptr, inv_out + i * c,
                 static_cast<const float*>(gammas[i]),
                 static_cast<const float*>(betas[i])};
    chain_block_output<T><<<elt_blocks, kEltThreads, 0, stream>>>(
        v, cur, o, bn2, c, h * w, total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = o;
  }
  return 0;
}

}  // namespace

extern "C" {

// Eval: x (b, c, h, w) contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); y and tmp the same shape (y the chain output, tmp
// scratch); per conv i = 0 .. 2 nb - 1 (conv1, conv2 of block i / 2):
// weights[i] (c, c, 3, 3) in x's type, and float32 (c,) gammas, betas,
// running means and variances.  Launches on `stream`; returns the first
// CUDA error (0 = launched).
int fhpe_branch_chain_eval(const void* x, void* y, void* tmp, int nb, int b,
                           int c, int h, int w, int is_bf16,
                           const void* const* weights,
                           const void* const* gammas,
                           const void* const* betas, const void* const* means,
                           const void* const* vars, float eps, void* stream) {
  if (nb <= 0 || b <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? chain_eval<__nv_bfloat16>(x, y, tmp, nb, b, c, h, w,
                                             weights, gammas, betas, means,
                                             vars, eps, s)
                 : chain_eval<float>(x, y, tmp, nb, b, c, h, w, weights,
                                     gammas, betas, means, vars, eps, s);
}

// Train: x as above; outs (nb, b, c, h, w): each block's output (the last
// is the chain's); pre (2 nb, b, c, h, w): u and v of each block, before
// BatchNorm; mean_out, var_out, inv_out (2 nb, c) float32: each conv
// output's batch mean, biased variance and 1/sqrt(var + eps); part
// (2, ceil(b h w / 64), c) float32 scratch.  Weights, gammas and betas as
// for eval.  Returns the first CUDA error (0 = launched).
int fhpe_branch_chain_train(const void* x, void* outs, void* pre,
                            void* mean_out, void* var_out, void* inv_out,
                            void* part, int nb, int b, int c, int h, int w,
                            int is_bf16, const void* const* weights,
                            const void* const* gammas,
                            const void* const* betas, float eps,
                            void* stream) {
  if (nb <= 0 || b <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(mean_out);
  float* vo = static_cast<float*>(var_out);
  float* io = static_cast<float*>(inv_out);
  float* pt = static_cast<float*>(part);
  return is_bf16
             ? chain_train<__nv_bfloat16>(x, outs, pre, mo, vo, io, pt, nb, b,
                                          c, h, w, weights, gammas, betas, eps,
                                          s)
             : chain_train<float>(x, outs, pre, mo, vo, io, pt, nb, b, c, h,
                                  w, weights, gammas, betas, eps, s);
}

}  // extern "C"
