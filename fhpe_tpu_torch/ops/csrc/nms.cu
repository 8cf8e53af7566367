// OKS-NMS on the card for Hopper (sm_90a): the pairwise OKS matrix (K2)
// and the greedy keep mask that consumes it.
//
// pairwise_oks replaces the Pallas kernel
// fhpe_tpu/ops/nms_jax.py::pairwise_oks_pallas (kernel body :75-91).  For
// detections i, j of one image,
//   oks[i, j] = (1/J) sum_k exp(-(dx*dx + dy*dy) * iv[k] * inv_denom),
// dx = x[j, k] - x[i, k], iv[k] = 1 / (2 (2 sigma_k)^2) and
// inv_denom = 1 / ((a_i + a_j) / 2 + eps), in K2's order: inv_denom first,
// then per joint e and acc += exp(-e), then acc / J.  Every product and sum
// is rounded on its own (__fmul_rn / __fadd_rn: nvcc would contract
// dx*dx + dy*dy into an FMA) and expf is the full-precision one (built
// without --use_fast_math), so the kernel repeats the plain version
// (fhpe_tpu_torch/ops/nms_torch.py::pairwise_oks_plain) operation for
// operation.
//
// What bounds it: at the COCO path's shape (N = 128 after padding) it reads
// 17 KB and writes 64 KB and does 278k expf, ~0.04 us of the card's float32
// rate: it is launch-bound.  Design: one thread per (i, j) in 16x16 tiles.
// A block stages its 16 rows' and 16 columns' coordinates and areas in
// shared memory, joint-major, so a warp reads 16 consecutive columns of one
// joint without bank conflicts; the joint weights come by value as a kernel
// argument.  Any N, with the ragged edge masked.
//
// greedy_nms_mask replaces fhpe_tpu/ops/nms_jax.py::greedy_nms_mask, a
// lax.while_loop that runs as one device program.  While any detection is
// alive: keep the alive one with the highest score (the LARGER index among
// equal scores, numpy's argsort()[::-1] order; a NaN score counts as -inf,
// so the loop always ends), then clear every alive j with
// sim[i, j] > thresh (strictly greater), and i itself.  One CTA runs the
// whole loop, so the host waits once per image and not once per kept
// detection.  Thread t owns columns t, t + blockDim, ...: it alone reads
// and writes their alive flags (shared memory), so the only block-wide
// step of a round is the (score, index) argmax, a warp shuffle then one
// warp over the warp winners: two __syncthreads per kept detection.
// What bounds it: the rounds (one per kept detection) of reductions and
// barriers; the bytes (one row of sim per round) are nothing.  The keep
// mask is bit-equal to the plain version (greedy_nms_mask_plain).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 16;
constexpr int kMaxJoints = 32;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;

struct JointWeights {
  float iv[kMaxJoints];
};

__global__ void __launch_bounds__(kTile * kTile)
pairwise_oks_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                    const float* __restrict__ areas, float* __restrict__ out,
                    int n, int joints, float eps, JointWeights w) {
  __shared__ float sxi[kMaxJoints][kTile], syi[kMaxJoints][kTile];
  __shared__ float sxj[kMaxJoints][kTile], syj[kMaxJoints][kTile];
  __shared__ float sai[kTile], saj[kTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;

  for (int t = tid; t < kTile * joints; t += kTile * kTile) {
    const int r = t / joints, k = t % joints;
    const bool in_i = i0 + r < n, in_j = j0 + r < n;
    const size_t oi = static_cast<size_t>(i0 + r) * joints + k;
    const size_t oj = static_cast<size_t>(j0 + r) * joints + k;
    sxi[k][r] = in_i ? xs[oi] : 0.f;
    syi[k][r] = in_i ? ys[oi] : 0.f;
    sxj[k][r] = in_j ? xs[oj] : 0.f;
    syj[k][r] = in_j ? ys[oj] : 0.f;
  }
  if (tid < kTile) {
    sai[tid] = i0 + tid < n ? areas[i0 + tid] : 1.f;
    saj[tid] = j0 + tid < n ? areas[j0 + tid] : 1.f;
  }
  __syncthreads();

  const int i = i0 + ty, j = j0 + tx;
  if (i >= n || j >= n) return;
  const float inv_denom = __fdiv_rn(
      1.f, __fadd_rn(__fdiv_rn(__fadd_rn(sai[ty], saj[tx]), 2.f), eps));
  float acc = 0.f;
  for (int k = 0; k < joints; ++k) {
    const float dx = __fsub_rn(sxj[k][tx], sxi[k][ty]);
    const float dy = __fsub_rn(syj[k][tx], syi[k][ty]);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float e = __fmul_rn(__fmul_rn(d2, w.iv[k]), inv_denom);
    acc = __fadd_rn(acc, expf(-e));
  }
  out[static_cast<size_t>(i) * n + j] =
      __fdiv_rn(acc, static_cast<float>(joints));
}

// Does candidate (key, idx) beat the current (best_key, best_idx)?  An index
// of -1 is "none"; equal keys go to the larger index.
__device__ __forceinline__ bool beats(float key, int idx, float best_key,
                                      int best_idx) {
  if (idx < 0) return false;
  if (best_idx < 0) return true;
  return key > best_key || (key == best_key && idx > best_idx);
}

__device__ __forceinline__ void warp_argmax(float& key, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_down_sync(kFullMask, key, off);
    const int oi = __shfl_down_sync(kFullMask, idx, off);
    if (beats(ok, oi, key, idx)) {
      key = ok;
      idx = oi;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
greedy_nms_kernel(const float* __restrict__ sim,
                  const float* __restrict__ scores,
                  const unsigned char* __restrict__ valid,
                  unsigned char* __restrict__ keep, int n, float thresh) {
  extern __shared__ unsigned char alive[];
  __shared__ float red_key[32];
  __shared__ int red_idx[32];
  __shared__ int s_best;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // Each thread touches only its own columns here and below, so no barrier
  // is needed before the first round.
  for (int c = tid; c < n; c += blockDim.x) {
    alive[c] = valid[c] ? 1 : 0;
    keep[c] = 0;
  }
  for (;;) {
    float key = -CUDART_INF_F;
    int idx = -1;
    for (int c = tid; c < n; c += blockDim.x) {
      if (!alive[c]) continue;
      float s = scores[c];
      if (isnan(s)) s = -CUDART_INF_F;
      if (beats(s, c, key, idx)) {
        key = s;
        idx = c;
      }
    }
    warp_argmax(key, idx);
    if (lane == 0) {
      red_key[warp] = key;
      red_idx[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      key = lane < nwarps ? red_key[lane] : -CUDART_INF_F;
      idx = lane < nwarps ? red_idx[lane] : -1;
      warp_argmax(key, idx);
      if (lane == 0) s_best = idx;
    }
    __syncthreads();
    const int best = s_best;
    if (best < 0) break;  // uniform: no detection is alive
    if (tid == 0) keep[best] = 1;
    const float* row = sim + static_cast<size_t>(best) * n;
    for (int c = tid; c < n; c += blockDim.x) {
      if (alive[c] && (c == best || row[c] > thresh)) alive[c] = 0;
    }
  }
}

}  // namespace

extern "C" {

// xs, ys: (n, joints) float32 contiguous on the device; areas: (n,);
// out: (n, n) float32.  inv_two_vars: `joints` floats in HOST memory, passed
// to the kernel by value.  Launches on `stream`; returns a CUDA error code
// (0 = launched).
int fhpe_pairwise_oks(const void* xs, const void* ys, const void* areas,
                      void* out, int n, int joints, const float* inv_two_vars,
                      float eps, void* stream) {
  if (joints < 1 || joints > kMaxJoints || n < 0 || n > 65535 * kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  JointWeights w = {};
  for (int k = 0; k < joints; ++k) w.iv[k] = inv_two_vars[k];
  const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  const dim3 block(kTile, kTile);
  pairwise_oks_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const float*>(areas), static_cast<float*>(out), n, joints,
      eps, w);
  return static_cast<int>(cudaGetLastError());
}

// sim: (n, n) float32; scores: (n,) float32; valid, keep: (n,) one byte
// each (torch.bool).  One CTA; n bytes of dynamic shared memory.
int fhpe_greedy_nms_mask(const void* sim, const void* scores,
                         const void* valid, void* keep, int n, float thresh,
                         void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  greedy_nms_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sim), static_cast<const float*>(scores),
      static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), n, thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
