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
// sim[i, j] > thresh (strictly greater, float32), and i itself.  The kernel
// runs the equivalent ranked bitmask scan in one CTA of 1024 threads: (1)
// rank every valid detection in that order (an O(N^2) count, one warp per
// detection; padding gets no rank); (2) the suppression bits, bits[i][w]
// bit b set when sim[i, 32w + b] > thresh, one warp per valid row with
// four coalesced 128-byte loads in flight and a ballot per 32 columns; (3)
// one warp walks the ranks with the
// removed mask in lane registers (word w in lane w % 32, slot w / 32): at
// rank r with i = order[r], the owning lane's word is broadcast by
// __shfl_sync, and if bit i is clear i is kept and every lane ORs its words
// of row i in.  A kept detection clears exactly the alive detections its
// sim row puts above the threshold, and the next greedy argmax is the first
// rank not yet cleared, so the keep mask is the greedy loop's, bit-equal to
// the plain version (greedy_nms_mask_plain).  The bits live in dynamic
// shared memory up to kShmemMaxN detections (kShmemMaxN * 16 words =
// 32 KB), above it in device scratch the wrapper allocates, up to
// kMaxScanN (the removed mask's kScanSlots words per lane).  What bounds
// it: the scan's dependent steps (a broadcast and a shared-memory row per
// kept detection); reading sim is N*N*4 bytes.
//
// oks_nms_segments is the COCO path's hard OKS-NMS of a whole evaluated
// set in one launch, K2 and the greedy selection fused: one CTA per image
// of a CSR pack (offsets[g] .. offsets[g + 1]).  It ranks the detections,
// stages the image's coordinates joint-major in shared memory as K2 does
// (in rank order), then computes the thresholded OKS bits in RANK space,
// B[r][s] = oks(order[r], order[s]) > thresh for s > r only (the scan
// never reads a bit at or before its own rank, so half the pairs), one
// pair per thread over the triangle laid end to end (every lane busy even
// for an image of a few detections) and an atomic OR per hit, straight
// into zeroed shared memory: the N x N float32 matrix never reaches device
// memory.  Each OKS repeats K2's operations and roundings (oks_value
// below; COCO's 17 joints unrolled so their expf overlap), so every
// threshold decision equals K2 -> greedy's.  The scan is the same
// routine, in rank space.  An image above kShmemMaxN reads its coordinates
// from device memory and keeps its bits in scratch, at an offset the block
// sums from the images before it; an image with no detection is a no-op.
// What bounds it: the float32 OKS arithmetic, ~N^2/2 * (10 J + 5)
// operations per image (~25 instructions a joint with K2's roundings and
// full expf), on one SM per image; a single large image is therefore
// slower than K2's N*N/256 blocks, a set of many images is not.  Blocks of
// kSegThreads = 256 threads, up to eight resident per SM.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 16;
constexpr int kMaxJoints = 32;
constexpr int kMaxThreads = 1024;
// the segmented kernel's block (up to eight blocks, eight images, per SM)
constexpr int kSegThreads = 256;
// bits in dynamic shared memory up to this many detections (32 KB of bits)
constexpr int kShmemMaxN = 512;
// words of the removed mask per lane: kMaxScanN = 32 lanes * 32 bits * slots
constexpr int kScanSlots = 8;
constexpr int kMaxScanN = 32 * 32 * kScanSlots;
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

// The OKS of detection j to detection i, in K2's order of operations and
// roundings (pairwise_oks_kernel above); xi, yi, xj, yj point at joint 0
// with `stride` floats between joints.  kJ > 0 fixes the joint count at
// compile time (COCO's 17): the loop unrolls, so the joints' expf run
// side by side while the sum still adds them in K2's order.
template <int kJ>
__device__ __forceinline__ float oks_value(const float* xi, const float* yi,
                                           const float* xj, const float* yj,
                                           int stride, float ai, float aj,
                                           int joints_arg, float eps,
                                           const JointWeights& w) {
  const int joints = kJ > 0 ? kJ : joints_arg;
  const float inv_denom =
      __fdiv_rn(1.f, __fadd_rn(__fdiv_rn(__fadd_rn(ai, aj), 2.f), eps));
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < joints; ++k) {
    const float dx = __fsub_rn(xj[k * stride], xi[k * stride]);
    const float dy = __fsub_rn(yj[k * stride], yi[k * stride]);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float e = __fmul_rn(__fmul_rn(d2, w.iv[k]), inv_denom);
    acc = __fadd_rn(acc, expf(-e));
  }
  return __fdiv_rn(acc, static_cast<float>(joints));
}

// Rank key: NaN (no rank) for padding, -inf for a NaN score.
__device__ __forceinline__ float rank_key(float score, bool valid) {
  if (!valid) return CUDART_NAN_F;
  return isnan(score) ? -CUDART_INF_F : score;
}

// order[rank] = i for every detection whose key is not NaN: descending key,
// equal keys to the larger index.  One warp per detection counts the
// detections ahead of it, lanes on consecutive keys.  order[] must hold -1
// beyond the ranked prefix (the caller fills it before the barrier that
// precedes this).  All threads of the block call it.
__device__ __forceinline__ void rank_detections(const float* key, int* order,
                                                int n) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += blockDim.x >> 5) {
    const float ki = key[i];
    if (isnan(ki)) continue;  // uniform over the warp
    int r = 0;
    for (int j = lane; j < n; j += 32) {
      const float kj = key[j];
      r += (kj > ki) || (kj == ki && j > i);
    }
    r = __reduce_add_sync(kFullMask, r);
    if (lane == 0) order[r] = i;
  }
}

// The greedy walk over the ranks, by warp 0 alone.  Row p of `bits` (words
// words, shared or device memory) holds the detections that position p
// suppresses.  In index space (kByRank false) a position is a detection's
// index; in rank space (true) it is its rank, and only the words from the
// row's own rank on can hold a set bit.
template <bool kByRank>
__device__ __forceinline__ void scan_ranks(const unsigned* bits, int words,
                                           const int* order, int n,
                                           unsigned char* keep) {
  const int lane = threadIdx.x & 31;
  unsigned removed[kScanSlots];
#pragma unroll
  for (int s = 0; s < kScanSlots; ++s) removed[s] = 0u;
  int next = order[0];
  for (int r = 0; r < n; ++r) {
    const int i = next;
    if (i < 0) break;  // uniform: past the ranked prefix
    next = r + 1 < n ? order[r + 1] : -1;
    const int p = kByRank ? r : i;
    const int w = p >> 5, slot = w >> 5;
    unsigned mine = 0u;
#pragma unroll
    for (int s = 0; s < kScanSlots; ++s)
      if (s == slot) mine = removed[s];
    if ((__shfl_sync(kFullMask, mine, w & 31) >> (p & 31)) & 1u) continue;
    if (lane == 0) keep[i] = 1;
    const unsigned* row = bits + static_cast<size_t>(p) * words;
    const int first = kByRank ? w : 0;
#pragma unroll
    for (int s = 0; s < kScanSlots; ++s) {
      const int ww = lane + 32 * s;
      if (ww >= first && ww < words) removed[s] |= row[ww];
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
greedy_nms_kernel(const float* __restrict__ sim,
                  const float* __restrict__ scores,
                  const unsigned char* __restrict__ valid,
                  unsigned char* __restrict__ keep, int n, float thresh,
                  unsigned* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* key = reinterpret_cast<float*>(smem);
  int* order = reinterpret_cast<int*>(key + n);
  const int words = (n + 31) / 32;
  unsigned* bits = n > kShmemMaxN ? scratch
                                  : reinterpret_cast<unsigned*>(order + n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int c = tid; c < n; c += blockDim.x) {
    key[c] = rank_key(scores[c], valid[c] != 0);
    order[c] = -1;
    keep[c] = 0;
  }
  __syncthreads();
  // one warp per valid row: four coalesced 128-byte loads in flight, then
  // a ballot per 32 columns
  for (int i = warp; i < n; i += nwarps) {
    if (isnan(key[i])) continue;  // uniform over the warp
    const float* row = sim + static_cast<size_t>(i) * n;
    for (int w0 = 0; w0 < words; w0 += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (w0 + u) * 32 + lane;
        v[u] = c < n ? row[c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (w0 + u) * 32 + lane;
        const unsigned word = __ballot_sync(kFullMask, c < n && v[u] > thresh);
        if (lane == 0 && w0 + u < words) bits[i * words + w0 + u] = word;
      }
    }
  }
  rank_detections(key, order, n);
  __syncthreads();
  if (warp == 0) scan_ranks<false>(bits, words, order, n, keep);
}

// First pair of row r of the upper triangle (s > r) of an n x n matrix,
// rows laid end to end.
__device__ __forceinline__ int triangle_start(int r, int n) {
  return r * (2 * n - r - 1) / 2;
}

template <int kJ>
__global__ void __launch_bounds__(kSegThreads)
oks_nms_segments_kernel(const float* __restrict__ xs,
                        const float* __restrict__ ys,
                        const float* __restrict__ areas,
                        const float* __restrict__ scores,
                        const int* __restrict__ offsets,
                        unsigned char* __restrict__ keep, int joints,
                        float eps, float thresh, JointWeights w,
                        unsigned* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long part[kSegThreads / 32];
  const int base = offsets[blockIdx.x];
  const int n = offsets[blockIdx.x + 1] - base;
  if (n <= 0) return;  // uniform
  if (kJ > 0) joints = kJ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int words = (n + 31) / 32;
  const bool staged = n <= kShmemMaxN;
  float* key = reinterpret_cast<float*>(smem);
  int* order = reinterpret_cast<int*>(key + n);
  unsigned* bits;
  float *sx = nullptr, *sy = nullptr, *sa = nullptr;

  if (staged) {
    bits = reinterpret_cast<unsigned*>(order + n);
    sx = reinterpret_cast<float*>(bits + n * words);
    sy = sx + joints * n;
    sa = sy + joints * n;
  } else {
    // this image's bits follow those of the earlier images above the cap
    long long sum = 0;
    for (int h = tid; h < static_cast<int>(blockIdx.x); h += blockDim.x) {
      const long long m = offsets[h + 1] - offsets[h];
      if (m > kShmemMaxN) sum += m * ((m + 31) / 32);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(kFullMask, sum, off);
    if (lane == 0) part[warp] = sum;
    __syncthreads();
    sum = 0;
    for (int v = 0; v < kSegThreads / 32; ++v) sum += part[v];
    bits = scratch + sum;
  }
  for (int c = tid; c < n; c += blockDim.x) {
    key[c] = rank_key(scores[base + c], true);
    order[c] = -1;
    keep[base + c] = 0;
  }
  for (int q = tid; q < n * words; q += blockDim.x) bits[q] = 0u;
  __syncthreads();
  rank_detections(key, order, n);
  __syncthreads();
  // Staged: coordinates joint-major in RANK order, so a warp reads its
  // pairs' rows and columns from consecutive or equal addresses.
  // Otherwise from device memory, row-major.
  const float *cx, *cy, *ca;
  int stride, step;  // floats between a detection's joints; between rows
  if (staged) {
    for (int t = tid; t < n * joints; t += blockDim.x) {
      const int r = t / joints, k = t - r * joints;
      const size_t src = static_cast<size_t>(base + order[r]) * joints + k;
      sx[k * n + r] = xs[src];
      sy[k * n + r] = ys[src];
    }
    for (int r = tid; r < n; r += blockDim.x) sa[r] = areas[base + order[r]];
    __syncthreads();
    cx = sx, cy = sy, ca = sa, stride = n, step = 1;
  } else {
    cx = xs + static_cast<size_t>(base) * joints;
    cy = ys + static_cast<size_t>(base) * joints;
    ca = areas + base;
    stride = 1, step = joints;
  }
  // B[r][s] for s > r: the upper triangle's pairs laid end to end, one
  // per thread, so every lane has work; a hit (a near-duplicate, rare)
  // sets its bit with an atomic OR.
  const int pairs = n * (n - 1) / 2;
  const float b2 = 2.f * n - 1.f;
  for (int pr = tid; pr < pairs; pr += blockDim.x) {
    int r = static_cast<int>(
        0.5f * (b2 - sqrtf(fmaxf(0.f, b2 * b2 - 8.f * pr))));
    r = r < 0 ? 0 : (r > n - 2 ? n - 2 : r);
    while (r > 0 && triangle_start(r, n) > pr) --r;
    while (r < n - 2 && triangle_start(r + 1, n) <= pr) ++r;
    const int s = pr - triangle_start(r, n) + r + 1;
    const int a = staged ? r : order[r], b = staged ? s : order[s];
    if (oks_value<kJ>(cx + a * step, cy + a * step, cx + b * step,
                      cy + b * step, stride, ca[a], ca[b], joints, eps,
                      w) > thresh)
      atomicOr(bits + r * words + (s >> 5), 1u << (s & 31));
  }
  __syncthreads();
  if (warp == 0) scan_ranks<true>(bits, words, order, n, keep + base);
}

size_t greedy_smem(int n) {
  const size_t words = (n + 31) / 32;
  return static_cast<size_t>(n) * 8 +
         (n > kShmemMaxN ? 0 : static_cast<size_t>(n) * words * 4);
}

size_t segments_smem(int staged_n, int big_n, int joints) {
  const size_t words = (staged_n + 31) / 32;
  const size_t staged = static_cast<size_t>(staged_n) *
                        (8 + 4 * words + 4 * (2 * joints + 1));
  const size_t big = static_cast<size_t>(big_n) * 8;
  return staged > big ? staged : big;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
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
// each (torch.bool).  One CTA.  scratch: n * ceil(n / 32) uint32 on the
// device when n > kShmemMaxN (else unused, may be null); n <= kMaxScanN.
int fhpe_greedy_nms_mask(const void* sim, const void* scores,
                         const void* valid, void* keep, int n, float thresh,
                         void* scratch, void* stream) {
  if (n < 0 || n > kMaxScanN || (n > kShmemMaxN && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t smem = greedy_smem(n);
  const int err = set_smem(greedy_nms_kernel, smem);
  if (err != 0) return err;
  greedy_nms_kernel<<<1, kMaxThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sim), static_cast<const float*>(scores),
      static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), n, thresh,
      static_cast<unsigned*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// The hard OKS-NMS of `images` images in one launch.  xs, ys: (T, joints)
// float32; areas, scores: (T,) float32; offsets: (images + 1,) int32 on
// the device, image g is rows offsets[g] .. offsets[g + 1]; keep: (T,) one
// byte each.  inv_two_vars: `joints` floats in HOST memory, passed by
// value.  staged_n / big_n: the largest image at or below kShmemMaxN / above
// it (0 if none); scratch: sum over the images above kShmemMaxN of
// n * ceil(n / 32) uint32 (null if none).  Every image n <= kMaxScanN.
int fhpe_oks_nms_segments(const void* xs, const void* ys, const void* areas,
                          const void* scores, const void* offsets,
                          void* keep, void* scratch, int images, int joints,
                          const float* inv_two_vars, float eps, float thresh,
                          int staged_n, int big_n, void* stream) {
  if (joints < 1 || joints > kMaxJoints || images < 0 || staged_n < 0 ||
      staged_n > kShmemMaxN || big_n > kMaxScanN ||
      (big_n > 0 && (big_n <= kShmemMaxN || scratch == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (images == 0 || (staged_n == 0 && big_n == 0)) return 0;
  JointWeights w = {};
  for (int k = 0; k < joints; ++k) w.iv[k] = inv_two_vars[k];
  const size_t smem = segments_smem(staged_n, big_n, joints);
  // COCO's 17 joints unrolled, any other count on the generic loop
  auto kernel = joints == 17 ? oks_nms_segments_kernel<17>
                             : oks_nms_segments_kernel<0>;
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<images, kSegThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const float*>(areas), static_cast<const float*>(scores),
      static_cast<const int*>(offsets), static_cast<unsigned char*>(keep),
      joints, eps, thresh, w, static_cast<unsigned*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
