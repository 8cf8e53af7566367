// Filter gradient of a 3x3, stride-1, pad-1 convolution for Hopper (sm_90a).
//
// Replaces the Pallas kernel scripts/probe/dw_pallas_probe.py::_dw_kernel
// (wrapper dw_pallas, P4): for x and dy of one shape (B, C, H, W), NCHW,
//
//   dW[o, i, r, c] = sum_bhw dy[b, o, h, w] * x[b, i, h + r - 1, w + c - 1]
//
// with x read as 0 outside the image, accumulated in float32 and written
// as a float32 (C, C, 3, 3) tensor in torch's OIHW weight layout.  x and dy
// are both float32 or both bfloat16; a bfloat16 product is exact in float32,
// so the result differs from the plain version (fhpe_tpu_torch/ops/
// conv_wgrad.py::conv3x3_wgrad_plain) only in the order of the sums.
//
// What bounds it: dW is a (C) x (9C) matrix product over K = B*H*W,
// 2 * 9 * C * C * K operations on 2 * B*C*H*W inputs: 4.5 * C operations
// per bf16 byte, 288 at C = 64 against the ~295 an H100 needs at its bf16
// tensor-core peak.  So on the tensor cores the bytes and the operations
// bound it about equally at C = 64 and the bytes at C = 32; on the CUDA
// cores in float32, as this kernel runs, the operations, by far.
//
// Design (a simple kernel that is right; tensor cores, TMA and wgmma are
// later work): an implicit GEMM on the CUDA cores in float32.  M = C output
// channels, N = 9C (input channel, tap) columns, K = B*H*W.  A block owns a
// 64 x 64 tile of dW and one slice of K (split-K: the workspace gets one
// partial tile per slice, so small C still fills the card).  Each step it
// stages a 32-deep slice of dy (A) and of the shifted x taps (B, gathered
// with the zero border, im2col on the fly) in shared memory as float32, and
// each of its 256 threads accumulates a 4 x 4 sub-tile in registers (rows
// ty + 16q, columns tx + 16p, so shared-memory reads are conflict-free).
// A second launch sums the partial tiles in slice order.  No atomics: the
// order of every sum is fixed, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;          // output channels per tile
constexpr int kBN = 64;          // (input channel, tap) columns per tile
constexpr int kBK = 32;          // K per shared-memory step (one warp wide)
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / kBK;   // 8 tile rows loaded per pass
constexpr int kLoads = kBM / kRowsPerPass;     // 8 loads of A (and of B)
constexpr int kReduceThreads = 256;

static_assert(kBM == kBN, "A and B tiles share the load mapping");
static_assert(kBM == 4 * 16 && kBN == 4 * 16, "16 x 16 threads, 4 x 4 each");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_partial(const T* __restrict__ x, const T* __restrict__ dy,
              float* __restrict__ out, int c, int h, int w, int k_total,
              int k_chunk) {
  __shared__ float a_tile[kBK][kBM + 1];
  __shared__ float b_tile[kBK][kBN + 1];

  const int m_total = c, n_total = 9 * c, hw = h * w;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k_total, k_begin + k_chunk);

  // Loads: lane lk of each warp takes one k of the step (neighbouring
  // lanes read neighbouring pixels), rows lr, lr + 8, ... of the tiles.
  const int lk = tid % kBK, lr = tid / kBK;

  // Per loaded B column: channel offset and tap shift, fixed over K.
  int x_off[kLoads], dr[kLoads], dc[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int n = n0 + lr + kRowsPerPass * j;
    const int ch = n / 9, tap = n - 9 * (n / 9);
    x_off[j] = n < n_total ? ch * hw : -1;
    dr[j] = tap / 3 - 1;
    dc[j] = tap % 3 - 1;
  }

  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[q][p] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int k = k0 + lk;
    const bool k_in = k < k_end;
    int b = 0, y = 0, xx = 0;
    if (k_in) {
      b = k / hw;
      const int pix = k - b * hw;
      y = pix / w;
      xx = pix - y * w;
    }
    const int sample = b * c * hw;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int m = m0 + lr + kRowsPerPass * j;
      a_tile[lk][lr + kRowsPerPass * j] =
          (k_in && m < m_total) ? to_f32(dy[sample + m * hw + y * w + xx])
                                : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int ys = y + dr[j], xs = xx + dc[j];
      const bool ok = k_in && x_off[j] >= 0 && ys >= 0 && ys < h &&
                      xs >= 0 && xs < w;
      b_tile[lk][lr + kRowsPerPass * j] =
          ok ? to_f32(x[sample + x_off[j] + ys * w + xs]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) av[q] = a_tile[kk][ty + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p) bv[p] = b_tile[kk][tx + 16 * p];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(av[q], bv[p], acc[q][p]);
    }
    __syncthreads();
  }

  float* tile = out + static_cast<size_t>(blockIdx.z) * m_total * n_total;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + ty + 16 * q;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int n = n0 + tx + 16 * p;
      if (m < m_total && n < n_total) tile[m * n_total + n] = acc[q][p];
    }
  }
}

// out[e] = sum over slices s = 0, 1, ... of ws[s][e], in that order.
__global__ void __launch_bounds__(kReduceThreads)
wgrad_reduce(const float* __restrict__ ws, float* __restrict__ out, int size,
             int slices) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= size) return;
  float sum = ws[e];
  for (int s = 1; s < slices; ++s)
    sum += ws[static_cast<size_t>(s) * size + e];
  out[e] = sum;
}

template <typename T>
int launch(const void* x, const void* dy, void* out, void* ws, int b, int c,
           int h, int w, int k_chunk, int slices, cudaStream_t stream) {
  const int k_total = b * h * w;
  const int n_total = 9 * c;
  const dim3 grid((n_total + kBN - 1) / kBN, (c + kBM - 1) / kBM, slices);
  float* partial = slices == 1 ? static_cast<float*>(out)
                               : static_cast<float*>(ws);
  wgrad_partial<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partial, c, h, w,
      k_total, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const int size = c * n_total;
  wgrad_reduce<<<(size + kReduceThreads - 1) / kReduceThreads,
                 kReduceThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), size, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, dy: (b, c, h, w) contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); out: (c, c, 3, 3) float32; ws: (slices, c, 9c) float32
// scratch (unused when slices == 1).  Each of the `slices` blocks along z
// takes k_chunk of the b*h*w pixels (a multiple of 32).  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int fhpe_conv3x3_wgrad(const void* x, const void* dy, void* out, void* ws,
                       int b, int c, int h, int w, int is_bf16, int k_chunk,
                       int slices, void* stream) {
  if (b <= 0 || c <= 0 || h <= 0 || w <= 0 || slices <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, dy, out, ws, b, c, h, w, k_chunk,
                                         slices, s)
                 : launch<float>(x, dy, out, ws, b, c, h, w, k_chunk, slices,
                                 s);
}

}  // extern "C"
