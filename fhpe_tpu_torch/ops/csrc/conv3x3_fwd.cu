// A 3x3, stride-1, pad-1 convolution without bias, C channels in and out,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the conv probes P1-P3, which all compute
// y = conv3x3_same(x, W) with float32 sums and differ only in how they lay
// the product out for the TPU's matrix unit and in the output type:
//   P1  scripts/probe/pallas_conv_probe.py::_kernel_a (full im2col) and
//       ::_kernel_b (overlapped 4-column groups), float32 out;
//   P2  scripts/probe/pc_test.py::_kernel (9 accumulated tap matmuls),
//       bfloat16 out;
//   P3  scripts/probe/pallas_conv_probe2.py::_kernel_c (9 tap matmuls),
//       ::_kernel_a2 (lane-concatenated im2col), ::_kernel_b2 (overlapped
//       groups, lane-packed), bfloat16 out.
// Here x is NCHW and W is torch's OIHW (C, C, 3, 3), both bfloat16 or both
// float32; each output is its float32 sum rounded once to the output type:
// bfloat16 or float32 for bfloat16 inputs (P2/P3 and P1), float32 for
// float32 inputs.  The plain version is fhpe_tpu_torch/ops/conv3x3_fwd.py::
// conv3x3_fwd_plain.
//
// What bounds it: a (C) x (B*H*W) x (9C) matrix product, 18 C^2 operations
// per pixel against 4 C bytes in and out (bf16), 4.5 C operations per byte:
// above the H100's ~295 bf16 operations per byte of HBM from C = 66 on, the
// tensor cores bound it; below, the bytes.  PoseResNet-50's four 3x3 shapes
// at batch 32 are 7.25 GFLOP each: (32, 64, 64x48) 0.0075 ms (bytes),
// (32, 128, 32x24), (32, 256, 16x12) and (32, 512, 8x6) 0.0073 ms
// (operations); the 13 calls of a train step 0.095 ms.
//
// bfloat16 (conv3x3_fwd_bf16): an implicit GEMM on the tensor cores, the
// mainloop of conv3x3_bf16.cuh (mma.sync on each chunk of 32 input
// channels of a tile's x patch, staged pixel-major once for all nine taps;
// the tile plan from ops/conv3x3_fwd.py::bf16_plan), whose design notes
// are there.  This file is its identity instance: the epilogue rounds each
// float32 sum once and writes it along pixels, coalesced.
//
// float32 (same_conv3x3_fwd, unchanged since its port): the implicit GEMM
// of conv3x3_core.cuh, one 64 x 64 output tile per block of 128 threads,
// float32 on the CUDA cores; the float32 parity bars rest on float32 sums.
//
// No atomics, no split K: each output is one float32 sum in a fixed order,
// so two runs give the same bits.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8; tools/profile_conv.py prints it):
// each conv3x3_fwd_bf16 entry 128 registers, a 56-byte stack frame, 68
// bytes of spill stores and loads, no static shared memory (dynamic:
// 57,840-61,200 bytes at RN-50's shapes, ops/conv3x3_fwd.py::plan_smem);
// same_conv3x3_fwd 115 registers, 17,408 bytes of shared memory, no
// spills.  SASS: 144 HMMA (9 taps x 2 k-steps x 8 mma.sync) in each
// conv3x3_fwd_bf16 entry, none in the float32 one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "conv3x3_bf16.cuh"
#include "conv3x3_core.cuh"

namespace {

// -- float32 on the CUDA cores (conv3x3_core.cuh) ---------------------------

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(conv3x3::kThreads)
same_conv3x3_fwd(const Tin* __restrict__ x, const Tin* __restrict__ weight,
                 Tout* __restrict__ y, int b, int c, int h, int w) {
  using namespace conv3x3;
  __shared__ __align__(128) unsigned char smem[Smem<Tin>::kBytes];
  const float* cs = reinterpret_cast<const float*>(smem);
  const int hw = h * w, n_total = b * hw;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const Pixel px = tile_pixel(n0, c, h, w, n_total, threadIdx.x);

  conv_tile<Tin, false>(x, weight, Bn{}, c, h, w, m0, px, smem);
  if (!px.ok) return;
#pragma unroll 4
  for (int j = 0; j < kBM / 2; ++j) {
    const int r = px.lk + 2 * j, o = m0 + r;
    if (o >= c) break;
    y[px.off + o * hw] = from_f32<Tout>(cs[r * kLdc + px.ln]);
  }
}

int launch_f32(const void* x, const void* weight, void* y, int b, int c,
               int h, int w, cudaStream_t stream) {
  using conv3x3::kBM;
  using conv3x3::kBN;
  const dim3 grid((b * h * w + kBN - 1) / kBN, (c + kBM - 1) / kBM);
  same_conv3x3_fwd<float, float><<<grid, conv3x3::kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(weight),
      static_cast<float*>(y), b, c, h, w);
  return static_cast<int>(cudaGetLastError());
}

// -- bfloat16 on the tensor cores -------------------------------------------

using namespace conv3x3_bf16;

// y[:, m0 .. m0 + 64) on the pixels of tile blockIdx.x, m0 = 64 blockIdx.y.
// vec_w: the weights load as 16-byte vectors (C % 8 == 0, 16-byte aligned).
template <typename Tout>
__global__ void __launch_bounds__(kThreads, 2)   // two blocks per SM
conv3x3_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ weight,
                 Tout* __restrict__ y, int b, int c, int h, int w, Plan p,
                 int vec_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = tile_of(p);
  const float* out_s = mainloop<false>(x, weight, b, c, h, w, p, t, vec_w,
                                       conv3x3::Bn{}, smem_raw);
  // Each output once, neighbouring threads on neighbouring pixels.  The
  // slot -> pixel map is slot_offset's, written out term by term: so
  // written, this kernel compiles to the same SASS as before its mainloop
  // moved into conv3x3_bf16.cuh (tools/sass_diff.py).
  const int tid = threadIdx.x, hw = h * w;
  const int tile_px = p.rows * p.cols, n_valid = p.samples * tile_px;
  const int n = tid & (kSlots - 1);
  if (n >= n_valid) return;
  const int s = n / tile_px, r = n - s * tile_px, py = r / p.cols;
  const int bb = t.b0 + s, yy = t.y0 + py, xx = t.x0 + (r - py * p.cols);
  if (bb >= b || yy >= h || xx >= w) return;
  Tout* dst = y + bb * c * hw + yy * w + xx;
#pragma unroll 4
  for (int o = tid >> 7; o < kTileM; o += kThreads / kSlots) {
    if (t.m0 + o >= c) break;
    dst[(t.m0 + o) * hw] = conv3x3::from_f32<Tout>(out_s[o * kOutPitch + n]);
  }
}

template <typename Tout>
int launch_bf16(const void* x, const void* weight, void* y, int b, int c,
                int h, int w, const int* plan, cudaStream_t stream) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (int err = check_plan(p, b, h, w)) return err;
  const int vec_w = vector_weights(weight, c);
  auto kernel = conv3x3_fwd_bf16<Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.tiles, (c + kTileM - 1) / kTileM);
  kernel<<<grid, kThreads, p.smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(weight),
      static_cast<Tout*>(y), b, c, h, w, p, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (b, c, h, w) and weight (c, c, 3, 3) contiguous, float32 (in_bf16 = 0)
// or bfloat16 (in_bf16 = 1); y (b, c, h, w) contiguous, bfloat16
// (out_bf16 = 1, bfloat16 inputs only) or float32.  bfloat16 inputs take
// `plan`, the Plan's kPlanInts ints (ops/conv3x3_fwd.py::bf16_plan);
// float32 inputs ignore it.  Launches on `stream`; returns the CUDA error
// of the launch (0 = launched).
int fhpe_conv3x3_fwd(const void* x, const void* weight, void* y, int b, int c,
                     int h, int w, int in_bf16, int out_bf16, const int* plan,
                     void* stream) {
  if (b <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!in_bf16)
    return out_bf16 ? static_cast<int>(cudaErrorInvalidValue)
                    : launch_f32(x, weight, y, b, c, h, w, s);
  return out_bf16 ? launch_bf16<bf16>(x, weight, y, b, c, h, w, plan, s)
                  : launch_bf16<float>(x, weight, y, b, c, h, w, plan, s);
}

}  // extern "C"
