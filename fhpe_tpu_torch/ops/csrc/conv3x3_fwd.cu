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
// tensor cores bound it; below, the bytes.  PoseResNet's 3x3 convs run at
// C = 64 ... 512.
//
// Design (simple and right first; wgmma and TMA are later work): the
// implicit GEMM of conv3x3_core.cuh, one 64 x 64 output tile per block of
// 128 threads, bfloat16 on the tensor cores through wmma, float32 on the
// CUDA cores; the epilogue rounds each float32 sum once and writes it
// coalesced along pixels.  No atomics, no split K: two runs give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3x3_core.cuh"

namespace {

using namespace conv3x3;

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
same_conv3x3_fwd(const Tin* __restrict__ x, const Tin* __restrict__ weight,
                 Tout* __restrict__ y, int b, int c, int h, int w) {
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

template <typename Tin, typename Tout>
int launch(const void* x, const void* weight, void* y, int b, int c, int h,
           int w, cudaStream_t stream) {
  const dim3 grid((b * h * w + kBN - 1) / kBN, (c + kBM - 1) / kBM);
  same_conv3x3_fwd<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(weight),
      static_cast<Tout*>(y), b, c, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (b, c, h, w) and weight (c, c, 3, 3) contiguous, float32 (in_bf16 = 0)
// or bfloat16 (in_bf16 = 1); y (b, c, h, w) contiguous, bfloat16
// (out_bf16 = 1, bfloat16 inputs only) or float32.  Launches on `stream`;
// returns the CUDA error of the launch (0 = launched).
int fhpe_conv3x3_fwd(const void* x, const void* weight, void* y, int b, int c,
                     int h, int w, int in_bf16, int out_bf16, void* stream) {
  if (b <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!in_bf16)
    return out_bf16 ? static_cast<int>(cudaErrorInvalidValue)
                    : launch<float, float>(x, weight, y, b, c, h, w, s);
  return out_bf16
             ? launch<__nv_bfloat16, __nv_bfloat16>(x, weight, y, b, c, h, w,
                                                    s)
             : launch<__nv_bfloat16, float>(x, weight, y, b, c, h, w, s);
}

}  // extern "C"
