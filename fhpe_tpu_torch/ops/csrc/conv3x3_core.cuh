// The implicit-GEMM core of a 3x3, stride-1, pad-1 convolution with C input
// and C output channels, NCHW, for Hopper (sm_90a).  Shared by the plain
// conv (conv3x3_fwd.cu) and the HRNet branch chain (branch_chain.cu), which
// add their own epilogues.
//
// One block of kThreads threads computes a kBM x kBN output tile: M = C
// output channels, N = B*H*W pixels, K = 9C (input channel, tap), in OIHW
// order so the weight rows are read as they lie.  It walks K in steps of
// kBK: the weight slice (A) and the shifted input taps (B, gathered with
// the zero border in the loads, im2col on the fly: neighbouring threads read
// neighbouring pixels) are staged in shared memory, the next step's loads in
// flight in registers while the current step computes.  bfloat16 runs on
// the tensor cores (wmma 16x16x16, float32 accumulate, each warp a 32 x 32
// sub-tile); float32 on the CUDA cores (each thread a 4 x 8 sub-tile, fmaf).
// The float32 accumulators end in shared memory (row stride kLdc), where
// the epilogue reads them coalesced along pixels.  Ragged tiles in M, N and
// K are masked, so any B, C, H and W run.  No atomics and no split K: each
// output is one sum in a fixed order, so two runs give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace conv3x3 {

constexpr int kBM = 64;        // output channels per tile
constexpr int kBN = 64;        // pixels per tile
constexpr int kBK = 32;        // K per shared-memory step
constexpr int kThreads = 128;  // 4 warps
constexpr int kLdc = kBN + 4;  // row stride of the float32 epilogue tile
constexpr int kALoads = kBM * kBK / kThreads;  // 16
constexpr int kBLoads = kBK * kBN / kThreads;  // 16

// Shared-memory row strides (elements): wmma wants multiples of 8 for
// 16-bit types; the float32 path pads against bank conflicts.
template <typename T>
struct Tile {
  static constexpr int lda = kBK + 8, ldb = kBN + 8;
};
template <>
struct Tile<float> {
  static constexpr int lda = kBK + 1, ldb = kBN + 4;
};

// Shared memory of one tile: the A and B staging tiles, which the float32
// epilogue tile aliases once the mainloop is done.
template <typename T>
struct Smem {
  static constexpr int kABytes =
      kBM * Tile<T>::lda * static_cast<int>(sizeof(T));
  static constexpr int kBBytes =
      kBK * Tile<T>::ldb * static_cast<int>(sizeof(T));
  static constexpr int kCBytes = kBM * kLdc * static_cast<int>(sizeof(float));
  static constexpr int kBytes =
      kABytes + kBBytes > kCBytes ? kABytes + kBBytes : kCBytes;
  static_assert(kABytes % 32 == 0, "wmma wants 32-byte aligned tiles");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// (v - mean) * inv * gamma + beta, in the plain version's order, no FMA.
__device__ __forceinline__ float bn(float v, float mean, float inv, float g,
                                    float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), inv), g), b);
}

// Per-channel BatchNorm parameters: `inv` if given, else 1/sqrt(var + eps).
struct Bn {
  const float* mean;
  const float* var;
  const float* inv;
  const float* gamma;
  const float* beta;
};

// The mainloop's multiply-accumulate: tensor cores for bfloat16 ...
template <typename T>
struct Accum {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[2][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ void step(const T* as, const T* bs, int tid) {
    using namespace nvcuda;
    constexpr int lda = Tile<T>::lda, ldb = Tile<T>::ldb;
    const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * lda + ks, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + ks * ldb + wn * 32 + j * 16, ldb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  __device__ void store(float* cs, int tid) {
    const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(
            cs + (wm * 32 + i * 16) * kLdc + wn * 32 + j * 16, acc[i][j],
            kLdc, nvcuda::wmma::mem_row_major);
  }
};

// ... and the CUDA cores for float32: thread (tx, ty) owns rows ty + 16q,
// columns tx + 8p of the tile.
template <>
struct Accum<float> {
  float acc[4][8];

  __device__ void zero() {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 8; ++p) acc[q][p] = 0.f;
  }

  __device__ void step(const float* as, const float* bs, int tid) {
    constexpr int lda = Tile<float>::lda, ldb = Tile<float>::ldb;
    const int tx = tid % 8, ty = tid / 8;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) av[q] = as[(ty + 16 * q) * lda + kk];
#pragma unroll
      for (int p = 0; p < 8; ++p) bv[p] = bs[kk * ldb + tx + 8 * p];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 8; ++p) acc[q][p] = fmaf(av[q], bv[p], acc[q][p]);
    }
  }

  __device__ void store(float* cs, int tid) {
    const int tx = tid % 8, ty = tid / 8;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 8; ++p)
        cs[(ty + 16 * q) * kLdc + tx + 8 * p] = acc[q][p];
  }
};

// This thread's output pixel, for the B loads and the epilogue: column ln
// of the tile (pixel n0 + ln), rows lk, lk + 2, ...; `off` is the offset of
// (sample, channel 0, y, x) in NCHW.
struct Pixel {
  int ln, lk, y, x, off;
  bool ok;
};

__device__ __forceinline__ Pixel tile_pixel(int n0, int c, int h, int w,
                                            int n_total, int tid) {
  Pixel p{tid % kBN, tid / kBN, 0, 0, 0, false};
  const int pix = n0 + p.ln, hw = h * w;
  p.ok = pix < n_total;
  if (p.ok) {
    const int pb = pix / hw, rem = pix - pb * hw;
    p.y = rem / w;
    p.x = rem - p.y * w;
    p.off = pb * c * hw + rem;
  }
  return p;
}

// The float32 tile conv3x3(in, weight)[m0 .., pixels n0 ..] into the
// epilogue tile of `smem` (row stride kLdc), which every thread may read
// when this returns.  kPre: each input value goes through
// relu(round(bn(v))) with `pre` in the loads (the branch chain's conv2).
template <typename T, bool kPre>
__device__ __forceinline__ void conv_tile(const T* in, const T* weight,
                                          const Bn& pre, int c, int h, int w,
                                          int m0, const Pixel& px,
                                          unsigned char* smem) {
  constexpr int lda = Tile<T>::lda, ldb = Tile<T>::ldb;
  T* as = reinterpret_cast<T*>(smem);
  T* bs = reinterpret_cast<T*>(smem + Smem<T>::kABytes);
  const int hw = h * w, k_total = 9 * c;
  const int tid = threadIdx.x;
  // A loads: lane la takes one k of the step, rows lr, lr + 4, ...
  const int la = tid % kBK, lr = tid / kBK;

  T a_reg[kALoads], b_reg[kBLoads];
  const T zero = from_f32<T>(0.f);

  auto load_global = [&](int k0) {
    const int ka = k0 + la;
#pragma unroll
    for (int j = 0; j < kALoads; ++j) {
      const int m = m0 + lr + 4 * j;
      a_reg[j] = (m < c && ka < k_total) ? weight[m * k_total + ka] : zero;
    }
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      const int k = k0 + px.lk + 2 * j;
      T val = zero;
      if (px.ok && k < k_total) {
        const int ch = k / 9, tap = k - 9 * ch;
        const int dr = tap / 3 - 1, dc = tap - 3 * (tap / 3) - 1;
        const int ys = px.y + dr, xs = px.x + dc;
        if (ys >= 0 && ys < h && xs >= 0 && xs < w) {
          val = in[px.off + ch * hw + dr * w + dc];
          if (kPre)
            val = from_f32<T>(relu(round_to<T>(
                bn(to_f32(val), pre.mean[ch], pre.inv[ch], pre.gamma[ch],
                   pre.beta[ch]))));
        }
      }
      b_reg[j] = val;
    }
  };
  auto store_smem = [&]() {
#pragma unroll
    for (int j = 0; j < kALoads; ++j) as[(lr + 4 * j) * lda + la] = a_reg[j];
#pragma unroll
    for (int j = 0; j < kBLoads; ++j)
      bs[(px.lk + 2 * j) * ldb + px.ln] = b_reg[j];
  };

  Accum<T> acc;
  acc.zero();
  load_global(0);
  store_smem();
  __syncthreads();
  for (int k0 = 0; k0 < k_total; k0 += kBK) {
    const bool more = k0 + kBK < k_total;
    if (more) load_global(k0 + kBK);  // in flight while this step computes
    acc.step(as, bs, tid);
    __syncthreads();
    if (more) {
      store_smem();
      __syncthreads();
    }
  }
  acc.store(reinterpret_cast<float*>(smem), tid);
  __syncthreads();
}

}  // namespace conv3x3
