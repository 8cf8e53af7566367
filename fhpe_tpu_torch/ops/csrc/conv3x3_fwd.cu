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
// bfloat16 (conv3x3_fwd_bf16): an implicit GEMM on the tensor cores.
// * mma.sync m16n8k16 bf16 -> float32 accumulators in registers.  A block
//   of 8 warps owns 64 output channels (M) by 128 pixel slots (N); each
//   warp 32 x 32.  K runs over chunks of 32 input channels, and inside a
//   chunk in (tap, channel) order.
// * The layout trap: for row.col each 32-bit B register holds two
//   consecutive k at one pixel, and in NCHW two channels at one pixel lie
//   H*W apart.  Fix: each chunk of x is staged in shared memory
//   pixel-major, [pixel][channel] with a channel pitch of 40 (80 bytes, so
//   the eight rows of an ldmatrix fall on distinct banks), over the tile's
//   patch with its one-pixel halo (zero outside the image).  A tap is then
//   a row offset of dr * (cols + 2) + dc pixels, every row address stays
//   16-byte aligned, and ldmatrix reads all nine taps from the one staged
//   patch: x enters shared memory once per chunk, not once per tap.  The
//   transpose from NCHW happens in the staging: each thread loads 8
//   channels of one patch pixel (neighbouring lanes, neighbouring pixels)
//   and stores them as one 16-byte vector.
// * The weights (A) in the same K order: each thread loads the 72
//   contiguous OIHW values of 8 channels x 9 taps of one output channel
//   (nine 16-byte loads where C % 8 == 0, else element by element),
//   transposes them in registers (byte permutes) and stores 9 vectors into
//   [tap][out channel][channel]; ldmatrix reads A.  No separate repack
//   launch.
// * The next chunk's loads are in flight in registers while the current
//   chunk's 9 taps x 2 k-steps x 8 MMAs per warp run (two barriers per
//   chunk).
// * Each chunk's sums run on the tensor cores into fresh accumulators,
//   added to the running sum in float32 once per chunk: over all of K the
//   tensor cores' own accumulation lost up to 9.8e-6 of max|y| at
//   C = 1024 against a float64 sum (the plain float32 version 3.3e-7),
//   per chunk 3.5e-7.  The second set of accumulators takes the kernel to
//   ptxas's 128-register cap for two blocks per SM (a few bytes spilled),
//   4% slower over RN-50's 13 calls; fetching the weights through a
//   per-thread cp.async buffer instead of registers was slower still.
// * Tiles: a tile is `rows` x `cols` pixels of `samples` consecutive
//   samples (more than one only where a tile holds whole images), at most
//   128 slots and a patch of at most 256 pixels.  The plan is computed
//   once, on the host (ops/conv3x3_fwd.py::bf16_plan, cached per shape),
//   and passed as the Plan struct; this file only checks it.
// * Epilogue: the float32 accumulators go through shared memory; each
//   output is rounded once and written along pixels, coalesced.
// * Not done: split-K (RN-50's smallest grid, C = 512 at 8x6, has 128
//   blocks of 64 channels by two samples), a cp.async ring for the raw
//   NCHW runs (rung B), wgmma with TMA.
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

using bf16 = __nv_bfloat16;

constexpr int kTileM = 64;      // output channels of a block
constexpr int kSlots = 128;     // pixel slots of a block (N)
constexpr int kChunk = 32;      // input channels per staged chunk
constexpr int kPitch = 40;      // bf16 per staged pixel / weight row
constexpr int kMaxPatch = 256;  // most patch pixels (halo included)
constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kOutPitch = 136;  // floats per staged output row
constexpr int kWeightBytes = 9 * kTileM * kPitch * 2;
constexpr int kXUnits = 4 * kMaxPatch / kThreads;  // x vectors per thread

static_assert(kThreads == kTileM * (kChunk / 8), "one weight unit each");
static_assert(kTileM * kOutPitch * 4 <= kWeightBytes,
              "the output tile aliases the staged weights");

// One call's tiling, computed on the host only (ops/conv3x3_fwd.py::
// bf16_plan, whose Bf16Plan has these fields in this order): a tile is
// `rows` x `cols` pixels of `samples` samples; its patch is `patch`
// pixels, `samples` x (rows + 2) rows of `patch_w` = cols + 2; `bands` x
// `col_tiles` tiles cover a sample and `tiles` cover the batch; `smem` is
// a block's dynamic shared memory (the weights, the patch, its pixel
// table).
struct Plan {
  int samples, rows, cols, patch_w, patch, bands, col_tiles, tiles, smem;
};
constexpr int kPlanInts = 9;
static_assert(sizeof(Plan) == kPlanInts * sizeof(int),
              "Plan is the host's ints, unpadded");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(bf16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

// y[:, m0 .. m0 + 64) on the pixels of tile blockIdx.x, m0 = 64 blockIdx.y.
// vec_w: the weights load as 16-byte vectors (C % 8 == 0, 16-byte aligned).
template <typename Tout>
__global__ void __launch_bounds__(kThreads, 2)   // two blocks per SM
conv3x3_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ weight,
                 Tout* __restrict__ y, int b, int c, int h, int w, Plan p,
                 int vec_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);               // [9][64][40]
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + kWeightBytes);  // [P][40]
  int* pix = reinterpret_cast<int*>(xs + p.patch * kPitch);   // [P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int hw = h * w;
  const int m0 = blockIdx.y * kTileM;
  int t = blockIdx.x;
  const int cc = t % p.col_tiles;
  t /= p.col_tiles;
  const int y0 = (t % p.bands) * p.rows, x0 = cc * p.cols;
  const int b0 = (t / p.bands) * p.samples;
  const int sample_patch = (p.rows + 2) * p.patch_w;
  const int tile_px = p.rows * p.cols, n_valid = p.samples * tile_px;

  // Each patch pixel's offset in x (sample, channel 0, y, x), -1 outside.
  for (int q = tid; q < p.patch; q += kThreads) {
    const int s = q / sample_patch, r = q - s * sample_patch;
    const int row = r / p.patch_w;
    const int yy = y0 - 1 + row, xx = x0 - 1 + (r - row * p.patch_w);
    const int bb = b0 + s;
    pix[q] = (bb < b && yy >= 0 && yy < h && xx >= 0 && xx < w)
                 ? bb * c * hw + yy * w + xx
                 : -1;
  }

  // ldmatrix row addresses.  A: rows wm*32 + (lane & 15), k half lane >> 4.
  // B (two n8 tiles per x4): slot wn*32 + 16 jj + 8 (lane >> 4) + (lane & 7),
  // k half (lane >> 3) & 1; a slot past the tile reads patch pixel 0.
  const unsigned a_base =
      smem_addr(ws + (wm * 32 + (lane & 15)) * kPitch + (lane >> 4) * 8);
  unsigned b_base[2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int n = wn * 32 + jj * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
    int pos = 0;
    if (n < n_valid) {
      const int s = n / tile_px, r = n - s * tile_px;
      const int py = r / p.cols;
      pos = s * sample_patch + py * p.patch_w + (r - py * p.cols);
    }
    b_base[jj] = smem_addr(xs + pos * kPitch + ((lane >> 3) & 1) * 8);
  }

  // Staging registers: the weight unit (output channel o_l, channels
  // 8 gq .. 8 gq + 7, all nine taps: 72 OIHW values, value e at channel
  // e / 9, tap e % 9) and up to kXUnits x units (8 channels of one patch
  // pixel).
  const int o_l = tid >> 2, gq = tid & 3;
  uint32_t wr[36];
  uint4 xr[kXUnits];

  auto load = [&](int c0) {
    const int o = m0 + o_l, ch0 = c0 + 8 * gq;
    const bool ok = o < c && ch0 < c;
    const bf16* src = weight + (static_cast<size_t>(o) * c + ch0) * 9;
    if (vec_w) {
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(src) + j)
                           : make_uint4(0u, 0u, 0u, 0u);
        wr[4 * j] = v.x;
        wr[4 * j + 1] = v.y;
        wr[4 * j + 2] = v.z;
        wr[4 * j + 3] = v.w;
      }
    } else {
      const int n_ch = ok ? min(8, c - ch0) : 0;
#pragma unroll
      for (int k = 0; k < 36; ++k) {
        const int e0 = 2 * k, e1 = 2 * k + 1;
        const uint32_t lo = e0 / 9 < n_ch ? bf16_bits(src[e0]) : 0u;
        const uint32_t hi = e1 / 9 < n_ch ? bf16_bits(src[e1]) : 0u;
        wr[k] = lo | (hi << 16);
      }
    }
#pragma unroll
    for (int j = 0; j < kXUnits; ++j) {
      const int u = tid + kThreads * j;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (u < 4 * p.patch) {
        const int g = u / p.patch, q = u - g * p.patch;
        const int off = pix[q], ch = c0 + 8 * g;
        if (off >= 0) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (ch + k < c)
              v[k >> 1] |= bf16_bits(x[off + (ch + k) * hw]) << (16 * (k & 1));
        }
      }
      xr[j] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // channels 2k and 2k + 1 of this tap: values (2k) 9 + tap and
        // (2k + 1) 9 + tap of the unit
        const int e0 = 2 * k * 9 + tap, e1 = e0 + 9;
        v[k] = __byte_perm(wr[e0 >> 1], wr[e1 >> 1],
                           ((e0 & 1) ? 0x0032 : 0x0010) |
                               ((e1 & 1) ? 0x7600 : 0x5400));
      }
      *reinterpret_cast<uint4*>(ws + (tap * kTileM + o_l) * kPitch + 8 * gq) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int j = 0; j < kXUnits; ++j) {
      const int u = tid + kThreads * j;
      if (u < 4 * p.patch) {
        const int g = u / p.patch, q = u - g * p.patch;
        *reinterpret_cast<uint4*>(xs + q * kPitch + 8 * g) = xr[j];
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  float part[2][4][4];   // this chunk's sums
  auto compute = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const unsigned shift =
          ((tap / 3) * p.patch_w + tap % 3) * kPitch * 2;  // bytes
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[2][4], bfr[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(a[i], a_base + ((tap * kTileM + i * 16) * kPitch +
                                      ks * 16) * 2);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          ldmatrix_x4(bfr[jj], b_base[jj] + shift + ks * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(part[i][j], a[i], bfr[j >> 1][2 * (j & 1)],
                     bfr[j >> 1][2 * (j & 1) + 1]);
      }
    }
  };

  __syncthreads();  // the pixel table
  load(0);
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    if (c0) __syncthreads();  // the last chunk's MMAs are done
    store();
    __syncthreads();
    if (c0 + kChunk < c) load(c0 + kChunk);  // in flight during the MMAs
    compute();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  }
  __syncthreads();

  // Stage the accumulators (fragment rows g, g + 8, columns 2 t4, +1),
  // then write each output once, neighbouring threads on neighbouring
  // pixels.
  float* out_s = reinterpret_cast<float*>(smem_raw);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm * 32 + i * 16 + g, n = wn * 32 + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(out_s + r * kOutPitch + n) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out_s + (r + 8) * kOutPitch + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  const int n = tid & (kSlots - 1);
  if (n >= n_valid) return;
  const int s = n / tile_px, r = n - s * tile_px, py = r / p.cols;
  const int bb = b0 + s, yy = y0 + py, xx = x0 + (r - py * p.cols);
  if (bb >= b || yy >= h || xx >= w) return;
  Tout* dst = y + bb * c * hw + yy * w + xx;
#pragma unroll 4
  for (int o = tid >> 7; o < kTileM; o += kThreads / kSlots) {
    if (m0 + o >= c) break;
    dst[(m0 + o) * hw] = conv3x3::from_f32<Tout>(out_s[o * kOutPitch + n]);
  }
}

int check_plan(const Plan& p, int b, int c, int h, int w) {
  const int patch = p.samples * (p.rows + 2) * p.patch_w;
  const int smem = kWeightBytes + p.patch * (kPitch * 2 + 4);
  const bool ok =
      p.samples >= 1 && p.rows >= 1 && p.cols >= 1 &&
      p.patch_w == p.cols + 2 && p.patch == patch && p.patch <= kMaxPatch &&
      p.samples * p.rows * p.cols <= kSlots &&
      (p.samples == 1 || (p.rows == h && p.cols == w)) &&
      p.bands == (h + p.rows - 1) / p.rows &&
      p.col_tiles == (w + p.cols - 1) / p.cols &&
      p.tiles == (b + p.samples - 1) / p.samples * p.bands * p.col_tiles &&
      p.smem >= smem;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename Tout>
int launch_bf16(const void* x, const void* weight, void* y, int b, int c,
                int h, int w, const int* plan, cudaStream_t stream) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (int err = check_plan(p, b, c, h, w)) return err;
  const int vec_w =
      c % 8 == 0 && reinterpret_cast<uintptr_t>(weight) % 16 == 0;
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
