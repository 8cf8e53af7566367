// The bfloat16 mainloop of a 3x3, stride-1, pad-1 convolution with C input
// and C output channels, NCHW, on Hopper's tensor cores (sm_90a).  Shared
// by conv3x3_fwd.cu (conv3x3_fwd_bf16: the identity instance, which writes
// the sums) and branch_chain.cu (the HRNet branch chain: BN, ReLU, residual
// and batch-statistics epilogues, and a BN + ReLU prologue on its input).
// mainloop() leaves a block's float32 sums in shared memory; the caller's
// epilogue reads them.
//
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
// * The prologue (kPre): each staged x value inside the image becomes
//   relu(round(bn(v))) with the per-channel parameters read through __ldg;
//   the halo and the channels past C stay 0, as the zero padding of the
//   normalized input requires (relu(bn(0)) is not 0).
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
//   and passed as the Plan struct; check_plan only checks it.
// * The sums end in shared memory, [out channel][slot] with a pitch of
//   kOutPitch floats, where an epilogue reads them along pixels.
// * Not done: split-K (C = 512 at 8x6 has 128 blocks of 64 channels by two
//   samples), a 32-row M tile (C = 32 leaves half of each M tile empty),
//   a cp.async ring for the raw NCHW runs, wgmma with TMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_core.cuh"
#include "ptx_mma.cuh"

namespace conv3x3_bf16 {

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

// 0 if `p` tiles a (b, c, h, w) call within the kernel's limits, else
// cudaErrorInvalidValue.
inline int check_plan(const Plan& p, int b, int h, int w) {
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

// 1 if the weights load as 16-byte vectors (C % 8 == 0, 16-byte aligned).
inline int vector_weights(const void* weight, int c) {
  return c % 8 == 0 && reinterpret_cast<uintptr_t>(weight) % 16 == 0;
}

// A block's tile: output channels m0 .., the tile's first sample and its
// top-left pixel.  Grid: (plan.tiles, ceil(C / kTileM)).
struct Tile {
  int m0, b0, y0, x0;
};

__device__ __forceinline__ Tile tile_of(const Plan& p) {
  int t = blockIdx.x;
  const int cc = t % p.col_tiles;
  t /= p.col_tiles;
  return {static_cast<int>(blockIdx.y) * kTileM, (t / p.bands) * p.samples,
          (t % p.bands) * p.rows, cc * p.cols};
}

// The NCHW offset of slot n's output pixel (its sample, channel 0, y, x),
// or -1 where the slot lies past the tile's pixels or outside the image
// (bottom band, last column tile, past the last sample).
__device__ __forceinline__ int slot_offset(const Plan& p, const Tile& t,
                                           int n, int b, int c, int h,
                                           int w) {
  const int tile_px = p.rows * p.cols;
  if (n >= p.samples * tile_px) return -1;
  const int s = n / tile_px, r = n - s * tile_px, py = r / p.cols;
  const int bb = t.b0 + s, yy = t.y0 + py, xx = t.x0 + (r - py * p.cols);
  if (bb >= b || yy >= h || xx >= w) return -1;
  return bb * c * h * w + yy * w + xx;
}

// relu(round(bn(v))) of channel ch: the branch chain's conv2 prologue.
__device__ __forceinline__ bf16 pre_bn_relu(bf16 v, const conv3x3::Bn& pre,
                                            int ch) {
  using namespace conv3x3;
  return from_f32<bf16>(relu(round_to<bf16>(
      bn(to_f32(v), __ldg(pre.mean + ch), __ldg(pre.inv + ch),
         __ldg(pre.gamma + ch), __ldg(pre.beta + ch)))));
}

// conv3x3(x, weight)[t.m0 .. t.m0 + 64, the tile's slots] in float32 into
// shared memory, [out channel][slot] with pitch kOutPitch, which every
// thread may read when this returns (it returns the staged sums).
// `smem_raw` is the block's p.smem bytes of dynamic shared memory.  kPre:
// each staged x value inside the image goes through pre_bn_relu with
// `pre` (unused otherwise).
template <bool kPre>
__device__ __forceinline__ const float* mainloop(
    const bf16* __restrict__ x, const bf16* __restrict__ weight, int b,
    int c, int h, int w, const Plan& p, const Tile& t, int vec_w,
    const conv3x3::Bn& pre, unsigned char* smem_raw) {
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);               // [9][64][40]
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + kWeightBytes);  // [P][40]
  int* pix = reinterpret_cast<int*>(xs + p.patch * kPitch);   // [P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int hw = h * w;
  const int sample_patch = (p.rows + 2) * p.patch_w;
  const int tile_px = p.rows * p.cols, n_valid = p.samples * tile_px;

  // Each patch pixel's offset in x (sample, channel 0, y, x), -1 outside.
  for (int q = tid; q < p.patch; q += kThreads) {
    const int s = q / sample_patch, r = q - s * sample_patch;
    const int row = r / p.patch_w;
    const int yy = t.y0 - 1 + row, xx = t.x0 - 1 + (r - row * p.patch_w);
    const int bb = t.b0 + s;
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
    const int o = t.m0 + o_l, ch0 = c0 + 8 * gq;
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
            if (ch + k < c) {
              bf16 e = x[off + (ch + k) * hw];
              if (kPre) e = pre_bn_relu(e, pre, ch + k);
              v[k >> 1] |= bf16_bits(e) << (16 * (k & 1));
            }
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

  // Stage the accumulators (fragment rows g, g + 8, columns 2 t4, +1).
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
  return out_s;
}

}  // namespace conv3x3_bf16
