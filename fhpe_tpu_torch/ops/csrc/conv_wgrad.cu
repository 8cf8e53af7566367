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
// conv_wgrad.py::conv3x3_wgrad_plain) only in the order of the sums and,
// on the tensor cores, in their own float32 accumulation.
//
// What bounds it: dW is a (C) x (9C) matrix product over K = B*H*W,
// 2 * 9 * C * C * K operations on 2 * B*C*H*W inputs: 4.5 * C operations
// per bf16 byte against the ~295 an H100 needs at its bf16 tensor-core
// peak, so the bytes bound it at C <= 64 and the operations above.  At
// batch 32 on the main path's steps: the hourglass step's 59 shapes are
// 144.8 GFLOP (0.146 ms at the bf16 peak), the HRNet W48 -> W32 step's 212
// are 405.5 GFLOP (0.41 ms), PoseResNet-50's 13 are 94.2 GFLOP (0.095 ms).
//
// bfloat16 (wgrad_bf16): a split-K GEMM on the tensor cores.
// * mma.sync m16n8k16 bf16 -> float32 accumulators in registers.  A block
//   owns 32 or 64 output channels (C <= 32: 32, so the hourglass stem and
//   HRNet branch 0 leave no half-empty tile) by 32 input channels with all
//   nine taps, 288 columns: the (tap, input channel) side is the wide one.
//   Each warp takes 32 output channels by 8 input channels x 9 taps.
// * A K tile is a patch of one sample: `rows` image rows by `cols` columns
//   (at most 128).  x's patch with a one-pixel halo enters shared memory
//   once per K tile, and all nine taps read it as shifted views: x is
//   fetched once per tile, not once per tap as im2col would.  The sample,
//   row and column of a tile are computed once per tile, and the pixel ->
//   shared-memory offset of each pixel pair once per kernel (a table).
// * The layout trap: in NCHW both operands run along pixels (K), which
//   suits row.col, but a tap's column shift of one pixel moves x by 2
//   bytes, off the 4-byte alignment of a bf16 pair.  Fix: each thread
//   assembles its shifted B fragments from three aligned 32-bit loads per
//   row (pixels w-2..w+3) with two byte permutes, so one 3 x 4 pixel
//   neighbourhood gives all nine taps of a pixel pair.  dy (A) is
//   K-contiguous and goes through ldmatrix.
// * Loads: cp.async into a ring of kStages (3) buffers, commit / wait
//   groups, so the loads of tiles k+1 and k+2 overlap the MMAs on tile k;
//   src-size 0 zero-fills the border and the ragged edges.  Where a tile
//   is whole rows of an image with even W (every shape of the train
//   steps), each channel's rows are one contiguous run and load as 16-byte
//   copies, and the column border is masked in the fragments.  Otherwise
//   (odd W, W > 128, H*W not a multiple of 8, misaligned pointers) the
//   rows are staged with explicit halo columns, register-staged.
// * Split-K over the K tiles (ops/conv_wgrad.py::bf16_plan: one wave of
//   at most two blocks per SM) with a workspace of one partial per slice.
//   Each warp stages its accumulators in shared memory and writes whole
//   rows of dW's OIHW layout; a second launch sums the partials in slice
//   order, 16 loads in flight per thread.  No atomics: two runs give the
//   same bits.
// * Not done: wgmma with TMA.  TMA would give the zero border for free and
//   free the threads that issue cp.async, but needs 16-byte global
//   strides, which rows of W = 6, 12, 4 lack; a flat (B, C, H*W) view has
//   them but wraps the column border, which would still be masked.
//
// float32 (wgrad_partial, unchanged since its port): an implicit GEMM on
// the CUDA cores in float32.  The float32 train-step parity bars rest on
// float32 sums, which TF32 tensor cores would break.  M = C output
// channels, N = 9C (input channel, tap) columns, K = B*H*W.  A block owns a
// 64 x 64 tile of dW and one slice of K (split-K).  Each step it stages a
// 32-deep slice of dy (A) and of the shifted x taps (B, gathered with the
// zero border, im2col on the fly) in shared memory as float32, and each of
// its 256 threads accumulates a 4 x 4 sub-tile in registers.  A second
// launch sums the partial tiles in slice order.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): the wgrad_bf16 entries 120-121
// registers with runs, 125 with halo columns, no spills, no static shared
// memory (the ring is dynamic: 20-113 KB per block on the train steps'
// shapes, ops/conv_wgrad.py::bf16_geometry); wgrad_partial 64 registers,
// 16,640 bytes of shared memory, no spills; wgrad_reduce 32 registers.
// SASS: 18 HMMA (2 x 9 mma.sync) in the k loop of each wgrad_bf16 entry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// out[e] = sum over slices s = 0, 1, ... of ws[s][e], in that order; the
// loads are issued kBatch at a time so their latencies overlap.
constexpr int kBatch = 16;

__global__ void __launch_bounds__(kReduceThreads)
wgrad_reduce(const float* __restrict__ ws, float* __restrict__ out, int size,
             int slices) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= size) return;
  float sum = ws[e];
  int s = 1;
  for (; s + kBatch <= slices; s += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      v[j] = ws[static_cast<size_t>(s + j) * size + e];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) sum += v[j];
  }
  for (; s < slices; ++s) sum += ws[static_cast<size_t>(s) * size + e];
  out[e] = sum;
}

// -- bfloat16 on the tensor cores ----------------------------------------

constexpr int kCi = 32;          // input channels of a block tile (x 9 taps)
constexpr int kWarpsN = kCi / 8;  // each warp: 8 input channels x 9 taps
constexpr int kStages = 3;       // cp.async ring

// The shared-memory layout of one call, computed on the host only
// (ops/conv_wgrad.py::bf16_geometry, whose Bf16Geometry has these fields in
// this order) and taken as given here.  A K tile is `rows` x `cols` pixels
// of one sample; pixel k of the tile is (k / cwp, k % cwp), so a pixel pair
// never straddles a row.  Per stage (`stage` bf16 values): the dy tile
// (tile_m rows of kpad pixels, pitch dy_pitch), then kCi x planes (pitch
// x_pitch) of x rows y0 - 1 ...  Row pitches are odd multiples of 4 words,
// so eight rows read together (ldmatrix, or one x plane per lane group)
// fall in eight different groups of 4 banks.  Two layouts of the x planes:
// * runs (whole rows of an image whose W is even and whose rows
//   start 16 bytes apart in every tile): a plane is the contiguous run of
//   x_run 16-byte chunks from (y0 - 1) W rounded down to a multiple of 8,
//   after kFront elements, so both operands load as 16-byte copies and the
//   column border is masked in the fragments;
// * halo columns (any shape): rows of row_pitch = lpad (2) halo columns,
//   cwp columns, lpad halo columns, holding the real neighbours or the zero
//   border, so no fragment needs a mask; loaded element by element,
//   register-staged.
// `smem` is a block's dynamic shared memory: the ring and the pair table,
// or the staged output rows (8 rows of kOutPitch floats per warp).
constexpr int kFront = 8;
constexpr int kOutPitch = 73;    // floats per staged output row (72 + 1)

struct Geometry {
  int rows, cols, cwp, kpad, lpad, row_pitch;
  int dy_rows, dy_pitch, x_rows, x_pitch, x_run, stage, bands, col_tiles;
  int smem;
};
constexpr int kGeometryInts = 15;
static_assert(sizeof(Geometry) == kGeometryInts * sizeof(int),
              "Geometry is the host's ints, unpadded");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory through cp.async; src-size 0
// writes zeros.
__device__ __forceinline__ void copy16(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
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

// The (row, chunk) pairs idx = start, start + step, ... of a grid of rows
// of n chunks, without a division per step.
struct Walk {
  int chunk, row, d_chunk, d_row, n;
  __device__ Walk(int start, int step, int n_)
      : chunk(start % n_), row(start / n_), d_chunk(step % n_),
        d_row(step / n_), n(n_) {}
  __device__ void next() {
    chunk += d_chunk;
    row += d_row;
    if (chunk >= n) {
      chunk -= n;
      ++row;
    }
  }
};

// Partial dW of slice blockIdx.z (K tiles [z * per, (z + 1) * per)) for
// output channels [16 kMi kWarpsM * blockIdx.y, ...) and input channels
// [kCi * blockIdx.x, ...), all nine taps, into out[z] (C x 9C, OIHW).
// kRun: the run layout; else the halo-column layout.
template <int kMi, int kWarpsM, bool kRun>
__global__ void __launch_bounds__(32 * kWarpsM * kWarpsN)
wgrad_bf16(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ dy, float* __restrict__ out,
           int c, int h, int w, Geometry g, int k_tiles, int per) {
  constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  constexpr int kBM = 16 * kMi * kWarpsM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int* pairs = reinterpret_cast<int*>(smem + kStages * g.stage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kBM, i0 = blockIdx.x * kCi;
  const int hw = h * w;

  // Zero the ring once: the K padding multiplies stale x by dy = 0, which
  // must be finite.  Then each pixel pair's offset in an x plane (runs:
  // times 4, plus 1 at the left border and 2 at the right).
  for (int e = tid; e < kStages * g.stage / 2; e += kThreads)
    reinterpret_cast<uint32_t*>(smem)[e] = 0u;
  for (int q = tid; q < g.kpad / 2; q += kThreads) {
    const int k = 2 * q, r = k / g.cwp, col = k - r * g.cwp;
    if constexpr (kRun)
      pairs[q] = (kFront + (r + 1) * g.cwp + col) * 4 + (col == 0) +
                 2 * (col + 2 == g.cwp);
    else
      pairs[q] = (r + 1) * g.row_pitch + g.lpad + col;
  }
  __syncthreads();

  // Runs: where x row y0 - 1 starts in its plane, past kFront.
  auto run_offset = [&](int t) {
    const int start = ((t / g.col_tiles) % g.bands * g.rows - 1) * w;
    return start - (start & ~7);
  };
  // Loads of K tile t into stage s.
  auto load = [&](int t, int s) {
    __nv_bfloat16* dys = smem + s * g.stage;
    __nv_bfloat16* xs = dys + kBM * g.dy_pitch;
    const int cc = t % g.col_tiles, rest = t / g.col_tiles;
    const int band = rest % g.bands, b = rest / g.bands;
    const int y0 = band * g.rows, x0 = cc * g.cols;
    if constexpr (kRun) {
      // dy: per output channel the tile's rows are one run of rows * w
      const int k_valid = min(g.rows * w, hw - y0 * w);
      for (Walk it(tid, kThreads, g.kpad / 8); it.row < kBM; it.next()) {
        const int m = m0 + it.row, k = 8 * it.chunk;
        const bool ok = m < c && k < k_valid;
        copy16(dys + it.row * g.dy_pitch + k,
               ok ? dy + (b * c + m) * hw + y0 * w + k : dy, ok);
      }
      // x: per input channel the run of rows y0 - 1 ... y0 + rows
      const int start = (y0 - 1) * w, p_lo = start & ~7;
      for (Walk it(tid, kThreads, g.x_run); it.row < kCi; it.next()) {
        const int ch = i0 + it.row, p = p_lo + 8 * it.chunk;
        const bool ok = ch < c && p >= 0 && p < hw;
        copy16(xs + it.row * g.x_pitch + kFront + 8 * it.chunk,
               ok ? x + (b * c + ch) * hw + p : x, ok);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int idx = tid; idx < kBM * g.dy_rows * g.cwp; idx += kThreads) {
        const int j = idx % g.cwp, rr = idx / g.cwp;
        const int r = rr % g.dy_rows, o = rr / g.dy_rows;
        const int y = y0 + r, col = x0 + j, m = m0 + o;
        const bool ok = m < c && r < g.rows && y < h && col < w;
        dys[o * g.dy_pitch + r * g.cwp + j] =
            ok ? dy[(b * c + m) * hw + y * w + col] : zero;
      }
      for (int idx = tid; idx < kCi * (g.rows + 2) * g.row_pitch;
           idx += kThreads) {
        const int j = idx % g.row_pitch, rr = idx / g.row_pitch;
        const int r = rr % (g.rows + 2), i = rr / (g.rows + 2);
        const int y = y0 - 1 + r, col = x0 - g.lpad + j, ch = i0 + i;
        const bool ok = ch < c && y >= 0 && y < h && col >= 0 && col < w;
        xs[i * g.x_pitch + r * g.row_pitch + j] =
            ok ? x[(b * c + ch) * hw + y * w + col] : zero;
      }
    }
  };

  float acc[kMi][9][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][tap][q] = 0.f;

  const int g8 = lane >> 2, t4 = lane & 3;
  auto compute = [&](int s, int x_off) {
    const __nv_bfloat16* dys = smem + s * g.stage;
    // this lane's x plane: input channel 8 wn + g8 (its B column)
    const __nv_bfloat16* plane =
        dys + kBM * g.dy_pitch + (wn * 8 + g8) * g.x_pitch + x_off;
    const unsigned a_base =
        smem_addr(dys + (wm * 16 * kMi + (lane & 15)) * g.dy_pitch +
                  (lane >> 4) * 8);
#pragma unroll 1
    for (int ks = 0; ks < g.kpad / 16; ++ks) {
      uint32_t a[kMi][4];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
        ldmatrix_x4(a[mi], a_base + 2 * (mi * 16 * g.dy_pitch + ks * 16));
      // B fragments: pixels 2 t4, 2 t4 + 1 (p = 0) and 2 t4 + 8, 2 t4 + 9
      // (p = 1) of this k step, at the nine taps (r, c) = (dr, dc) + 1
      uint32_t bf[9][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int entry = pairs[ks * 8 + t4 + 4 * p];
        int pos = entry;
        uint32_t keep_l = ~0u, keep_r = ~0u;
        if constexpr (kRun) {
          pos = entry >> 2;
          keep_l = entry & 1 ? 0xffff0000u : ~0u;   // w - 1 off the image
          keep_r = entry & 2 ? 0x0000ffffu : ~0u;   // w + 2 off the image
        }
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
          const uint32_t* row = reinterpret_cast<const uint32_t*>(
              plane + pos + (dr - 1) * g.row_pitch);
          const uint32_t lo = row[-1], mid = row[0], hi = row[1];
          bf[3 * dr + 0][p] = __byte_perm(lo, mid, 0x5432) & keep_l;
          bf[3 * dr + 1][p] = mid;                                // w, w+1
          bf[3 * dr + 2][p] = __byte_perm(mid, hi, 0x5432) & keep_r;
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          mma_bf16(acc[mi][tap], a[mi], bf[tap][0], bf[tap][1]);
    }
  };

  const int t_begin = blockIdx.z * per;
  const int n_tiles = min(k_tiles - t_begin, per);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(t_begin + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();   // tile i has landed
    __syncthreads();                // ... for all; tile i - 1 is consumed
    const int next = i + kStages - 1;
    if (next < n_tiles) load(t_begin + next, next % kStages);
    cp_async_commit();
    compute(i % kStages, kRun ? run_offset(t_begin + i) : 0);
  }
  cp_async_wait<0>();

  // Write the partial: per (mi, half) each warp stages its 8 rows of 72
  // (input channel, tap) values in shared memory (the ring is drained),
  // then writes each row as one contiguous run of dW's OIHW layout.
  __syncthreads();
  float* wbuf = reinterpret_cast<float*>(smem_raw) + warp * 8 * kOutPitch;
  float* tile = out + static_cast<size_t>(blockIdx.z) * c * 9 * c;
  const int i_first = i0 + wn * 8;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          wbuf[g8 * kOutPitch + (2 * t4 + q) * 9 + tap] =
              acc[mi][tap][2 * half + q];
      __syncwarp();
      const int n_valid = 9 * max(0, min(8, c - i_first));
      for (int r = 0; r < 8; ++r) {
        const int o = m0 + wm * 16 * kMi + mi * 16 + 8 * half + r;
        if (o >= c) break;
        float* dst = tile + (static_cast<size_t>(o) * c + i_first) * 9;
        for (int j = lane; j < n_valid; j += 32)
          dst[j] = wbuf[r * kOutPitch + j];
      }
      __syncwarp();
    }
}

template <int kMi, int kWarpsM, bool kRun>
cudaError_t launch_bf16_tile(const void* x, const void* dy, float* partial,
                             int c, int h, int w, const Geometry& g,
                             int k_tiles, int per, int slices,
                             cudaStream_t stream) {
  constexpr int kBM = 16 * kMi * kWarpsM;
  auto kernel = wgrad_bf16<kMi, kWarpsM, kRun>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kCi - 1) / kCi, (c + kBM - 1) / kBM, slices);
  kernel<<<grid, 32 * kWarpsM * kWarpsN, g.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), partial, c, h, w, g, k_tiles,
      per);
  return cudaGetLastError();
}

template <int kMi, int kWarpsM>
cudaError_t launch_bf16_layout(const void* x, const void* dy, float* partial,
                               int c, int h, int w, bool runs,
                               const Geometry& g, int k_tiles, int per,
                               int slices, cudaStream_t stream) {
  return runs ? launch_bf16_tile<kMi, kWarpsM, true>(
                    x, dy, partial, c, h, w, g, k_tiles, per, slices, stream)
              : launch_bf16_tile<kMi, kWarpsM, false>(
                    x, dy, partial, c, h, w, g, k_tiles, per, slices, stream);
}

cudaError_t reduce_slices(const void* ws, void* out, int c, int slices,
                          cudaStream_t stream) {
  const int size = c * 9 * c;
  wgrad_reduce<<<(size + kReduceThreads - 1) / kReduceThreads,
                 kReduceThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), size, slices);
  return cudaGetLastError();
}

// tiling: tile_m, runs, then the Geometry's ints.
int launch_bf16(const void* x, const void* dy, void* out, void* ws, int b,
                int c, int h, int w, int per, int slices, const int* tiling,
                cudaStream_t stream) {
  if (tiling == nullptr) return cudaErrorInvalidValue;
  const int tile_m = tiling[0];
  const bool runs = tiling[1] != 0;
  Geometry g;
  memcpy(&g, tiling + 2, sizeof g);
  if (g.rows <= 0 || g.cols <= 0 || per <= 0) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  if (runs && !(aligned && g.cols == w && w % 2 == 0 && (h * w) % 8 == 0 &&
                (g.rows * w) % 8 == 0))
    return cudaErrorInvalidValue;
  const int k_tiles = b * g.bands * g.col_tiles;
  if (static_cast<long long>(per) * slices < k_tiles)
    return cudaErrorInvalidValue;
  float* partial = slices == 1 ? static_cast<float*>(out)
                               : static_cast<float*>(ws);
  cudaError_t err;
  if (tile_m == 32)
    err = launch_bf16_layout<2, 1>(x, dy, partial, c, h, w, runs, g, k_tiles,
                                   per, slices, stream);
  else if (tile_m == 64)
    err = launch_bf16_layout<2, 2>(x, dy, partial, c, h, w, runs, g, k_tiles,
                                   per, slices, stream);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  return static_cast<int>(reduce_slices(ws, out, c, slices, stream));
}

// -- float32 on the CUDA cores --------------------------------------------

int launch_f32(const void* x, const void* dy, void* out, void* ws, int b,
               int c, int h, int w, int k_chunk, int slices,
               cudaStream_t stream) {
  const int k_total = b * h * w;
  const int n_total = 9 * c;
  const dim3 grid((n_total + kBN - 1) / kBN, (c + kBM - 1) / kBM, slices);
  float* partial = slices == 1 ? static_cast<float*>(out)
                               : static_cast<float*>(ws);
  wgrad_partial<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), partial,
      c, h, w, k_total, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  return static_cast<int>(reduce_slices(ws, out, c, slices, stream));
}

}  // namespace

extern "C" {

// x, dy: (b, c, h, w) contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); out: (c, c, 3, 3) float32; ws: (slices, c, 9c) float32
// scratch (unused when slices == 1).  float32: each of the `slices` blocks
// along z takes k_chunk of the b*h*w pixels (a multiple of 32); tiling is
// unused.  bfloat16: k_chunk consecutive K tiles per slice, and tiling
// holds tile_m (32 or 64 output channels per block), runs (1: whole-row
// runs as 16-byte copies, which needs cols == w, w even, h*w and rows*w
// multiples of 8, x and dy 16-byte aligned; 0: element by element) and
// the Geometry's kGeometryInts ints (ops/conv_wgrad.py::bf16_plan).
// Launches on `stream` and returns the CUDA error (0 = launched).
int fhpe_conv3x3_wgrad(const void* x, const void* dy, void* out, void* ws,
                       int b, int c, int h, int w, int is_bf16, int k_chunk,
                       int slices, const int* tiling, void* stream) {
  if (b <= 0 || c <= 0 || h <= 0 || w <= 0 || slices <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(x, dy, out, ws, b, c, h, w, k_chunk, slices,
                               tiling, s)
                 : launch_f32(x, dy, out, ws, b, c, h, w, k_chunk, slices, s);
}

}  // extern "C"
