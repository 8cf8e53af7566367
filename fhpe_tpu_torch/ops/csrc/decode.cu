// Heatmap decode for Hopper (sm_90a): per-row argmax + quarter-pixel offset.
//
// Replaces the Pallas kernel fhpe_tpu/ops/decode_pallas.py::_decode_kernel
// (wrapper decode_pallas).  For each (sample, joint) row of H*W float32
// heatmap values it computes the peak value, the flat argmax (the FIRST
// maximum wins ties, numpy / jnp.argmax semantics), x = idx % W and
// y = idx / W, zeroes x and y when the peak is <= 0, and, with
// post_process, shifts x and y by +-0.25 toward the larger neighbour when
// 1 < px < W-1 and 1 < py < H-1 (sign(0) = 0).  The results are exact
// integers and quarter steps, so they are bit-equal to the plain version
// (fhpe_tpu_torch/ops/decode.py: get_max_preds_torch + quarter_offset_torch).
// NaN inputs are out of scope: a NaN row gives an unspecified index.
//
// What bounds it: device memory.  Every heatmap value is read once and
// used for one compare (an MPII batch of 32 is 512 rows of 4096 floats,
// 8.4 MB), so the kernel is a streaming reduction.
//
// Design: one warp per row, WARPS_PER_BLOCK rows per block.  NCHW rows are
// contiguous, so a lane reads 16-byte float4s, neighbouring lanes on
// neighbouring addresses, whenever the row start is 16-byte aligned (any
// H*W that is a multiple of 4 on a fresh allocation); a scalar loop takes
// the ragged tail and unaligned rows.  Each lane keeps its own (value,
// index) with a strict '>' while it walks its indices in increasing order,
// and a warp-shuffle reduction merges lanes taking the smaller index on
// equal values.  Lane 0 then does the four neighbour loads (from L1/L2:
// the row was just read) and the writes.  No shared memory, no tensor
// cores: nothing here is a matrix product.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void keep_first_max(float& v, int& i, float ov,
                                               int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
decode_kernel(const float* __restrict__ hm, float* __restrict__ coords,
              float* __restrict__ maxvals, int rows, int h, int w,
              int post_process) {
  const int row_id = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row_id >= rows) return;  // uniform across the warp
  const int hw = h * w;
  const float* row = hm + static_cast<size_t>(row_id) * hw;

  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15u) == 0;
  const int nvec = aligned ? (hw >> 2) : 0;  // float4s in the vector part
  const int scalar_from = nvec << 2;

  // Start each lane at the first index it owns, so a row of -inf still
  // resolves to index 0; a lane that owns no index can never win.
  float best = -CUDART_INF_F;
  int best_idx = lane < nvec ? (lane << 2)
                             : (scalar_from + lane < hw ? scalar_from + lane
                                                        : INT32_MAX);

  const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll 4
  for (int k = lane; k < nvec; k += 32) {
    const float4 v = __ldg(row4 + k);
    const int base = k << 2;
    if (v.x > best) { best = v.x; best_idx = base; }
    if (v.y > best) { best = v.y; best_idx = base + 1; }
    if (v.z > best) { best = v.z; best_idx = base + 2; }
    if (v.w > best) { best = v.w; best_idx = base + 3; }
  }
  for (int k = scalar_from + lane; k < hw; k += 32) {
    const float v = __ldg(row + k);
    if (v > best) { best = v; best_idx = k; }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFullMask, best, off);
    const int oi = __shfl_down_sync(kFullMask, best_idx, off);
    keep_first_max(best, best_idx, ov, oi);
  }

  if (lane != 0) return;
  float x = static_cast<float>(best_idx % w);
  float y = static_cast<float>(best_idx / w);
  if (!(best > 0.f)) {
    x = 0.f;
    y = 0.f;
  }
  if (post_process) {
    const int px = static_cast<int>(floorf(x + 0.5f));
    const int py = static_cast<int>(floorf(y + 0.5f));
    if (px > 1 && px < w - 1 && py > 1 && py < h - 1) {
      const float* p = row + py * w + px;
      x += sign_of(p[1] - p[-1]) * 0.25f;
      y += sign_of(p[w] - p[-w]) * 0.25f;
    }
  }
  coords[2 * row_id] = x;
  coords[2 * row_id + 1] = y;
  maxvals[row_id] = best;
}

}  // namespace

extern "C" {

// hm: (rows, h*w) float32, contiguous; coords: (rows, 2); maxvals: (rows,).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int fhpe_decode_heatmaps(const void* hm, void* coords, void* maxvals,
                         int rows, int h, int w, int post_process,
                         void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  decode_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hm), static_cast<float*>(coords),
      static_cast<float*>(maxvals), rows, h, w, post_process);
  return static_cast<int>(cudaGetLastError());
}

const char* fhpe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
