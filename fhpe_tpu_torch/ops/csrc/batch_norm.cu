// Train-mode BatchNorm, and the ReLU that follows it, for Hopper (sm_90a),
// NCHW.
//
// Replaces no TPU kernel: fhpe_tpu leaves BatchNorm to XLA, which fuses its
// reductions into the neighbouring ops.  On the card ATen's native NCHW
// kernels ran it, one CTA per channel for the statistics and for the whole
// backward; the students' 32 to 256 channels put 32 to 256 CTAs on 132 SMs,
// each walking N*H*W values alone, twice, which made BatchNorm the largest
// device op of the CNN train steps.
//
// What bounds it: device memory.  Each value takes a handful of float32
// operations; the forward must read x and write y, the backward read x and
// dy and write dx.
//
// Design: one launch per direction.  A channel's N*H*W values are split
// over a thread block cluster of `cluster` CTAs (up to 16, one cluster per
// channel), so every student shape puts at least two CTAs per SM on the
// card.  Each thread loads its first kHeld units into registers and keeps
// them there across the reduction; the cluster reduces through distributed
// shared memory (each CTA's partial read by every CTA of the cluster in
// rank order), and the thread then writes its outputs from the registers.
// Where a channel has more units than the cluster holds, a thread's further
// units are read a second time after the reduction (from L2 when it holds
// them).  Every student channel of up to 131,072 bf16 values (64 x 64 at
// batch 32) is read once.
//
// Arithmetic (float32 throughout; x, y, dy, dx bf16 or float32; gamma, beta,
// statistics float32):
//   forward: each thread sums d = x - shift and d*d over its units (shift =
//     the channel's first value, so the sums do not cancel), turns them
//     into (count, mean, M2), and the CTA merges its threads' (Chan et al.)
//     in a fixed tree, then the cluster its CTAs' in rank order, every CTA
//     alike (so all get the same bits; no atomics).  CTA 0 of the cluster
//     writes mean, invstd = 1 / sqrt(var + eps) (biased var) and moves the
//     running mean and variance as nn.BatchNorm2d does (momentum,
//     Bessel-corrected variance); then y = (x - mean) * (gamma * invstd) +
//     beta, as one rounding of an FMA, 0 where it is <= 0 under `relu` (NaN
//     stays NaN), written in x's dtype.  With given mean and invstd the
//     kernel is that last pass alone.
//   backward: g = dy, zeroed where the forward's value was <= 0 under
//     `relu` (recomputed from x with the forward's own arithmetic,
//     bn_affine); the sums of g and g * (x - mean) in the same fixed trees;
//     CTA 0 writes dbeta = sum g and dgamma = invstd * sum g (x - mean), and
//     dx = gamma invstd (g - sum g / M - (x - mean) invstd^2 sum g(x - mean)
//     / M).
//   Two runs give the same bits.
//
// Layout of a call: a channel's M = N*H*W values are `units` units of `vec`
// values (16 bytes where H*W is a multiple of 16 bytes and the pointers are
// 16-byte aligned, else one value); grid (cluster, C), clusters of
// (cluster, 1, 1); `threads` threads a CTA (a multiple of 32, at most 256).
// Thread t of CTA r owns units g, g + G, g + 2G, ... with g = r * threads +
// t and G = cluster * threads.  A unit never straddles two samples.  The
// plan comes from the host (ops/batch_norm.py::plan); the kernels take it
// as given.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxCluster = 16;
constexpr int kHeld = 4;    // units a thread keeps in registers
constexpr int kUnroll = 4;  // further units a thread has in flight
constexpr unsigned kFull = 0xffffffffu;

// ---- loads and stores of one unit as float32 ------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void unpack2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One unit as it is loaded (16 bytes, or one value), kept so in registers
// and unpacked to float32 where it is used.
template <typename T, int VEC>
struct Raw {
  T v;
};
template <>
struct Raw<float, 4> {
  float4 v;
};
template <>
struct Raw<__nv_bfloat16, 8> {
  uint4 v;
};

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* __restrict__ p) {
  if constexpr (VEC == 1) return {p[0]};
  else if constexpr (sizeof(T) == 4)
    return {*reinterpret_cast<const float4*>(p)};
  else return {*reinterpret_cast<const uint4*>(p)};
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r, float* v) {
  if constexpr (VEC == 1) {
    v[0] = to_float(r.v);
  } else if constexpr (sizeof(T) == 4) {
    v[0] = r.v.x; v[1] = r.v.y; v[2] = r.v.z; v[3] = r.v.w;
  } else {
    unpack2(r.v.x, v); unpack2(r.v.y, v + 2); unpack2(r.v.z, v + 4);
    unpack2(r.v.w, v + 6);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_unit(T* __restrict__ p, const float* v) {
  if constexpr (VEC == 1) {
    from_float(p, v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
        pack2(v[6], v[7]));
  }
}

// ---- a thread's units -------------------------------------------------------

// The element offsets of a thread's units of channel c, one after another:
// unit u is element u * vec of the channel's (sample, h*w) order, and each
// step moves `stride` units on without a division.
struct Walk {
  int n, hw, dn, dh, hw_size, C, c;

  __device__ Walk(int u, int stride, int vec, int hw_size_, int C_, int c_)
      : hw_size(hw_size_), C(C_), c(c_) {
    n = (u * vec) / hw_size;
    hw = u * vec - n * hw_size;
    dn = (stride * vec) / hw_size;
    dh = stride * vec - dn * hw_size;
  }
  __device__ int offset() const { return (n * C + c) * hw_size + hw; }
  __device__ void next() {
    hw += dh;
    n += dn;
    if (hw >= hw_size) {
      hw -= hw_size;
      ++n;
    }
  }
};

// Calls body(off) with the offsets of kUnroll of the thread's units j in
// [j0, nj) at a time (-1 past the end), the walk standing at unit j0.
template <typename Body>
__device__ __forceinline__ void stream(Walk w, int j0, int nj, Body&& body) {
  for (int j = j0; j < nj; j += kUnroll) {
    int off[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      off[r] = j + r < nj ? w.offset() : -1;
      w.next();
    }
    body(off);
  }
}

// ---- fixed-order reductions ---------------------------------------------------

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s merge of two (count, mean, M2); either may be empty.
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float f = b.n / n;
  const float d = b.mean - a.mean;
  return {n, fmaf(d, f, a.mean), a.m2 + b.m2 + d * d * a.n * f};
}

__device__ __forceinline__ Moments warp_reduce(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o{__shfl_down_sync(kFull, m.n, off),
                    __shfl_down_sync(kFull, m.mean, off),
                    __shfl_down_sync(kFull, m.m2, off)};
    m = merge(m, o);
  }
  return m;
}

__device__ __forceinline__ float2 warp_reduce(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(kFull, v.x, off);
    v.y += __shfl_down_sync(kFull, v.y, off);
  }
  return v;
}

__device__ __forceinline__ void set_empty(Moments& m) { m = {0.f, 0.f, 0.f}; }
__device__ __forceinline__ void set_empty(float2& v) {
  v = make_float2(0.f, 0.f);
}

// The cluster's reduction of its threads' partials, the same bits in every
// CTA: each CTA's threads in a fixed tree into `mine` (its shared memory),
// then warp 0 of every CTA reads the cluster's CTAs' in rank order and
// reduces them in a fixed tree into `all`.  The caller syncs the cluster
// once more before it exits (its `mine` is read by the other CTAs).
template <typename P>
__device__ void cluster_reduce(P p, P* mine, P* all, P* warps,
                               cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  p = warp_reduce(p);
  if (lane == 0) warps[warp] = p;
  __syncthreads();
  if (warp == 0) {
    if (lane < static_cast<int>(blockDim.x >> 5)) p = warps[lane];
    else set_empty(p);
    p = warp_reduce(p);
    if (lane == 0) *mine = p;
  }
  cluster.sync();
  if (warp == 0) {
    if (lane < static_cast<int>(cluster.num_blocks()))
      p = *cluster.map_shared_rank(mine, lane);
    else set_empty(p);
    p = warp_reduce(p);
    if (lane == 0) *all = p;
  }
  __syncthreads();
}

// The forward's value before the ReLU, shared by the forward and the
// backward's mask so that both round alike.
__device__ __forceinline__ float bn_affine(float x, float mean, float scale,
                                           float beta) {
  return __fmaf_rn(__fsub_rn(x, mean), scale, beta);
}

struct Channel {
  float mean, invstd, scale, beta;
};

// gamma and beta of channel c (null: 1 and 0), read before they are needed.
__device__ __forceinline__ float2 affine_params(const float* gamma,
                                                const float* beta, int c) {
  return make_float2(gamma ? gamma[c] : 1.f, beta ? beta[c] : 0.f);
}

__device__ __forceinline__ Channel channel(float mean, float invstd,
                                           float2 params) {
  return {mean, invstd, __fmul_rn(params.x, invstd), params.y};
}

template <int VEC>
__device__ __forceinline__ void apply_unit(float* v, const Channel& ch,
                                           int relu) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float o = bn_affine(v[i], ch.mean, ch.scale, ch.beta);
    v[i] = relu && o <= 0.f ? 0.f : o;
  }
}

// dy's mask under `relu`.
__device__ __forceinline__ float masked(float g, float x, const Channel& ch,
                                        int relu) {
  return relu && bn_affine(x, ch.mean, ch.scale, ch.beta) <= 0.f ? 0.f : g;
}

// dy of one unit into dx, in place.
template <int VEC>
__device__ __forceinline__ void grad_unit(float* g, const float* x,
                                          const Channel& ch, float k1,
                                          float k2, int relu) {
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    g[i] = ch.scale * (masked(g[i], x[i], ch, relu) - k1 -
                       (x[i] - ch.mean) * k2);
}

// ---- forward -------------------------------------------------------------------

// With `given`, mean and invstd are read, not computed, and nothing else is
// written but y.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
bn_train_forward(const T* __restrict__ x, T* __restrict__ y,
                 float* __restrict__ mean, float* __restrict__ invstd,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ run_mean,
                 float* __restrict__ run_var, int C, int hw_size, int units,
                 float momentum, float eps, int relu, int given) {
  __shared__ Moments warps[kMaxThreads / 32], mine, all;
  __shared__ float stats[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.y, rank = blockIdx.x;
  const int G = gridDim.x * blockDim.x;
  const int g = rank * blockDim.x + threadIdx.x;
  const int nj = g < units ? (units - 1 - g) / G + 1 : 0;
  const int held = given ? 0 : min(nj, kHeld);
  const bool writes = !given && rank == 0 && threadIdx.x == 0;
  const float2 params = affine_params(gamma, beta, c);
  float2 running = make_float2(0.f, 0.f);
  if (writes && run_mean) running = make_float2(run_mean[c], run_var[c]);
  Walk w(g, G, VEC, hw_size, C, c);
  int hoff[kHeld];
  Raw<T, VEC> hx[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    if (j < held) {
      hoff[j] = w.offset();
      hx[j] = load_raw<T, VEC>(x + hoff[j]);
      w.next();
    }
  }
  if (!given) {
    const float shift = to_float(x[c * hw_size]);
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
    auto add = [&](const Raw<T, VEC>& r) {
      float v[VEC];
      unpack(r, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[i] - shift;
        s1[i] += d;
        s2[i] = fmaf(d, d, s2[i]);
      }
    };
#pragma unroll
    for (int j = 0; j < kHeld; ++j)
      if (j < held) add(hx[j]);
    stream(w, held, nj, [&](const int (&off)[kUnroll]) {
      Raw<T, VEC> r[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (off[k] >= 0) r[k] = load_raw<T, VEC>(x + off[k]);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (off[k] >= 0) add(r[k]);
    });
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      t1 += s1[i];
      t2 += s2[i];
    }
    Moments m{0.f, 0.f, 0.f};
    if (nj > 0) {
      const float n = static_cast<float>(nj * VEC);
      const float d = t1 / n;
      m = {n, shift + d, fmaxf(t2 - t1 * d, 0.f)};
    }
    cluster_reduce(m, &mine, &all, warps, cluster);
    if (threadIdx.x == 0) {
      const float var = all.m2 / all.n;
      const float inv = 1.f / sqrtf(var + eps);
      stats[0] = all.mean;
      stats[1] = inv;
      if (writes) {
        mean[c] = all.mean;
        invstd[c] = inv;
        if (run_mean) {
          const float unbiased = all.n > 1.f ? all.m2 / (all.n - 1.f) : var;
          run_mean[c] = (1.f - momentum) * running.x + momentum * all.mean;
          run_var[c] = (1.f - momentum) * running.y + momentum * unbiased;
        }
      }
    }
  } else if (threadIdx.x == 0) {
    stats[0] = mean[c];
    stats[1] = invstd[c];
  }
  __syncthreads();
  const Channel ch = channel(stats[0], stats[1], params);
  auto out = [&](const Raw<T, VEC>& r, int off) {
    float v[VEC];
    unpack(r, v);
    apply_unit<VEC>(v, ch, relu);
    store_unit<T, VEC>(y + off, v);
  };
#pragma unroll
  for (int j = 0; j < kHeld; ++j)
    if (j < held) out(hx[j], hoff[j]);
  stream(w, held, nj, [&](const int (&off)[kUnroll]) {
    Raw<T, VEC> r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (off[k] >= 0) r[k] = load_raw<T, VEC>(x + off[k]);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (off[k] >= 0) out(r[k], off[k]);
  });
  if (!given) cluster.sync();
}

// ---- backward ------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
bn_train_backward(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ mean,
                  const float* __restrict__ invstd,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ dx,
                  float* __restrict__ dgamma, float* __restrict__ dbeta, int C,
                  int hw_size, int units, float count, int relu) {
  __shared__ float2 warps[kMaxThreads / 32], mine, all;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.y, rank = blockIdx.x;
  const int G = gridDim.x * blockDim.x;
  const int g = rank * blockDim.x + threadIdx.x;
  const int nj = g < units ? (units - 1 - g) / G + 1 : 0;
  const int held = min(nj, kHeld);
  const Channel ch = channel(mean[c], invstd[c],
                             affine_params(gamma, beta, c));
  Walk w(g, G, VEC, hw_size, C, c);
  int hoff[kHeld];
  Raw<T, VEC> hx[kHeld], hg[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    if (j < held) {
      hoff[j] = w.offset();
      hx[j] = load_raw<T, VEC>(x + hoff[j]);
      hg[j] = load_raw<T, VEC>(dy + hoff[j]);
      w.next();
    }
  }
  float sg[VEC], sgx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sg[i] = sgx[i] = 0.f;
  auto add = [&](const Raw<T, VEC>& rx, const Raw<T, VEC>& rg) {
    float xv[VEC], gv[VEC];
    unpack(rx, xv);
    unpack(rg, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float gi = masked(gv[i], xv[i], ch, relu);
      sg[i] += gi;
      sgx[i] = fmaf(gi, xv[i] - ch.mean, sgx[i]);
    }
  };
#pragma unroll
  for (int j = 0; j < kHeld; ++j)
    if (j < held) add(hx[j], hg[j]);
  stream(w, held, nj, [&](const int (&off)[kUnroll]) {
    Raw<T, VEC> rx[kUnroll], rg[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (off[k] < 0) continue;
      rx[k] = load_raw<T, VEC>(x + off[k]);
      rg[k] = load_raw<T, VEC>(dy + off[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (off[k] >= 0) add(rx[k], rg[k]);
  });
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    t.x += sg[i];
    t.y += sgx[i];
  }
  cluster_reduce(t, &mine, &all, warps, cluster);
  if (threadIdx.x == 0 && rank == 0) {
    if (dbeta) dbeta[c] = all.x;
    if (dgamma) dgamma[c] = all.y * ch.invstd;
  }
  const float k1 = all.x / count;
  const float k2 = all.y * ch.invstd * ch.invstd / count;
  auto out = [&](const Raw<T, VEC>& rx, const Raw<T, VEC>& rg, int off) {
    float xv[VEC], gv[VEC];
    unpack(rx, xv);
    unpack(rg, gv);
    grad_unit<VEC>(gv, xv, ch, k1, k2, relu);
    store_unit<T, VEC>(dx + off, gv);
  };
#pragma unroll
  for (int j = 0; j < kHeld; ++j)
    if (j < held) out(hx[j], hg[j], hoff[j]);
  stream(w, held, nj, [&](const int (&off)[kUnroll]) {
    Raw<T, VEC> rx[kUnroll], rg[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (off[k] < 0) continue;
      rx[k] = load_raw<T, VEC>(x + off[k]);
      rg[k] = load_raw<T, VEC>(dy + off[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (off[k] >= 0) out(rx[k], rg[k], off[k]);
  });
  cluster.sync();
}

// ---- host side ---------------------------------------------------------------------

struct Launch {
  dim3 grid, block;
  int units, vec;
  cudaStream_t stream;
};

// plan: {vec, cluster, threads}, from ops/batch_norm.py::plan.
bool make_launch(int n, int c, int hw, int is_bf16, const int* plan,
                 void* stream, Launch* l) {
  const int wide = is_bf16 ? 8 : 4;
  const int vec = plan[0], cluster = plan[1], threads = plan[2];
  if (n <= 0 || c <= 0 || hw <= 0 || c > 65535) return false;
  if (vec != 1 && (vec != wide || hw % vec)) return false;
  if (cluster < 1 || cluster > kMaxCluster) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return false;
  l->grid = dim3(cluster, c);
  l->block = dim3(threads);
  l->units = static_cast<int>(static_cast<long long>(n) * hw / vec);
  l->vec = vec;
  l->stream = static_cast<cudaStream_t>(stream);
  return true;
}

// Launches kernel on grid (cluster, C) in clusters of (cluster, 1, 1).
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), const Launch& l,
                   Args&&... args) {
  if (l.grid.x > 8) {   // past the portable cluster size
    const cudaError_t allowed = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (allowed != cudaSuccess) return allowed;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = l.grid.x;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = l.grid;
  cfg.blockDim = l.block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = l.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

struct ForwardArgs {
  Launch l;
  const void *x, *gamma, *beta;
  void *y, *mean, *invstd, *run_mean, *run_var;
  int c, hw, relu, given;
  float momentum, eps;

  template <typename T, int VEC>
  static cudaError_t run(const ForwardArgs& a) {
    return launch(bn_train_forward<T, VEC>, a.l, static_cast<const T*>(a.x),
                  static_cast<T*>(a.y), static_cast<float*>(a.mean),
                  static_cast<float*>(a.invstd),
                  static_cast<const float*>(a.gamma),
                  static_cast<const float*>(a.beta),
                  static_cast<float*>(a.run_mean),
                  static_cast<float*>(a.run_var), a.c, a.hw, a.l.units,
                  a.momentum, a.eps, a.relu, a.given);
  }
};

struct BackwardArgs {
  Launch l;
  const void *dy, *x, *mean, *invstd, *gamma, *beta;
  void *dx, *dgamma, *dbeta;
  int c, hw, relu;
  float count;

  template <typename T, int VEC>
  static cudaError_t run(const BackwardArgs& a) {
    return launch(bn_train_backward<T, VEC>, a.l, static_cast<const T*>(a.dy),
                  static_cast<const T*>(a.x),
                  static_cast<const float*>(a.mean),
                  static_cast<const float*>(a.invstd),
                  static_cast<const float*>(a.gamma),
                  static_cast<const float*>(a.beta), static_cast<T*>(a.dx),
                  static_cast<float*>(a.dgamma), static_cast<float*>(a.dbeta),
                  a.c, a.hw, a.l.units, a.count, a.relu);
  }
};

// F::run<T, VEC>(f) for the call's dtype and unit width.
template <typename F>
cudaError_t dispatch(int is_bf16, const F& f) {
  if (is_bf16)
    return f.l.vec == 1 ? F::template run<__nv_bfloat16, 1>(f)
                        : F::template run<__nv_bfloat16, 8>(f);
  return f.l.vec == 1 ? F::template run<float, 1>(f)
                      : F::template run<float, 4>(f);
}

}  // namespace

extern "C" {

// Train-mode forward: y, mean and invstd ((C,) float32), the running
// statistics moved in place (null: not tracked).  x, y: (N, C, H*W) in
// the dtype is_bf16 names; gamma, beta (C,) float32 or null (1 and 0).
// Launches on `stream`; returns the launch's error (0 = launched).
int fhpe_batch_norm_train(const void* x, void* y, const void* gamma,
                          const void* beta, void* mean, void* invstd,
                          void* running_mean, void* running_var, int n, int c,
                          int hw, int is_bf16, const int* plan,
                          float momentum, float eps, int relu, void* stream) {
  ForwardArgs a;
  if (!make_launch(n, c, hw, is_bf16, plan, stream, &a.l))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x; a.gamma = gamma; a.beta = beta; a.y = y; a.mean = mean;
  a.invstd = invstd; a.run_mean = running_mean; a.run_var = running_var;
  a.c = c; a.hw = hw; a.relu = relu; a.given = 0;
  a.momentum = momentum; a.eps = eps;
  return static_cast<int>(dispatch(is_bf16, a));
}

// The forward's last pass alone, from given mean and invstd.
int fhpe_batch_norm_apply(const void* x, void* y, const void* mean,
                          const void* invstd, const void* gamma,
                          const void* beta, int n, int c, int hw,
                          int is_bf16, const int* plan, int relu,
                          void* stream) {
  ForwardArgs a;
  if (!make_launch(n, c, hw, is_bf16, plan, stream, &a.l))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x; a.gamma = gamma; a.beta = beta; a.y = y;
  a.mean = const_cast<void*>(mean); a.invstd = const_cast<void*>(invstd);
  a.run_mean = a.run_var = nullptr; a.c = c; a.hw = hw; a.relu = relu;
  a.given = 1; a.momentum = a.eps = 0.f;
  return static_cast<int>(dispatch(is_bf16, a));
}

// Train-mode backward: dx (x's dtype), dgamma and dbeta ((C,) float32; null:
// not written) from dy, x and the forward's mean and invstd.
int fhpe_batch_norm_backward(const void* dy, const void* x, const void* mean,
                             const void* invstd, const void* gamma,
                             const void* beta, void* dx, void* dgamma,
                             void* dbeta, int n, int c, int hw, int is_bf16,
                             const int* plan, int relu, void* stream) {
  BackwardArgs a;
  if (!make_launch(n, c, hw, is_bf16, plan, stream, &a.l))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dy = dy; a.x = x; a.mean = mean; a.invstd = invstd; a.gamma = gamma;
  a.beta = beta; a.dx = dx; a.dgamma = dgamma; a.dbeta = dbeta; a.c = c;
  a.hw = hw; a.relu = relu;
  a.count = static_cast<float>(n) * static_cast<float>(hw);
  return static_cast<int>(dispatch(is_bf16, a));
}

}  // extern "C"
