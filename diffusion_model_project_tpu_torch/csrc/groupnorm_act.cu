// GroupNorm + activation (K1) for Hopper, channels-first (N, C, *spatial).
//
// Replaces the TPU kernel
//   diffusion_model_project_tpu/ops/pallas/groupnorm_silu.py::fused_groupnorm_act
// (one program per sample with the whole (spatial, C) slab in VMEM).
//
// Bound on the H100: memory. The work is a few flops per element, so the
// floor is reading x once and writing y once at 3.35 TB/s. A group is one
// contiguous span of (C/G)*prod(spatial) elements, and a VAE group at
// 11x256^2x128 with G=32 holds 2.88 M elements: far past one block's shared
// memory, so one block per sample, as on the TPU, cannot work here.
//
// Design: two launches.
//   1. gn_partial: many blocks per group, each reduces one chunk of the
//      group to (count, mean, M2) in float32. Each thread folds 16-byte
//      vectors (mean and M2 of the vector exactly, then Chan's merge), then
//      warps and the block merge with Chan's formula. This is as robust as
//      the two-pass mean-then-E[(x-mean)^2] form but reads x once.
//   2. gn_apply: the same grid. One warp of each block merges the group's
//      chunk partials (a few hundred at most), then the block normalizes its
//      chunk, applies the per-channel affine (channel = offset / spatial)
//      and the activation, and writes in the input dtype, 16 bytes a thread.
// x is read twice in all (once for statistics, once to normalize); the
// second read of a small group mostly hits the 50 MB L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Stats {
  float n, mean, m2;
};

__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  float n = a.n + b.n;
  if (n == 0.f) return a;
  float d = b.mean - a.mean;
  float fb = b.n / n;
  Stats r;
  r.n = n;
  r.mean = a.mean + d * fb;
  r.m2 = a.m2 + b.m2 + d * d * a.n * fb;
  return r;
}

__device__ __forceinline__ Stats warp_merge(Stats s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o;
    o.n = __shfl_xor_sync(0xffffffffu, s.n, off);
    o.mean = __shfl_xor_sync(0xffffffffu, s.mean, off);
    o.m2 = __shfl_xor_sync(0xffffffffu, s.m2, off);
    s = merge(s, o);
  }
  return s;
}

__device__ __forceinline__ Stats block_merge(Stats s) {
  __shared__ Stats warp_stats[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_merge(s);
  if (lane == 0) warp_stats[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_stats[lane] : Stats{0.f, 0.f, 0.f};
    s = warp_merge(s);
  }
  return s;  // valid in thread 0
}

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) return y / (1.f + __expf(-y));  // silu
  if (act == 2) return fmaxf(y, 0.f);           // relu
  return y;
}

// grid (nchunks, num_groups_total); partials[g][chunk] = (count, mean, M2)
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_partial(const T* __restrict__ x, float* __restrict__ partials, long long L,
           int chunk, int nchunks, int vec_ok) {
  constexpr int V = Vec<T>::N;
  const long long g = blockIdx.y;
  const T* base = x + g * L;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(L, lo + chunk);
  Stats s = {0.f, 0.f, 0.f};
  if (vec_ok) {
    for (long long i = lo + (long long)threadIdx.x * V; i < hi; i += (long long)kThreads * V) {
      float v[V];
      load_vec(base + i, v);
      float m = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) m += v[k];
      m *= 1.f / V;
      float q = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) q += (v[k] - m) * (v[k] - m);
      s = merge(s, Stats{(float)V, m, q});
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      s = merge(s, Stats{1.f, to_f32(base[i]), 0.f});
  }
  s = block_merge(s);
  if (threadIdx.x == 0) {
    float* p = partials + (g * nchunks + blockIdx.x) * 3;
    p[0] = s.n;
    p[1] = s.mean;
    p[2] = s.m2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply(const T* __restrict__ x, const float* __restrict__ gamma,
         const float* __restrict__ beta, const float* __restrict__ partials,
         T* __restrict__ y, long long L, long long S, int G, int cpg, int chunk,
         int nchunks, float eps, int act, int vec_ok) {
  constexpr int V = Vec<T>::N;
  __shared__ float s_mean, s_rstd;
  const long long g = blockIdx.y;
  if (threadIdx.x < 32) {
    Stats s = {0.f, 0.f, 0.f};
    for (int j = threadIdx.x; j < nchunks; j += 32) {
      const float* p = partials + (g * nchunks + j) * 3;
      s = merge(s, Stats{p[0], p[1], p[2]});
    }
    s = warp_merge(s);
    if (threadIdx.x == 0) {
      s_mean = s.mean;
      s_rstd = rsqrtf(fmaxf(s.m2 / s.n, 0.f) + eps);
    }
  }
  __syncthreads();
  const float mean = s_mean, rstd = s_rstd;
  const int ch0 = (int)(g % G) * cpg;
  const T* xb = x + g * L;
  T* yb = y + g * L;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(L, lo + chunk);
  if (vec_ok) {
    for (long long i = lo + (long long)threadIdx.x * V; i < hi; i += (long long)kThreads * V) {
      float v[V];
      load_vec(xb + i, v);
      long long q = i / S, r = i - q * S;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int ch = ch0 + (int)q;
        v[k] = activate((v[k] - mean) * rstd * gamma[ch] + beta[ch], act);
        if (++r == S) { r = 0; ++q; }
      }
      store_vec(yb + i, v);
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const int ch = ch0 + (int)(i / S);
      from_f32(activate((to_f32(xb[i]) - mean) * rstd * gamma[ch] + beta[ch], act), yb + i);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   void* partials, long long groups_total, long long L, long long S,
                   int G, int cpg, int chunk, float eps, int act, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int nchunks = (int)((L + chunk - 1) / chunk);
  const int vec_ok = (L % V == 0) && (chunk % V == 0) &&
                     ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  dim3 grid(nchunks, (unsigned)groups_total);
  gn_partial<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partials), L, chunk, nchunks, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(partials),
      static_cast<T*>(y), L, S, G, cpg, chunk, nchunks, eps, act, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 = none, 1 = silu, 2 = relu.
// x, y: (N, C, S) contiguous; gamma, beta: float32 (C,);
// partials: float32 scratch of groups_total * ceil(L / chunk) * 3.
extern "C" int dm_groupnorm_act(int dtype, const void* x, const void* gamma,
                                const void* beta, void* y, void* partials,
                                long long groups_total, long long L, long long S,
                                int G, int cpg, int chunk, float eps, int act,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, gamma, beta, y, partials, groups_total, L, S, G, cpg,
                              chunk, eps, act, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, gamma, beta, y, partials, groups_total, L, S,
                                      G, cpg, chunk, eps, act, s);
  return (int)cudaErrorInvalidValue;
}
